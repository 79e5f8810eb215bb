"""PyTorch port, BASIS_IMPL = series: the float64 torch special functions
(lpmv by the hypergeometric series, Laguerre polynomials) against the JAX
package's, and the series design matrix against the JAX package's series
basis and the port's own table basis."""

import numpy as np
import pytest
import torch

from volumetricinterp_tpu import special as jspecial
from volumetricinterp_tpu.config import Config as JConfig
from volumetricinterp_tpu.models.sphharmlag import Model as JModel

from volumetricinterp_tpu_torch import special
from volumetricinterp_tpu_torch.config import Config
from volumetricinterp_tpu_torch.models.sphharmlag import Model

SERIES = "\n[TPU]\nBASIS_IMPL = series\n"


def _points():
    rng = np.random.default_rng(2)  # tests/test_model_sphharmlag.py's draw
    return (rng.uniform(74, 82, 100), rng.uniform(252, 272, 100),
            rng.uniform(1e5, 6e5, 100))


@pytest.mark.parametrize("v", [3.7, 22.25, 94.0])
def test_lpmv_matches_jax(v):
    """Within 1e-12 of the sup of each (degree, order) column: the same
    200-term series and the same sign convention."""
    x = np.cos(np.linspace(1e-3, np.deg2rad(10.0), 60))
    for m in (0, 1, 3, -2, -5):
        got = special.lpmv(m, v, torch.as_tensor(x))
        assert got.dtype == torch.float64
        ref = np.asarray(jspecial.lpmv(m, v, x))
        assert np.max(np.abs(got.numpy() - ref)) <= 1e-12 * np.max(np.abs(ref))
        if abs(m) > v:
            continue  # lpmv_host's Gamma-ratio connection needs |m| <= v
        # and scipy's values inside the series' accuracy envelope
        host = special.lpmv_host(m, v, x)
        assert np.max(np.abs(got.numpy() - host)) <= 1e-6 * np.max(np.abs(host))


def test_laguerre_matches_jax():
    z = np.linspace(0.0, 12.0, 40)
    for alpha in (0.0, 1.0):
        got = special.laguerre_all(5, z, alpha).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jspecial.laguerre_all(5, z, alpha)), rtol=1e-12,
            atol=1e-12)
        np.testing.assert_array_equal(got, special.np_laguerre_all(5, z, alpha))
        for k in (-1, 0, 3):
            np.testing.assert_allclose(
                special.eval_laguerre(k, z, alpha).numpy(),
                np.asarray(jspecial.eval_laguerre(k, z, alpha)), rtol=1e-12,
                atol=1e-12)


def test_series_basis_matches_jax_series(small_config_text):
    """The port's series design matrix against the JAX package's series
    basis: within 1e-10 of each column's sup."""
    lat, lon, alt = _points()
    A = Model(Config.from_text(small_config_text + SERIES)).basis(lat, lon, alt)
    Aj = np.asarray(JModel(JConfig.from_text(small_config_text + SERIES))
                    .basis(lat, lon, alt))
    assert A.shape == Aj.shape == (100, 18)
    for n in range(18):
        sup = np.max(np.abs(Aj[:, n])) + 1e-300
        assert np.max(np.abs(A[:, n] - Aj[:, n])) <= 1e-10 * sup, n


def test_series_basis_matches_table(small_config_text):
    """Series against the port's table path, within the series' accuracy
    envelope at moderate nu (1e-5 of the sup, the JAX package's
    tests/test_model_sphharmlag.py bar); the gradient uses the tables in
    both settings."""
    lat, lon, alt = _points()
    ms = Model(Config.from_text(small_config_text + SERIES))
    mt = Model(Config.from_text(small_config_text))
    As, At = ms.basis(lat, lon, alt), mt.basis(lat, lon, alt)
    for n in range(mt.nbasis):
        sup = np.max(np.abs(At[:, n])) + 1e-300
        assert np.max(np.abs(At[:, n] - As[:, n])) < 1e-5 * sup, n
    np.testing.assert_array_equal(ms.grad_basis(lat, lon, alt),
                                  mt.grad_basis(lat, lon, alt))
    with pytest.raises(ValueError, match="BASIS_IMPL"):
        Model(Config.from_text(small_config_text
                               + "\n[TPU]\nBASIS_IMPL = cheb\n"))
