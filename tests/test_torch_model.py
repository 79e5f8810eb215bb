"""PyTorch port, model layer: Legendre tables, regularization matrices and
the host design matrix against the JAX package and the NumPy oracle."""

import numpy as np
import pytest

from volumetricinterp_tpu.config import Config as JConfig
from volumetricinterp_tpu.models.sphharmlag import Model as JModel
from volumetricinterp_tpu_torch.config import Config as TConfig
from volumetricinterp_tpu_torch.models.sphharmlag import Model as TModel
from tests.oracle import oracle_basis


def _pair(text, quad_mode):
    text = text + f"\n[TPU]\nQUAD_MODE = {quad_mode}\n"
    return JModel(JConfig.from_text(text)), TModel(TConfig.from_text(text))


@pytest.fixture(scope="module", params=["quad", "gauss"])
def models(request, small_config_text):
    return _pair(small_config_text, request.param)


@pytest.mark.parametrize("which", ["eval_psi", "eval_omega"])
def test_reg_matrices_bitwise(models, which):
    jm, tm = models
    a = np.asarray(getattr(jm, which)())
    b = getattr(tm, which)()
    assert b.dtype == np.float64 and b.shape == (tm.nbasis, tm.nbasis)
    np.testing.assert_array_equal(b, a)


def test_legendre_tables_equal(models):
    jm, tm = models
    assert tm.tables.degree == jm.tables.degree
    assert tm.tables.theta_max == jm.tables.theta_max
    np.testing.assert_array_equal(tm.tables.coef_np, jm.tables.coef_np)


@pytest.mark.parametrize("order", [(2, 3), (4, 6)])
def test_basis_matches_jax_and_oracle(small_config_text, order):
    maxk, maxl = order
    text = small_config_text.replace("MAXK = 2", f"MAXK = {maxk}").replace(
        "MAXL = 3", f"MAXL = {maxl}")
    jm, tm = _pair(text, "gauss")
    rng = np.random.default_rng(17)
    lat = rng.uniform(74, 82, (6, 50))
    lon = rng.uniform(252, 272, (6, 50))
    alt = rng.uniform(1e5, 6e5, (6, 50))
    A = tm.basis(lat, lon, alt)
    assert A.shape == (6, 50, tm.nbasis)
    Aj = np.asarray(jm.basis(lat, lon, alt))
    scale = np.max(np.abs(Aj))
    assert np.max(np.abs(A - Aj)) <= 1e-14 * scale
    if maxl > 3:
        return  # the oracle's direct negative-m lpmv underflows at high nu
    Ao = oracle_basis(maxk, maxl, 10.0, 78.0, 262.0, lat.ravel(), lon.ravel(),
                      alt.ravel())
    A = A.reshape(-1, tm.nbasis)
    for n in range(tm.nbasis):  # the bar of tests/test_model_sphharmlag.py
        sup = np.max(np.abs(Ao[:, n])) + 1e-300
        assert np.max(np.abs(A[:, n] - Ao[:, n])) < 1e-8 * sup, n


def test_unported_model_options_raise(small_config_text):
    """The model options the first slices left out now build: radbasfun
    through the registry (the JAX package's defaults, 7^3 centres, no
    regularization) and BASIS_IMPL = series (its basis within 1e-5 of the
    table basis' sup, tests/test_torch_series.py); an unknown name
    raises."""
    from volumetricinterp_tpu_torch.models import make_model
    from volumetricinterp_tpu_torch.models.radbasfun import Model as RBF

    rbf = make_model("radbasfun", TConfig.from_text(small_config_text))
    assert isinstance(rbf, RBF) and rbf.nbasis == 343
    assert rbf.eval_reg_matricies == {}
    series = TModel(TConfig.from_text(small_config_text
                                      + "\n[TPU]\nBASIS_IMPL = series\n"))
    table = TModel(TConfig.from_text(small_config_text))
    pts = (np.array([76.0, 77.5]), np.array([262.0, 266.0]),
           np.array([2e5, 4e5]))
    As, At = series.basis(*pts), table.basis(*pts)
    assert np.max(np.abs(As - At)) <= 1e-5 * np.max(np.abs(At))
    with pytest.raises(ValueError):
        make_model("nosuchmodel", TConfig.from_text(small_config_text))


def test_host_special_functions_match_jax():
    from volumetricinterp_tpu import special as js
    from volumetricinterp_tpu_torch import special as ts

    v = np.linspace(5.0, 120.0, 7)
    x = np.cos(np.linspace(0.01, 0.6, 50))
    for m in range(4):
        np.testing.assert_allclose(ts.gamma_ratio(v, m),
                                   np.asarray(js.gamma_ratio(v, m)), rtol=1e-12)
        np.testing.assert_allclose(ts.kvm(v, m), np.asarray(js.kvm(v, m)),
                                   rtol=1e-12)
        for mm in (m, -m):
            np.testing.assert_array_equal(ts.lpmv_host(mm, 40.3, x),
                                          js.lpmv_host(mm, 40.3, x))
    z = np.linspace(0.0, 12.0, 40)
    for alpha in (0.0, 1.0):
        np.testing.assert_array_equal(ts.np_laguerre_all(5, z, alpha),
                                      js.np_laguerre_all(5, z, alpha))
