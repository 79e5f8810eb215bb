"""PyTorch port, grid evaluation: the band refit, the coefficient fold and
the kernel's plain twin against the JAX GridEvaluator — its Pallas kernel
in interpret mode (float32) and its XLA path (float64).  The CUDA kernel
itself runs only on the card (chip_smoke.py compares it with this twin)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from volumetricinterp_tpu import coords as jcoords
from volumetricinterp_tpu.config import Config as JConfig
from volumetricinterp_tpu.models.sphharmlag import Model as JModel
from volumetricinterp_tpu.ops.grid_eval import GridEvaluator as JEval

from volumetricinterp_tpu_torch.config import Config as TConfig
from volumetricinterp_tpu_torch.convert import from_jax_evaluator
from volumetricinterp_tpu_torch.models.sphharmlag import Model as TModel
from volumetricinterp_tpu_torch.ops import grid_eval_cuda
from volumetricinterp_tpu_torch.ops.grid_eval import GridEvaluator


@pytest.fixture(scope="module")
def setup(small_config_text):
    # production order for the hot path, as tests/test_grid_eval.py
    text = small_config_text.replace("MAXK = 2", "MAXK = 4").replace(
        "MAXL = 3", "MAXL = 6")
    jm, tm = JModel(JConfig.from_text(text)), TModel(TConfig.from_text(text))
    rng = np.random.default_rng(9)
    n = 8192
    lat = rng.uniform(74, 82, n)
    lon = rng.uniform(252, 272, n)
    alt = rng.uniform(1e5, 6e5, n)
    # one point 40 degrees south of the FoV: far outside the band
    lat[0], lon[0], alt[0] = 40.0, 262.0, 3e5
    _, t, _ = jcoords.np_geodetic_to_cap(lat[1:], lon[1:], alt[1:], 78.0, 262.0)
    band = (t.min(), t.max())
    C = rng.normal(size=(3, tm.nbasis)) * 1e11
    return jm, tm, band, (lat, lon, alt), C


def _fields(jev):
    return {k: getattr(jev, k) for k in
            ("_coef", "pair_degree", "_mbar_pair", "theta_lo", "theta_hi",
             "degree")}


def test_band_refit_matches_jax(setup):
    jm, tm, band, _, _ = setup
    jev = JEval(jm, band, impl="xla")
    ev = GridEvaluator(tm, band, device="cpu")
    assert ev.degree == jev.degree
    np.testing.assert_array_equal(ev.pair_degree, jev.pair_degree)
    np.testing.assert_array_equal(ev.mbar_pair, jev._mbar_pair)
    assert (ev.theta_lo, ev.theta_hi) == (jev.theta_lo, jev.theta_hi)
    np.testing.assert_array_equal(ev.coef_device.numpy(),
                                  jev._coef[:ev.npairs].T)
    tbl = from_jax_evaluator(_fields(jev))
    np.testing.assert_array_equal(np.float32(tbl.coef), ev.coef_device.numpy())
    np.testing.assert_array_equal(tbl.pair_degree, ev.pair_degree)


def test_fold_coeffs_matches_jax(setup):
    jm, tm, band, _, C = setup
    jev = JEval(jm, band, impl="xla", dtype=jnp.float64)
    ev = GridEvaluator(tm, band, dtype=torch.float64, device="cpu")
    got = ev.fold_coeffs(C)
    assert got.shape == (3, 2, ev.npairs, tm.maxk)
    for r in range(3):
        np.testing.assert_array_equal(
            got[r].numpy(), np.asarray(jev.fold_coeffs(C[r]))[:, :ev.npairs])


def test_f32_twin_matches_pallas_interpret(setup, small_config_text):
    """float32 twin vs the TPU kernel in interpret mode on the same band
    table: within the float32 theta-resolution envelope, same NaN set; at
    the production order and at two small ones (maxk not a multiple of 4,
    as the kernel's packed layout pads it)."""
    jm, tm, band, (lat, lon, alt), C = setup
    orders = [(jm, tm, C[0])]
    for maxl, maxk in ((1, 1), (2, 5)):
        text = small_config_text.replace("MAXK = 2", f"MAXK = {maxk}").replace(
            "MAXL = 3", f"MAXL = {maxl}")
        m = TModel(TConfig.from_text(text))
        c = np.random.default_rng(maxl).normal(size=m.nbasis) * 1e11
        orders.append((JModel(JConfig.from_text(text)), m, c))
    for jmod, tmod, c in orders:
        jev = JEval(jmod, band, impl="pallas")
        ev = GridEvaluator(tmod, device="cpu",
                           table=from_jax_evaluator(_fields(jev)))
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jev(c, lat, lon, alt))
        out = ev(c, lat, lon, alt).numpy()
        assert out.dtype == np.float32
        np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
        assert np.isnan(out[0]) and np.isfinite(out[1:]).all()
        ok = np.isfinite(ref)
        assert np.max(np.abs(out[ok] - ref[ok])) <= 5e-5 * np.max(np.abs(ref[ok]))


def test_f64_twin_matches_xla_f64(setup):
    jm, tm, band, (lat, lon, alt), C = setup
    jev = JEval(jm, band, impl="xla", dtype=jnp.float64, tol=1e-13)
    ev = GridEvaluator(tm, band, dtype=torch.float64, tol=1e-13, device="cpu")
    ref = np.asarray(jev(C[1], lat, lon, alt))
    out = ev(C[1], lat, lon, alt).numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    ok = np.isfinite(ref)
    assert np.max(np.abs(out[ok] - ref[ok])) <= 1e-9 * np.max(np.abs(ref[ok]))


def test_batched_records_equal_single_calls(setup):
    _, tm, band, (lat, lon, alt), C = setup
    ev = GridEvaluator(tm, band, device="cpu")
    before = grid_eval_cuda.launches
    shape = (4, 8, 16)
    pts = [a[:512].reshape(shape) for a in (lat, lon, alt)]
    batched = ev.eval_records(C, *pts).numpy()
    assert batched.shape == (3,) + shape
    singles = np.stack([ev(c, *pts).numpy() for c in C])
    np.testing.assert_array_equal(batched, singles)
    assert grid_eval_cuda.launches == before  # the CPU runs the twin


def test_inside_mask_gives_nan(setup):
    _, tm, band, (lat, lon, alt), C = setup
    ev = GridEvaluator(tm, band, device="cpu")
    inside = torch.as_tensor(np.arange(lat.size) % 3 != 0)
    out = ev(C[2], lat, lon, alt, inside=inside).numpy()
    free = ev(C[2], lat, lon, alt).numpy()
    np.testing.assert_array_equal(np.isnan(out),
                                  np.isnan(free) | ~inside.numpy())
    keep = inside.numpy()
    np.testing.assert_array_equal(out[keep], free[keep])
