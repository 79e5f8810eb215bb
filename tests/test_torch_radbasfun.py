"""PyTorch port, the radbasfun (Gaussian RBF) model against the JAX
package's, on the CPU in float64: centres, basis and gradient, a fit
through ops/fit and a small Interpolate day, and dense-grid evaluation
(RBFGridEvaluator, Estimate.grid_eval / evaluate_records)."""

import datetime as dt

import numpy as np
import pytest
import torch

from volumetricinterp_tpu import Interpolate as JInterpolate
from volumetricinterp_tpu.config import Config as JConfig
from volumetricinterp_tpu.io.synth import write_synthetic_amisr
from volumetricinterp_tpu.models.radbasfun import Model as JModel
from volumetricinterp_tpu.ops.fit import fit_records as jfit_records

from volumetricinterp_tpu_torch import Estimate, Interpolate
from volumetricinterp_tpu_torch.config import Config
from volumetricinterp_tpu_torch.models import make_model
from volumetricinterp_tpu_torch.ops import solve
from volumetricinterp_tpu_torch.ops.fit import fit_records
from volumetricinterp_tpu_torch.ops.grid_eval import (RBFGridEvaluator,
                                                      grid_eval,
                                                      make_grid_evaluator)

# the JAX package's tests/test_model_radbasfun.py configuration: 64 centres
CFG = """
[DEFAULT]
[MODEL]
NAME = radbasfun
LATCP = 78
LONCP = 262
EPS = 100000.0
LATRANGE = 74,80
LONRANGE = 260,285
ALTRANGE = 100,600
NUMGRIDPNT = 4
"""
# the existing fit bars (chip_smoke.py): a Gaussian RBF basis is
# rank-deficient, so the gelsd cutoff makes a staircase
CHI2_MEDIAN_TOL, CHI2_MAX_TOL = 0.05, 0.30
WFIELD_MEDIAN_TOL, WFIELD_MAX_TOL = 0.05, 0.15
GRID_TOL = 5e-5  # of the sup: float32 evaluation (test_model_radbasfun.py)


@pytest.fixture(scope="module")
def models():
    return make_model("radbasfun", Config.from_text(CFG)), JModel(
        JConfig.from_text(CFG))


def _points(seed, n=500):
    rng = np.random.default_rng(seed)
    return (rng.uniform(74.5, 79.5, n), rng.uniform(262, 283, n),
            rng.uniform(1.5e5, 5.5e5, n))


def _wfield(C, C_ref, A, values, errors):
    """|sw A (C - C_ref)| / |sw A C_ref| per record, sw = 1/error on the
    record's valid points (docs/PARITY_NOTES.md #7)."""
    ok = np.isfinite(values)
    sw = ok / np.where(ok, errors, 1.0)
    return (np.linalg.norm(sw * ((C - C_ref) @ A.T), axis=1)
            / np.linalg.norm(sw * (C_ref @ A.T), axis=1))


def _held(vals, median_tol, max_tol):
    v = vals[np.isfinite(vals)]
    assert v.size and np.median(v) <= median_tol and v.max() <= max_tol, (
        np.median(v), v.max())


def test_centers_bitwise_equal(models):
    tm, jm = models
    assert tm.nbasis == jm.nbasis == 64
    np.testing.assert_array_equal(tm.centers, np.asarray(jm.centers))
    assert tm.eval_reg_matricies == {} == jm.eval_reg_matricies


def test_basis_grad_and_transform_match_jax(models):
    """basis and grad_basis within 1e-12 of the sup; shapes preserved."""
    tm, jm = models
    lat, lon, alt = _points(7, 200)
    A, Aj = tm.basis(lat, lon, alt), np.asarray(jm.basis(lat, lon, alt))
    assert A.shape == Aj.shape == (200, 64)
    assert np.max(np.abs(A - Aj)) <= 1e-12 * np.max(np.abs(Aj))
    G, Gj = tm.grad_basis(lat, lon, alt), np.asarray(
        jm.grad_basis(lat, lon, alt))
    assert G.shape == Gj.shape == (200, 3, 64)
    assert np.max(np.abs(G - Gj)) <= 1e-12 * np.max(np.abs(Gj))
    np.testing.assert_allclose(tm.transform_coords(lat, lon, alt),
                               np.asarray(jm.transform_coords(lat, lon, alt)),
                               rtol=1e-14)
    grid = [np.full((2, 3), x) for x in (77.0, 265.0, 3e5)]
    assert tm.basis(*grid).shape == (2, 3, 64)
    assert tm.grad_basis(*grid).shape == (2, 3, 3, 64)
    # the gradient is the basis' own derivative in ECEF (central
    # differences of the host design matrix, 1 m steps)
    R = tm._ecef(lat[:4], lon[:4], alt[:4])
    for c in range(3):
        step = np.zeros(3)
        step[c] = 1.0
        fd = (tm._design_np(R + step) - tm._design_np(R - step)) / 2.0
        assert np.max(np.abs(G[:4, c] - fd)) < 1e-9


def test_fit_records_matches_jax(models):
    """No regularization: the plain cutoff solve, in both packages, on the
    JAX test's noisy RBF field (4 records)."""
    tm, jm = models
    lat, lon, alt = _points(11, 300)
    A = tm.basis(lat, lon, alt)
    rng = np.random.default_rng(5)
    ne = A @ (rng.normal(size=64) * 1e11)
    noise = 1e9 + 0.01 * np.abs(ne)
    values = ne + rng.normal(0, 1, (4, ne.size)) * noise
    errors = np.broadcast_to(noise, values.shape).copy()
    values[1, :9] = np.nan
    R = np.zeros((0, 64, 64))
    h0 = solve.host_eigh_matrices
    C, dC, chi2, rp = (t.numpy() for t in fit_records(
        values, errors, A, R, device="cpu"))
    # the cutoff solve is AtWA's host eigendecomposition, one a record
    assert solve.host_eigh_matrices - h0 == 4
    Cj, _, chi2j, _ = (np.asarray(x) for x in jfit_records(
        values, errors, A, R, method="chi2"))
    assert rp.shape == (4, 0) and dC.shape == (4, 64, 64)
    assert np.isfinite(chi2).all() and (chi2 >= 0).all()
    _held(np.abs(chi2 - chi2j) / chi2j, CHI2_MEDIAN_TOL, CHI2_MAX_TOL)
    _held(_wfield(C, Cj, A, values, errors), WFIELD_MEDIAN_TOL, WFIELD_MAX_TOL)
    assert np.max(np.abs(C[0] @ A.T - ne)) < 0.2 * np.max(np.abs(ne))


@pytest.fixture(scope="module")
def day(tmp_path_factory):
    """A 6-record synthetic day fitted with radbasfun (no regularization)
    by both packages' Interpolate; the port's coefficient file."""
    tmp = tmp_path_factory.mktemp("rbf_torch")
    raw = str(tmp / "synth.h5")
    text = CFG.replace("[DEFAULT]", f"""[DEFAULT]
FILENAME = {raw}
OUTPUTFILENAME = {tmp / 'coef.h5'}
REGULARIZATION_LIST =
REGULARIZATION_METHOD = chi2""")
    write_synthetic_amisr(raw, nrec=6, seed=5, nan_frac=0.03, bad_frac=0.01)
    t = Interpolate(text, device="cpu")
    t.calc_coeffs()
    t.saveh5()
    j = JInterpolate(JConfig.from_text(text.replace("coef.h5", "coef_j.h5")))
    j.calc_coeffs()
    return dict(t=t, j=j, path=str(tmp / "coef.h5"))


def test_interpolate_day_matches_jax(day):
    t, j = day["t"], day["j"]
    _, lat, lon, alt, values, errors = t.read_datafile(t.filename)
    A = t.model.basis(lat, lon, alt)
    np.testing.assert_array_equal(np.isnan(t.chi_sq), np.isnan(j.chi_sq))
    assert t.reg_params.shape == (6, 0)
    assert (t.chi_sq[np.isfinite(t.chi_sq)] >= 0).all()
    _held(np.abs(t.chi_sq - j.chi_sq) / j.chi_sq, CHI2_MEDIAN_TOL,
          CHI2_MAX_TOL)
    _held(_wfield(t.Coeffs, j.Coeffs, A, values, errors), WFIELD_MEDIAN_TOL,
          WFIELD_MAX_TOL)


def test_rbf_evaluator_crosses_point_chunks(models):
    """RBFGridEvaluator (97-point chunks over 500 points) and the one-shot
    grid_eval within 5e-5 of the sup of the float64 basis."""
    tm, _ = models
    lat, lon, alt = _points(99)
    rng = np.random.default_rng(3)
    Cs = rng.normal(size=(3, 64)) * 1e11
    truth = (tm.basis(lat, lon, alt) @ Cs.T).T
    ev = RBFGridEvaluator(tm, device="cpu")
    ev.point_chunk = 97
    out = ev.eval_records(Cs, lat, lon, alt).numpy()
    assert out.shape == (3, 500) and out.dtype == np.float32
    assert np.max(np.abs(out - truth)) < GRID_TOL * np.max(np.abs(truth))
    one = grid_eval(tm, Cs[1], lat, lon, alt, device="cpu").numpy()
    assert np.max(np.abs(one - truth[1])) < GRID_TOL * np.max(np.abs(truth[1]))
    assert isinstance(make_grid_evaluator(tm, device="cpu"), RBFGridEvaluator)
    inside = torch.as_tensor(np.arange(500) % 3 != 0)
    masked = ev.eval_records(Cs, lat, lon, alt, inside=inside).numpy()
    np.testing.assert_array_equal(np.isnan(masked[0]), ~inside.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            RBFGridEvaluator(tm)  # device="cuda" is the default


def test_estimate_products(day):
    """Estimate.grid_eval / evaluate_records of the radbasfun file (FoV
    mask on) within 5e-5 of the sup of the float64 point API, through
    point chunks of 97."""
    est = Estimate(day["path"], device="cpu")
    est._grid_ev = RBFGridEvaluator(est.model, device="cpu")
    est._grid_ev.point_chunk = 97
    grid = np.meshgrid(np.linspace(73.5, 77.0, 10),
                       np.linspace(258.0, 272.0, 12),
                       np.array([200e3, 300e3, 450e3]))
    times = [dt.datetime(1970, 1, 1) + dt.timedelta(seconds=float(t))
             for t in np.mean(est.time, axis=1)[:3]]
    vol = est.evaluate_records(times, *grid)
    assert vol.shape == (3,) + grid[0].shape and vol.dtype == np.float32
    assert est._grid_ev.point_chunk == 97  # the evaluator was reused
    for i, t in enumerate(times):
        P = est(t, *grid)
        np.testing.assert_array_equal(np.isnan(vol[i]), np.isnan(P))
        f = np.isfinite(P)
        assert 0 < f.sum() < f.size
        assert np.max(np.abs(vol[i][f] - P[f])) <= GRID_TOL * np.max(
            np.abs(P[f]))
    # one record against three: the contraction's float32 summation order
    # follows the batch width (a matrix-vector against a matrix product)
    one = est.grid_eval(times[1], *grid)
    np.testing.assert_array_equal(np.isnan(one), np.isnan(vol[1]))
    assert np.nanmax(np.abs(one - vol[1])) <= 1e-6 * np.nanmax(np.abs(vol[1]))
