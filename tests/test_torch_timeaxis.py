"""PyTorch port, the time axis: the jointly time-regularized solve
(ops/timejoint.py), the coefficient time spline (ops/timesmooth.py), the
TIME_COUPLING and TIME_SMOOTHING configurations through both Interpolates,
and Estimate(timeinterp='spline') on files of either package, against the
JAX package (CPU float64, MAXK=2, MAXL=3).  After tests/test_timejoint.py
and tests/test_timesmooth.py."""

import datetime as dt

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from volumetricinterp_tpu import Estimate as JEstimate
from volumetricinterp_tpu import Interpolate as JInterpolate
from volumetricinterp_tpu.config import Config as JConfig
from volumetricinterp_tpu.io.synth import write_synthetic_amisr
from volumetricinterp_tpu.models.sphharmlag import Model as JModel
from volumetricinterp_tpu.ops import timejoint as jtimejoint
from volumetricinterp_tpu.ops import timesmooth as jtimesmooth

from volumetricinterp_tpu_torch import Estimate, Interpolate
from volumetricinterp_tpu_torch.io.coeffs import load_coeff_file
from volumetricinterp_tpu_torch.ops import timejoint, timesmooth


def _utc(ts):
    return dt.datetime(1970, 1, 1) + dt.timedelta(seconds=float(ts))


@pytest.fixture(scope="module")
def records(small_config_text):
    """tests/test_timejoint.py's 12 records (300 points, a drifting
    Gaussian layer) with their statistics from the JAX package."""
    model = JModel(JConfig.from_text(small_config_text))
    rng = np.random.default_rng(23)
    npts, nrec = 300, 12
    lat = rng.uniform(74, 82, npts)
    lon = rng.uniform(252, 272, npts)
    alt = rng.uniform(1e5, 6e5, npts)
    A = np.asarray(model.basis(lat, lon, alt))
    target = 4e11 * np.exp(-(((alt - 3e5) / 1.2e5) ** 2))
    C_true = np.linalg.lstsq(A, target, rcond=1e-10)[0]
    values = np.zeros((nrec, npts))
    errors = np.zeros((nrec, npts))
    for r in range(nrec):
        ne = A @ C_true * (1.0 + 0.03 * r)
        noise = 2e10 + 0.05 * np.abs(ne)
        values[r] = ne + rng.normal(0, 1, npts) * noise
        errors[r] = 1.15 * noise
    values[rng.random((nrec, npts)) < 0.05] = np.nan
    psi = np.asarray(model.eval_psi())[None]
    la = -22.0 + 0.3 * rng.random((nrec, 1))
    AtWA, AtWb, _, _ = (np.asarray(x) for x in jtimejoint._stats_batch(
        jnp.asarray(values), jnp.asarray(errors), jnp.asarray(A)))
    return dict(values=values, errors=errors, A=A, R=psi, la=la, AtWA=AtWA,
                AtWb=AtWb)


CASES = {"weak": (1e-12, None), "strong": (1e2, None), "carried": (1e-3, 5)}


def wfield(values, errors, A, C, C_ref):
    """The W-weighted field residual per record (PARITY_NOTES #7), over
    the points valid in any record."""
    ok = np.isfinite(errors)
    sw = ok / np.where(ok, errors, 1.0)
    return (np.linalg.norm(sw * ((C - C_ref) @ A.T), axis=1)
            / np.linalg.norm(sw * (C_ref @ A.T), axis=1))


@pytest.mark.parametrize("case", list(CASES))
def test_joint_time_solve_matches_jax(records, case):
    """The same statistics and alphas into both block-Thomas solves: the
    W-weighted field within 1e-9 relative on every record (C itself agrees
    to ~1e-12 of its sup at weak coupling and ~7e-9 at beta_rel = 1e2,
    where the recursion cancels ~beta-sized terms).  'carried': record 5's
    search failed (NaN alpha) and its data are gone; the coupling carries
    it."""
    beta, nan_rec = CASES[case]
    d = records
    AtWA, AtWb, la = d["AtWA"].copy(), d["AtWb"].copy(), d["la"].copy()
    if nan_rec is not None:
        la[nan_rec] = np.nan
        AtWA[nan_rec] = 0.0
        AtWb[nan_rec] = 0.0
    ref = np.asarray(jtimejoint.joint_time_solve(
        jnp.asarray(AtWA), jnp.asarray(AtWb), jnp.asarray(d["R"]),
        jnp.asarray(la), beta))
    got = timejoint.joint_time_solve(
        *(torch.as_tensor(x) for x in (AtWA, AtWb, d["R"], la)), beta).numpy()
    assert np.isfinite(got).all()
    assert wfield(d["values"], d["errors"], d["A"], got, ref).max() <= 1e-9


@pytest.mark.parametrize("case", list(CASES))
def test_fit_time_coupled_matches_jax(records, case):
    """The host entry points, statistics included (the port's come from
    solve.suff_stats in record chunks): the W-weighted field within 1e-9
    relative, the joint data chi2 within 1e-8 (it sums residuals of values
    ~1e3 error bars each)."""
    beta, nan_rec = CASES[case]
    d = records
    values, errors, la = d["values"].copy(), d["errors"].copy(), d["la"].copy()
    if nan_rec is not None:
        la[nan_rec] = np.nan
        values[nan_rec] = np.nan
    Cj, c2j = jtimejoint.fit_time_coupled(values, errors, d["A"], d["R"], la,
                                          beta)
    C, c2 = timejoint.fit_time_coupled(values, errors, d["A"], d["R"], la,
                                       beta, device="cpu")
    assert np.isfinite(C).all()
    assert wfield(values, d["errors"], d["A"], C, Cj).max() <= 1e-9
    np.testing.assert_allclose(c2, c2j, rtol=1e-8)


def test_stats_chunks(records, monkeypatch):
    """time_stats over record chunks equals one batch."""
    d = records
    t = [torch.as_tensor(d[k]) for k in ("values", "errors", "A")]
    whole = timejoint.time_stats(*t)
    monkeypatch.setattr(timejoint, "STATS_CHUNK", 5)
    for a, b in zip(timejoint.time_stats(*t), whole):
        assert torch.allclose(a, b, rtol=1e-13, atol=0.0)


@pytest.mark.parametrize("lam", ["gcv", 3.0])
def test_fit_time_spline_matches_jax(lam):
    """The same trajectories (one NaN record, dropped by both): the same
    GCV lambda, knots equal, S within 1e-10 of its sup; eval_time_spline at
    the record times within 1e-10."""
    rng = np.random.default_rng(4)
    t = 1.48e9 + 60.0 * np.arange(40)
    C = (np.sin(np.arange(40) / 6.0)[:, None] * rng.normal(size=18)
         + 0.05 * rng.normal(size=(40, 18)))
    C[7] = np.nan
    ref = jtimesmooth.fit_time_spline(t, C, lam=lam)
    got = timesmooth.fit_time_spline(t, C, lam=lam)
    assert got["lam"] == ref["lam"]
    np.testing.assert_array_equal(got["knots"], ref["knots"])
    S, Sj = got["S"], ref["S"]
    assert np.max(np.abs(S - Sj)) <= 1e-10 * np.max(np.abs(Sj))
    e, ej = (m.eval_time_spline(f, t[::3]) for m, f in ((timesmooth, got),
                                                        (jtimesmooth, ref)))
    assert np.max(np.abs(e - ej)) <= 1e-10 * np.max(np.abs(ej))


@pytest.fixture(scope="module")
def time_day(tmp_path_factory, small_config_text):
    """A 16-record synthetic day at MAXK=2 / MAXL=3 (exact_grid search)
    with TIME_COUPLING = 1e-4 and TIME_SMOOTHING = gcv, fitted by both
    Interpolates into two coefficient files."""
    tmp = tmp_path_factory.mktemp("time_torch")
    raw = str(tmp / "synth.h5")
    text = (small_config_text.replace("test_input.h5", raw)
            .replace("[MODEL]", "TIME_COUPLING = 1e-4\nTIME_SMOOTHING = gcv\n"
                     "\n[MODEL]")
            + "\n[TPU]\nQUAD_MODE = gauss\nREGPARAM_MODE = exact_grid\n")
    write_synthetic_amisr(raw, smooth_in_model=JModel(JConfig.from_text(text)),
                          nrec=16, seed=12, nan_frac=0.03, bad_frac=0.01)
    out = {}
    for tag, cls, extra in (("jax", JInterpolate, {}),
                            ("torch", Interpolate, {"device": "cpu"})):
        path = str(tmp / f"coef_{tag}.h5")
        interp = cls(text.replace("test_output.h5", path), **extra)
        interp.calc_coeffs()
        interp.saveh5()
        out[tag] = (interp, path)
    return text, out


def test_time_configs_end_to_end(time_day):
    """The independent searches agree (2e-3 decades); the joint solutions,
    each at its own package's alphas, within 1e-3 in chi2 and the
    W-weighted field (the bars of the independent fits), and the port's
    joint solve fed the JAX package's alphas within 1e-9 of the JAX joint
    solution (chi2 within 1e-8: it sums residuals of values ~1e3 error
    bars each); the spline payload written by both, with the same knots
    and lambda, evaluated at the record times within the field bar (the
    spline smooths the independent coefficients, whose sub-cutoff
    directions differ between any two solvers at MAXL=3); the file holds
    the joint coefficients."""
    _, out = time_day
    (j, jpath), (t, tpath) = out["jax"], out["torch"]
    ok = j.reg_params[:, 0] > 0
    assert ok.sum() >= 12
    assert np.max(np.abs(np.log10(t.reg_params[ok])
                         - np.log10(j.reg_params[ok]))) < 2e-3
    _, lat, lon, alt, values, errors = t.read_datafile(t.filename)
    A = t.model.basis(lat, lon, alt)
    assert wfield(values, errors, A, t.Coeffs, j.Coeffs).max() <= 1e-3
    np.testing.assert_allclose(t.chi_sq, j.chi_sq, rtol=1e-3)
    with np.errstate(divide="ignore"):
        la = np.log10(np.where(j.reg_params > 0, j.reg_params, 0.0))
    C_at, c2_at = timejoint.fit_time_coupled(
        values, errors, A, np.asarray(j._reg_matrices()["0thorder"])[None], la,
        1e-4, device="cpu")
    assert wfield(values, errors, A, C_at, j.Coeffs).max() <= 1e-9
    np.testing.assert_allclose(c2_at, j.chi_sq, rtol=1e-8)
    assert t.timefit["lam"] == j.timefit["lam"]
    np.testing.assert_array_equal(t.timefit["knots"], j.timefit["knots"])
    mt = np.mean(t.time, axis=1)
    Cs, Csj = (timesmooth.eval_time_spline(x.timefit, mt) for x in (t, j))
    assert wfield(values, errors, A, Cs, Csj).max() <= 1e-3
    f = load_coeff_file(tpath)
    np.testing.assert_array_equal(f["Coeffs"], t.Coeffs)
    np.testing.assert_array_equal(f["timefit"]["S"], t.timefit["S"])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_spline_estimate_interchange(time_day, writer):
    """Estimate(timeinterp='spline') of either package on either package's
    file: the same C(t) between records and the nearest record's covariance,
    and the point API agrees (rtol 1e-12)."""
    interp, path = time_day[1][writer]
    te = Estimate(path, timeinterp="spline", device="cpu")
    je = JEstimate(path, timeinterp="spline")
    mt = np.mean(interp.time, axis=1)
    when = _utc(0.5 * (mt[3] + mt[4]) + 7.0)
    (C, dC), (Cj, dCj) = te.get_C(when), je.get_C(when)
    np.testing.assert_allclose(C, np.asarray(Cj), rtol=1e-12)
    np.testing.assert_array_equal(dC, dCj)
    np.testing.assert_array_equal(dC, interp.Covariance[4])
    lat, lon, alt = np.meshgrid(np.linspace(74.0, 76.0, 5),
                                np.linspace(262.0, 268.0, 4), [250e3, 300e3])
    P, Pj = te(when, lat, lon, alt), je(when, lat, lon, alt)
    np.testing.assert_array_equal(np.isnan(P), np.isnan(Pj))
    assert np.isfinite(P).any()
    np.testing.assert_allclose(P, Pj, rtol=1e-12, equal_nan=True)
    with pytest.raises(ValueError, match="out of range"):
        te.get_C(_utc(mt[-1] + 3600.0))


def test_spline_needs_the_payload(tmp_path, small_config_text):
    """A file fitted without TIME_SMOOTHING has no /TimeFit: the spline
    Estimate raises ValueError, as the JAX package does."""
    raw = str(tmp_path / "synth.h5")
    path = str(tmp_path / "coef.h5")
    text = (small_config_text.replace("test_input.h5", raw)
            .replace("test_output.h5", path)
            + "\n[TPU]\nQUAD_MODE = gauss\nREGPARAM_MODE = fast\n")
    write_synthetic_amisr(raw, smooth_in_model=JModel(JConfig.from_text(text)),
                          nrec=4, seed=3)
    interp = Interpolate(text, device="cpu")
    interp.calc_coeffs()
    interp.saveh5()
    for make in (lambda: Estimate(path, timeinterp="spline", device="cpu"),
                 lambda: JEstimate(path, timeinterp="spline")):
        with pytest.raises(ValueError, match="TimeFit"):
            make()
    assert Estimate(path, device="cpu").timefit is None
