"""PyTorch port, data-informed regularization (profile taus): Model.eval_tau,
the tau term in every chi2 mode's search and final solve, the
REGULARIZATION_PROFILE configuration through both Interpolates, and the
single-pass multi-parameter fit, against the JAX package (CPU float64; the
model at MAXK=2, MAXL=3).  After tests/test_tau_reg.py."""

import os

import numpy as np
import pytest
import torch

from volumetricinterp_tpu import Interpolate as JInterpolate
from volumetricinterp_tpu.config import Config as JConfig
from volumetricinterp_tpu.io.synth import write_synthetic_amisr
from volumetricinterp_tpu.models.sphharmlag import Model as JModel

from volumetricinterp_tpu_torch import Interpolate
from volumetricinterp_tpu_torch.config import Config as TConfig
from volumetricinterp_tpu_torch.constants import RE
from volumetricinterp_tpu_torch.models.sphharmlag import Model as TModel
from volumetricinterp_tpu_torch.ops.fit import fit_records

from test_torch_fit import CFG, _jax_fit, _sup_close

# the JAX package's chi2 identity at alpha = 1 holds this scale of pull on
# the test day; from ~1e10 up it cancels to noise there (see
# test_pull_dominated_chi2_at_alpha_one)
PROFILE = "chapman,1e9,300,50"


def chapman(nmax=1e11, hmax_km=300.0, scale_km=50.0):
    """Interpolate._reg_taus' profile in the model's scaled altitude."""
    z0, hz = (100.0 * x * 1000.0 / RE for x in (hmax_km, scale_km))
    return lambda z: nmax * np.exp(
        0.5 * (1.0 - (np.asarray(z) - z0) / hz - np.exp(-(np.asarray(z) - z0) / hz)))


@pytest.mark.parametrize("quad_mode", ["quad", "gauss"])
def test_eval_tau_matches_jax(quad_mode):
    """rtol 1e-12: both run the same host numpy/scipy integrals."""
    cfg = CFG.replace("QUAD_MODE = gauss", f"QUAD_MODE = {quad_mode}")
    got = TModel(TConfig.from_text(cfg)).eval_tau(chapman())
    ref = np.asarray(JModel(JConfig.from_text(cfg)).eval_tau(chapman()))
    assert got.shape == ref.shape == (18, 1)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0.0)


@pytest.fixture(scope="module")
def tau_records():
    """The construction of tests/test_tau_reg.py over 10 records: a graded
    random design (24 columns over three decades), a PD regularizer and a
    target C_target the data disagree with, tau = R C_target; plus one
    too-smooth record (huge declared errors) and one without a bracket
    (tiny declared errors).  R is scaled so that every root lies inside
    the bracket, at log10 alpha -2.4 to -5.5."""
    rng = np.random.default_rng(21)
    npts, nb, nrec = 200, 24, 12
    A = rng.normal(size=(npts, nb)) * (10.0 ** (-3.0 * rng.random(nb)))[None]
    C_true = rng.normal(size=nb)
    values = A @ C_true + 0.5 * rng.normal(size=(nrec, npts))
    values[rng.random((nrec, npts)) < 0.05] = np.nan
    errors = np.full((nrec, npts), 0.6)
    errors[10] *= 300.0
    errors[11] *= 1e-3
    R = 1e3 * (np.eye(nb) + 0.05 * np.ones((nb, nb)))
    tau = (R @ (rng.normal(size=nb) * 2.0))[None]
    return values, errors, A, R[None], tau


MODES = [("chi2", "exact"), ("chi2", "exact_grid"), ("chi2", "fast"),
         ("manual", "exact")]


@pytest.mark.parametrize("method,mode", MODES,
                         ids=[f"{m}-{d}" for m, d in MODES])
def test_zero_tau_equals_no_tau(tau_records, method, mode):
    """A zero tau vector gives the fit without one, bitwise."""
    values, errors, A, R, tau = tau_records
    kw = dict(method=method, regparam_mode=mode, device="cpu",
              manual_params=[1e-3] if method == "manual" else None)
    base = fit_records(values, errors, A, R, **kw)
    zero = fit_records(values, errors, A, R, reg_taus=np.zeros_like(tau), **kw)
    for a, b in zip(base, zero):
        assert torch.equal(torch.nan_to_num(a, nan=7.0),
                           torch.nan_to_num(b, nan=7.0))


@pytest.mark.parametrize("method,mode", MODES,
                         ids=[f"{m}-{d}" for m, d in MODES])
def test_tau_fits_match_jax(tau_records, method, mode):
    """Roots within 2e-3 decades (the staircase envelope of
    test_torch_fit_chi2), the same outcome classes, and C, dC, chi2
    within 1e-6 of each record's sup; the pull changes the fit."""
    values, errors, A, R, tau = tau_records
    kw = dict(method=method, regparam_mode=mode,
              manual_params=[1e-3] if method == "manual" else None)
    ref = _jax_fit(values, errors, A, R, reg_taus=tau, **kw)
    got = tuple(t.numpy() for t in fit_records(
        values, errors, A, R, reg_taus=tau, device="cpu", **kw))
    rp, rpj = got[3], ref[3]
    np.testing.assert_array_equal(np.isnan(rp), np.isnan(rpj))
    np.testing.assert_array_equal(rp == 0.0, rpj == 0.0)
    ok = rpj > 0
    assert ok.sum() >= 10
    assert np.max(np.abs(np.log10(rp[ok]) - np.log10(rpj[ok]))) < 2e-3
    for r in range(len(rp)):
        for a, b in zip(got[:3], ref[:3]):
            _sup_close(a[r], b[r], 1e-6)
    plain = _jax_fit(values, errors, A, R, **kw)
    fin = np.isfinite(ref[2])
    assert np.max(np.abs(plain[0][fin] - ref[0][fin])) > 1e-3 * np.max(
        np.abs(ref[0][fin]))


@pytest.fixture(scope="module")
def profile_day(tmp_path_factory, small_config_text):
    """A 12-record synthetic day at MAXK=2 / MAXL=3 with
    REGULARIZATION_PROFILE set, fitted by both Interpolates (exact mode)."""
    tmp = tmp_path_factory.mktemp("tau_torch")
    raw = str(tmp / "synth.h5")
    text = (small_config_text.replace("test_input.h5", raw)
            .replace("REGULARIZATION_LIST = 0thorder",
                     f"REGULARIZATION_LIST = 0thorder\n"
                     f"REGULARIZATION_PROFILE = {PROFILE}")
            + "\n[TPU]\nQUAD_MODE = gauss\n")
    write_synthetic_amisr(raw, smooth_in_model=JModel(JConfig.from_text(text)),
                          nrec=12, seed=9, nan_frac=0.03, bad_frac=0.01)
    out = {}
    for tag, cls, extra in (("jax", JInterpolate, {}),
                            ("torch", Interpolate, {"device": "cpu"})):
        path = str(tmp / f"coef_{tag}.h5")
        interp = cls(text.replace("test_output.h5", path), **extra)
        interp.calc_coeffs()
        interp.saveh5()
        out[tag] = interp
    return text, out


def wfield(interp, C, C_ref):
    """The W-weighted field residual per record (PARITY_NOTES #7)."""
    _, lat, lon, alt, value, error = interp.read_datafile(interp.filename)
    A = interp.model.basis(lat, lon, alt)
    ok = np.isfinite(value)
    sw = ok / np.where(ok, error, 1.0)
    return (np.linalg.norm(sw * ((C - C_ref) @ A.T), axis=1)
            / np.linalg.norm(sw * (C_ref @ A.T), axis=1))


def test_profile_config_end_to_end(profile_day):
    """Both packages build the same taus and land on the same roots (2e-3
    decades) with chi2 within 1e-3 and the W-weighted field within 1e-3 of
    each other (the data-determined bars of the cutoff wall at MAXL=3;
    test_torch_fit_chi2.WALL_BARS holds 2e-3 there)."""
    _, out = profile_day
    j, t = out["jax"], out["torch"]
    names, nb = t.regularization_list, t.model.nbasis
    np.testing.assert_allclose(t._reg_taus(names, nb),
                               np.asarray(j._reg_taus(names, nb)), rtol=1e-12)
    np.testing.assert_array_equal(np.isnan(t.chi_sq), np.isnan(j.chi_sq))
    np.testing.assert_array_equal(t.reg_params == 0, j.reg_params == 0)
    ok = j.reg_params[:, 0] > 0
    assert ok.sum() >= 9
    assert np.max(np.abs(np.log10(t.reg_params[ok])
                         - np.log10(j.reg_params[ok]))) < 2e-3
    f = np.isfinite(j.chi_sq)
    np.testing.assert_allclose(t.chi_sq[f], j.chi_sq[f], rtol=1e-3)
    assert np.max(wfield(t, t.Coeffs[f], j.Coeffs[f])) < 1e-3


def test_pull_dominated_chi2_at_alpha_one(profile_day):
    """With the profile of chip_smoke's phase 4e (chapman,1e11,300,50) the
    chi2 of the alpha = 1 solve, whose C'tau and C'RC are ~1e22 apart from
    chi2 ~ 1e4, matches the residual chi2 of that solve within 1e-6: the
    ladder's too-smooth decision rests on it.  (The JAX package's identity
    there gives rounding noise of either sign: every record of this day
    takes its too-smooth outcome, so it is not compared.)"""
    import volumetricinterp_tpu_torch.ops.solve as ts

    text, out = profile_day
    t = Interpolate(text.replace(PROFILE, "chapman,1e11,300,50"), device="cpu")
    _, lat, lon, alt, values, errors = t.read_datafile(t.filename)
    A = t.model.basis(lat, lon, alt)
    R = t.model.eval_psi()
    tau = t._reg_taus(["0thorder"], t.model.nbasis)[0]
    AtWA, AtWb, btWb, _ = ts.suff_stats(*(torch.as_tensor(x) for x in (
        A, values, errors)))
    X1 = AtWA + torch.as_tensor(R)
    w, V, s = ts.normalized_eigh(X1)
    got = ts.chi2_from_eig_x(w, V, None, AtWb, btWb, s, aR=torch.as_tensor(R),
                             atau=torch.as_tensor(tau).expand(len(w), -1),
                             AtWA=AtWA).numpy()
    for r in range(len(got)):
        ok = np.isfinite(values[r])
        W = np.where(ok, errors[r], 1.0) ** -2.0 * ok
        b = np.where(ok, values[r], 0.0)
        C = np.linalg.solve(X1[r].numpy(), AtWb[r].numpy() + tau)
        want = np.sum(W * (b - A @ C) ** 2)
        assert want > 10 * ok.sum()  # far from too smooth
        assert abs(got[r] - want) <= 1e-6 * want, r


def test_multiparam_matches_jax(profile_day, tmp_path):
    """calc_coeffs_multiparam(["dens", "temp_N2"]) as
    tests/test_end2end.py:236-245 calls it: one file per parameter with
    the `.{param}` suffix, each fit within the bars of the single fits."""
    text, _ = profile_day
    res = {}
    for tag, cls, extra in (("jax", JInterpolate, {}),
                            ("torch", Interpolate, {"device": "cpu"})):
        out = str(tmp_path / f"multi_{tag}.h5")
        interp = cls(text.replace("test_output.h5", out), **extra)
        res[tag] = interp.calc_coeffs_multiparam(["dens", "temp_N2"])
        assert set(res[tag]) == {"dens", "temp_N2"}
        assert interp.param == "dens" and interp.outputfilename == out
        root, ext = os.path.splitext(out)
        for prm in ("dens", "temp_N2"):
            assert os.path.exists(f"{root}.{prm}{ext}")
    from volumetricinterp_tpu_torch import Estimate

    for prm in ("dens", "temp_N2"):
        (tt, C, dC, c2), (ttj, Cj, dCj, c2j) = res["torch"][prm], res["jax"][prm]
        np.testing.assert_array_equal(tt, ttj)
        np.testing.assert_array_equal(np.isnan(c2), np.isnan(c2j))
        f = np.isfinite(c2j)
        # every temp_N2 record of this day fails in both packages
        assert f.sum() >= 9 if prm == "dens" else not f.any()
        np.testing.assert_allclose(c2[f], c2j[f], rtol=1e-3)
        root, ext = os.path.splitext(str(tmp_path / "multi_torch.h5"))
        est = Estimate(f"{root}.{prm}{ext}", device="cpu")
        np.testing.assert_array_equal(est.Coeffs, C)
