"""PyTorch port, fit core: fit_records in exact_grid mode (and manual)
against the JAX package's fit_records on the same records, CPU float64.
The other modes are held in test_torch_fit_chi2.py and
test_torch_fit_gcv.py with the helpers of this file."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from volumetricinterp_tpu.config import Config as JConfig
from volumetricinterp_tpu.models.sphharmlag import Model as JModel
from volumetricinterp_tpu.ops import fit as jfit
from volumetricinterp_tpu.ops import solve as jsolve

from volumetricinterp_tpu_torch import Interpolate
from volumetricinterp_tpu_torch.convert import coeffs_from_jax
from volumetricinterp_tpu_torch.ops import solve as tsolve
from volumetricinterp_tpu_torch.ops.fit import fit_records

CFG = """
[DEFAULT]
REGULARIZATION_LIST = 0thorder
[MODEL]
NAME = sphharmlag
MAXK = 2
MAXL = 3
CAP_LIM = 10
MAX_Z_INT = INF
LATCP = 78
LONCP = 262
[TPU]
QUAD_MODE = gauss
"""


def make_records(maxl):
    """12 records: well-posed ones (5% of points dropped), one too-smooth
    (huge declared errors: chi2(1) < 0.6 N) and one no-bracket (tiny
    declared errors: chi2 >> N everywhere), the construction of
    tests/test_regparam_modes.py, at MAXK=2 and the given MAXL."""
    rng = np.random.default_rng(7)
    model = JModel(JConfig.from_text(CFG.replace("MAXL = 3", f"MAXL = {maxl}")))
    npts = 400
    lat = rng.uniform(74.0, 82.0, npts)
    lon = rng.uniform(252.0, 272.0, npts)
    alt = rng.uniform(1.0e5, 6.0e5, npts)
    A = np.asarray(model.basis(lat, lon, alt))
    target = 4e11 * np.exp(-(((alt - 3e5) / 1.2e5) ** 2))
    ne = A @ np.linalg.lstsq(A, target, rcond=1e-10)[0]
    psi = np.asarray(model.eval_psi())
    scales = [1.0] * 10 + [300.0, 0.001]
    noise = 2e10 + 0.05 * np.abs(ne)
    values = ne + rng.normal(0, 1, (12, npts)) * noise
    values[rng.random((12, npts)) < 0.05] = np.nan
    errors = 1.15 * noise * np.asarray(scales)[:, None]
    return values, errors, A, psi[None]


@pytest.fixture(scope="module", params=[2, 3], ids=["maxl2", "maxl3"])
def records(request):
    return request.param, make_records(request.param)


def _jax_fit(values, errors, A, R, **kw):
    C, dC, chi2, rp = jfit.fit_records(values, errors, A, R, **kw)
    C, dC = coeffs_from_jax(C, dC)
    return C, dC, np.asarray(chi2), np.asarray(rp)


def _sup_close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(b)
    if ok.any():
        assert np.max(np.abs(a[ok] - b[ok])) <= rtol * np.max(np.abs(b[ok]))


def _wall_records(values, errors, A, R, alphas):
    """Records whose X = AtWA + alpha R (at the JAX alphas) keeps an
    eigenvalue within 1e3 of the gelsd cutoff eps * max|w|.  Such a mode's
    value carries O(1) relative rounding error in ANY solver, so C and chi2
    there agree only in the data-determined metrics (PARITY_NOTES #7/#8)."""
    wall = set()
    for r in range(values.shape[0]):
        if np.isnan(alphas[r]).any():
            continue
        mask = np.isfinite(values[r])
        W = np.where(mask, errors[r], 1.0) ** -2.0 * mask
        X = A.T @ (A * W[:, None]) + np.tensordot(alphas[r], R, axes=1)
        w = np.abs(np.linalg.eigvalsh(X))
        cut = 2.220446049250313e-16 * w.max()
        if w[w > cut].min() < 1e3 * cut:
            wall.add(r)
    return wall


def _check_fit(got, ref, values, errors, A, R, wall, loose=(),
               bars=(1e-3, 1e-3, 5e-3)):
    """C, dC, chi2 within 1e-6 of each record's sup, except on the named
    cutoff-wall records (and the ``loose`` records a caller names with its
    reason), which are held to the PARITY_NOTES #7 data-determined bars
    ``bars``: chi2 and the W-weighted field within 1e-3 relative, the
    predicted field variance diag(A dC A') within 5e-3."""
    bar_c2, bar_wf, bar_fv = bars
    (C, dC, c2, rp), (Cj, dCj, c2j, rpj) = got, ref
    assert _wall_records(values, errors, A, R, rpj) == wall
    for r in range(values.shape[0]):
        if r not in wall and r not in loose:
            _sup_close(C[r], Cj[r], 1e-6)
            _sup_close(dC[r], dCj[r], 1e-6)
            _sup_close(c2[r], c2j[r], 1e-6)
            continue
        mask = np.isfinite(values[r])
        sw = mask / np.where(mask, errors[r], 1.0)
        wf = (np.linalg.norm(sw * (A @ (C[r] - Cj[r])))
              / np.linalg.norm(sw * (A @ Cj[r])))
        fv = np.einsum("pi,ij,pj->p", A, dC[r], A)
        fvj = np.einsum("pi,ij,pj->p", A, dCj[r], A)
        assert abs(c2[r] - c2j[r]) <= bar_c2 * c2j[r], r
        assert wf <= bar_wf, r
        assert np.max(np.abs(fv - fvj) / np.abs(fvj)) <= bar_fv, r


# the named cutoff-wall records: MAXL=3 carries the near-null sin-column
# cluster of PARITY_NOTES #2 at the gelsd cutoff; MAXL=2 has none
WALL = {("exact_grid", 2): set(), ("exact_grid", 3): set(range(10)),
        ("manual", 2): set(), ("manual", 3): set(range(11))}


def test_exact_grid_matches_jax(records):
    maxl, (values, errors, A, R) = records
    ref = _jax_fit(values, errors, A, R, regparam_mode="exact_grid")
    got = tuple(t.numpy() for t in fit_records(
        values, errors, A, R, regparam_mode="exact_grid", device="cpu"))
    rp, rpj = got[3], ref[3]
    # outcome classes: too-smooth (alpha 0, from log10 = -inf) and
    # no-bracket (NaN) on the same records
    np.testing.assert_array_equal(np.isnan(rp), np.isnan(rpj))
    np.testing.assert_array_equal(rp == 0.0, rpj == 0.0)
    assert (rpj[10] == 0.0).all() and np.isnan(rpj[11]).all()
    ok = rpj[:, 0] > 0
    assert ok.sum() == 10
    # same root up to the cutoff staircase envelope (test_regparam_modes)
    assert np.max(np.abs(np.log10(rp[ok]) - np.log10(rpj[ok]))) < 2e-3
    _check_fit(got, ref, values, errors, A, R, WALL["exact_grid", maxl])


def test_manual_matches_jax(records):
    maxl, (values, errors, A, R) = records
    kw = dict(method="manual", manual_params=[1e-23])
    ref = _jax_fit(values, errors, A, R, **kw)
    got = tuple(t.numpy() for t in fit_records(
        values, errors, A, R, device="cpu", **kw))
    np.testing.assert_array_equal(got[3], ref[3])
    _check_fit(got, ref, values, errors, A, R, WALL["manual", maxl])


def test_unported_modes_raise(records):
    """A regularization profile of an unknown kind (only 'chapman' is
    defined, as in the JAX package) raises before any data is read.  An
    unknown method or mode is an error."""
    maxl, (values, errors, A, R) = records
    cfg = CFG.replace("MAXL = 3", f"MAXL = {maxl}").replace(
        "[MODEL]", "REGULARIZATION_PROFILE = gaussian,1e11,300,50\n[MODEL]")
    with pytest.raises(ValueError, match="REGULARIZATION_PROFILE"):
        Interpolate(cfg, device="cpu").calc_coeffs()
    with pytest.raises(ValueError):
        fit_records(values, errors, A, R, regparam_mode="exakt", device="cpu")
    with pytest.raises(ValueError):
        fit_records(values, errors, A, R, method="loo", device="cpu")


def test_solve_surface_matches_jax():
    """sym_pinv_apply / chi2_from_eig / cutoff_chi2 on an ill-conditioned
    SPD pencil (spectrum over 20 decades)."""
    rng = np.random.default_rng(42)
    n = 24
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    X0 = (Q * 10.0 ** (-20.0 * rng.random(n))) @ Q.T
    B = rng.normal(size=(n, n))
    R = B @ B.T
    y = rng.normal(size=n)
    a = 1e-6
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    Cj, Hj = jsolve.sym_pinv_apply(jnp.asarray(X0 + a * R), jnp.asarray(y))
    C, H = tsolve.sym_pinv_apply(t(X0 + a * R), t(y))
    _sup_close(C.numpy(), np.asarray(Cj), 1e-6)
    _sup_close(H.numpy(), np.asarray(Hj), 1e-6)
    c_ref = float(jsolve.cutoff_chi2(a, jnp.asarray(X0), jnp.asarray(y),
                                     jnp.asarray(3.0), jnp.asarray(R)))
    c1 = float(tsolve.cutoff_chi2(a, t(X0), t(y), t(3.0), t(R)))
    w, V = torch.linalg.eigh(t(X0 + a * R))
    c2 = float(tsolve.chi2_from_eig(w, V, t(X0), t(y), t(3.0)))
    assert np.isclose(c1, c_ref, rtol=1e-8)
    assert np.isclose(c2, c_ref, rtol=1e-8)
