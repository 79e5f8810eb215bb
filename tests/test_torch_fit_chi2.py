"""PyTorch port, chi2 searches: fit_records in the shipped 'exact' mode and
in 'fast' mode against the JAX package's fit_records on the same records,
the 'exact' search per record against the JAX search and the port's own
exact_grid, and the negative-chi2 report; CPU float64."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from volumetricinterp_tpu.config import Config as JConfig
from volumetricinterp_tpu.models.sphharmlag import Model as JModel
from volumetricinterp_tpu.ops import regparam as jregparam
from volumetricinterp_tpu.ops import solve as jsolve

from volumetricinterp_tpu_torch.ops import fit as tfit
from volumetricinterp_tpu_torch.ops import regparam as tregparam
from volumetricinterp_tpu_torch.ops import solve as tsolve
from volumetricinterp_tpu_torch.ops.fit import fit_records, reg_mats_eig

from test_regparam_modes import fit_ensemble  # noqa: F401 (fixture)
from test_torch_fit import CFG, _check_fit, _jax_fit, make_records

REGS = ("0thorder", "curvature", "both")
# cutoff-wall records of _wall_records at the JAX alphas (see
# test_torch_fit.WALL): MAXL=3 carries the near-null cluster, MAXL=2 none
WALL3 = {"0thorder": set(range(10)), "curvature": {0, 1, 3, 4, 5, 6, 8},
         "both": set(range(10))}
# records whose 'exact' root rests on a tie at the alpha -> 0 floor: the
# floor chi^2 keeps modes at the gelsd cutoff, where any two eigensolvers
# differ by ~1e-10 relative, and that moves the whitened seed by one
# k-section step onto chi2 = nu itself.  The first anchored evaluation's
# sign then decides which side the bracket closes from: the two packages'
# roots land 1.3e-5 decades apart, on either side of the true root (CPU
# float64, record 7).  Held to the data-determined bars of the wall records.
FLOOR_TIES = {(2, "0thorder"): {7}, (2, "both"): {7}}
# data-determined bars of those records.  On the MAXL=3 wall records the
# JAX package's own 'exact' and 'exact_grid' fits differ by up to 1.40e-3
# (chi2), 1.15e-3 (W-weighted field) and 3.23e-3 (predicted field
# variance) relative, and its 'fast' fits from the port's by up to 1.12e-3
# in chi2 at the same root (the final solve's retention at the cutoff,
# PARITY_NOTES #8), CPU float64: test_torch_fit's 1e-3 chi2 and field bars
# lie inside the reference's own spread there.  2e-3 holds them above it.
WALL_BARS = (2e-3, 2e-3, 5e-3)


def reg_mats(maxl, regs):
    model = JModel(JConfig.from_text(
        CFG.replace("MAXL = 3", f"MAXL = {maxl}")))
    mats = {r: np.asarray(model.eval_reg_matricies[r]())
            for r in ("0thorder", "curvature")}
    names = ("0thorder", "curvature") if regs == "both" else (regs,)
    return np.stack([mats[r] for r in names])


@pytest.fixture(scope="module", params=[2, 3], ids=["maxl2", "maxl3"])
def records(request):
    maxl = request.param
    values, errors, A, _ = make_records(maxl)
    return maxl, values, errors, A, {r: reg_mats(maxl, r) for r in REGS}


@pytest.mark.parametrize("regs", REGS)
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_chi2_modes_match_jax(records, mode, regs):
    maxl, values, errors, A, mats = records
    R = mats[regs]
    ref = _jax_fit(values, errors, A, R, regparam_mode=mode)
    got = tuple(t.numpy() for t in fit_records(
        values, errors, A, R, regparam_mode=mode, device="cpu"))
    rp, rpj = got[3], ref[3]
    # outcome classes: too-smooth (alpha 0) and no-bracket (NaN) on the
    # same records; the 0thorder search of record 10 is too smooth and
    # every search of record 11 fails
    np.testing.assert_array_equal(np.isnan(rp), np.isnan(rpj))
    np.testing.assert_array_equal(rp == 0.0, rpj == 0.0)
    assert np.isnan(rpj[11]).all() and (rpj[:10] > 0).all()
    if regs != "curvature":
        assert rpj[10, 0] == 0.0
    # same root up to the staircase envelope of test_regparam_modes; on the
    # cutoff-wall records alpha is not data-determined (the JAX package's
    # own exact and exact_grid roots differ by up to 4.6e-3 decades there)
    # and they are held to the data-determined bars of _check_fit instead
    wall = WALL3[regs] if maxl == 3 else set()
    ok = rpj > 0
    ok[sorted(wall)] = False
    assert np.max(np.abs(np.log10(rp[ok]) - np.log10(rpj[ok])),
                  initial=0.0) < 2e-3
    loose = FLOOR_TIES.get((maxl, regs), set()) if mode == "exact" else set()
    _check_fit(got, ref, values, errors, A, R, wall, loose=loose,
               bars=WALL_BARS)


@pytest.fixture(scope="module")
def ensemble(fit_ensemble):
    """The suff-stats ensemble of tests/test_regparam_modes.py (three
    well-posed records, one too smooth, one without a bracket), as a batch."""
    stats, R = fit_ensemble
    AtWA, AtWb, btWb, N = (np.stack([np.asarray(st[i]) for st, _ in stats])
                           for i in range(4))
    return (AtWA, AtWb, btWb, N, np.array(R)), [k for _, k in stats]


def test_exact_search_matches_jax_and_grid(ensemble):
    (AtWA, AtWb, btWb, N, R), kinds = ensemble
    jax_roots = np.array([float(jregparam.chi2_reg_param(
        (jnp.asarray(AtWA[i]),), (jnp.asarray(AtWb[i]),),
        (jnp.asarray(btWb[i]),), jnp.asarray(N[i]), (jnp.asarray(R),)))
        for i in range(len(kinds))])
    t = [torch.as_tensor(x, dtype=torch.float64)
         for x in (AtWA, AtWb, btWb, N, R)]
    eigR = tuple(x[0] for x in reg_mats_eig(t[4][None]))
    root = tregparam.chi2_reg_param(*t, tsolve.normalized_eigh(t[0]),
                                    eigR).numpy()
    grid = tregparam.chi2_reg_param_grid(*t).numpy()
    assert kinds == ["normal"] * 3 + ["too_smooth", "no_bracket"]
    for got in (root, grid):
        assert (got[3] == -np.inf) and np.isnan(got[4])
        np.testing.assert_array_equal(got[3:] == jax_roots[3:],
                                      [True, False])
    assert np.isnan(jax_roots[4])
    assert np.max(np.abs(root[:3] - jax_roots[:3])) < 2e-3
    assert np.max(np.abs(root[:3] - grid[:3])) < 2e-3


def test_negative_chi2_reports_the_whitened_chi2(records, monkeypatch):
    """A negative chi^2 from the anchored final solve is replaced by the
    whitened chi^2 at the returned root (JAX ops/fit.py:146-153), computed
    here by the JAX package's whitening on the same statistics, and the
    record is counted."""
    maxl, values, errors, A, mats = records
    R = mats["0thorder"]
    solve_anchor = tfit.final_solve_anchor

    def negative(*args):
        C, dC, chi2 = solve_anchor(*args)
        return C, dC, -1.0 - chi2

    monkeypatch.setattr(tfit, "final_solve_anchor", negative)
    reports = tfit.negative_chi2_reports
    _, _, chi2, rp = (t.numpy() for t in fit_records(
        values, errors, A, R, device="cpu"))
    AtWA, AtWb, btWb, _ = (x.numpy() for x in tsolve.suff_stats(
        *(torch.as_tensor(x, dtype=torch.float64) for x in (A, values, errors))))
    for r in range(10):
        lam, Q, Binv = jsolve.whiten_pencil(jnp.asarray(AtWA[r]),
                                            jnp.asarray(R[0]))
        u = Q.T @ (Binv @ jnp.asarray(AtWb[r]))
        m, k = jsolve.pow10_split(jnp.asarray(np.log10(rp[r, 0])))
        want = float(jsolve.whitened_chi2_split(m, k, lam, u,
                                                jnp.asarray(btWb[r])))
        assert chi2[r] > 0
        assert abs(chi2[r] - want) <= 1e-9 * want, (r, chi2[r], want)
    assert np.isnan(chi2[11])
    # counted: every record but the NaN-filled no-bracket one
    assert tfit.negative_chi2_reports - reports == 11
