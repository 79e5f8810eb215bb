"""PyTorch port at BASELINE config 3, the lmax=10 x 12 radial basis
(tests/test_highorder.py's HI_CFG: MAXK=12, MAXL=10, QUAD_MODE = gauss,
nbasis 1200), against the JAX package on the CPU in float64.

The basis, psi and the grid evaluator run through both packages here.  At
this order the JAX package's float64 fits, lambda sweep and sweep take
minutes a call on a CPU (its eigendecompositions run the deflation ladder
at n = 1200), so those tests hold the port against the JAX package's CPU
float64 outputs for the same inputs, made by scripts/window_oracle.py
(tags highorder_exact, highorder_exact_tail, highorder_fast,
highorder_gcv, highorder_exact_grid, highorder_lobo, highorder_sweep) and
stored under tests/oracle: the fits and the sweep on the first records of
the seed-1 day (scripts/day_check.py's: 580 points, 20 beams, 3% NaN) and
on the first records of its last 128-record chunk,
fed the oracles' own QC'd bytes (tests/oracle/day1000_seed1_timeaxis.npz).
At 580 points against 1200 basis functions every record is
underdetermined, and the exact search's roots sit on a cutoff staircase:
the fits are held in chi2 and the W-weighted field, and in alpha only
where the search is smooth in its statistics (fast)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from volumetricinterp_tpu import coords as jcoords
from volumetricinterp_tpu.config import Config as JConfig
from volumetricinterp_tpu.models.sphharmlag import Model as JModel
from volumetricinterp_tpu.ops.grid_eval import GridEvaluator as JEval

from volumetricinterp_tpu_torch.config import Config as TConfig
from volumetricinterp_tpu_torch.io.amisr import beam_indices, qc_datasets
from volumetricinterp_tpu_torch.io.synth import synthetic_amisr_datasets
from volumetricinterp_tpu_torch.models.sphharmlag import Model as TModel
from volumetricinterp_tpu_torch.ops import grid_eval_cuda, solve
from volumetricinterp_tpu_torch.ops.fit import fit_records
from volumetricinterp_tpu_torch.ops.grid_eval import GridEvaluator
from volumetricinterp_tpu_torch.sweep import lobo_cv

from tests.oracle import oracle_basis
from tests.test_highorder import HI_CFG

ORACLE = Path(__file__).resolve().parent / "oracle"
NREC = 4  # the oracles' first records
TAIL = 896  # the first record of the day's last chunk (highorder_exact_tail)
PROD_CFG = HI_CFG.replace("MAXK = 12", "MAXK = 4").replace("MAXL = 10",
                                                           "MAXL = 6")


def _pair():
    """A fresh (JAX, port) model pair: a model's Legendre tables widen
    their domain with the points they have seen, so each test takes its
    own, as tests/test_highorder.py does."""
    return JModel(JConfig.from_text(HI_CFG)), TModel(TConfig.from_text(HI_CFG))


@pytest.fixture(scope="module")
def day():
    """The seed-1 day's geometry and beams (those of its first records are
    the 1000-record day's) and the oracles' QC'd value and error of its
    first NREC records."""
    data = synthetic_amisr_datasets(
        nrec=NREC, seed=1, nan_frac=0.03, bad_frac=0.01,
        smooth_in_model=TModel(TConfig.from_text(PROD_CFG)))
    _, lat, lon, alt, _, _ = qc_datasets(data, "dens", [1e10, 1e13],
                                         [0.1, 10.0], [1, 2, 3, 4])
    o = np.load(ORACLE / "day1000_seed1_timeaxis.npz")
    return dict(lat=lat, lon=lon, alt=alt, bidx=beam_indices(data),
                values=o["value"][:NREC], errors=o["error"][:NREC],
                tail_values=o["value"][TAIL:TAIL + NREC],
                tail_errors=o["error"][TAIL:TAIL + NREC])


def _wfield(A, C, C_ref, values, errors):
    """W-weighted field residual |sw A (C - C_ref)| / |sw A C_ref| per
    record (docs/PARITY_NOTES.md #7)."""
    ok = np.isfinite(values)
    sw = ok / np.where(ok, errors, 1.0)
    return (np.linalg.norm(sw * ((C - C_ref) @ A.T), axis=1)
            / np.linalg.norm(sw * (C_ref @ A.T), axis=1))


def _env():
    """A child's environment: 8 intra-op threads, none of the caller's
    OpenMP or MKL settings, the repository on the path."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("OMP_", "MKL_"))}
    env.update(OMP_NUM_THREADS="8", PYTHONPATH=str(ORACLE.parent.parent))
    return env


def _held(C, chi2, rp, mode, A, values, errors, chi2_tol, wf_tol, start=0):
    """A fit of n records (of values and errors, NREC or fewer) against its
    oracle's first n: the NaN set, no negative chi2, chi2 and the
    W-weighted field within their bars; returns |dlog10 alpha|.  ``start``:
    the records are the day's from there (the oracle's rows begin
    there)."""
    o = np.load(ORACLE / f"day1000_seed1_highorder_{mode}.npz")
    n = len(chi2)
    assert int(o["start"] if "start" in o else 0) == start
    np.testing.assert_array_equal(np.isnan(chi2), np.isnan(o["chi2"][:n]))
    ok = ~np.isnan(chi2)
    assert (chi2[ok] >= 0).all()
    rel = np.abs(chi2 - o["chi2"][:n]) / o["chi2"][:n]
    wf = _wfield(A, C, o["C"][:n], values[:n], errors[:n])
    assert np.nanmax(rel) <= chi2_tol, rel
    assert np.nanmax(wf) <= wf_tol, wf
    return np.abs(np.log10(rp[ok, 0]) - np.log10(o["reg"][:n][ok, 0]))


def test_basis_and_psi_match_jax_and_oracle(day):
    """nbasis 1200: the host design matrix at tests/test_highorder.py's 50
    points and at the day's 580, and psi, equal to the JAX package's (the
    same float64 arithmetic, bit for bit); the basis within 2e-7 of each
    column's sup of the NumPy oracle where scipy does not underflow
    (docs/PARITY_NOTES.md #2: nu up to ~166), the JAX test's bar."""
    jm, tm = _pair()
    rng = np.random.default_rng(5)
    pts = (rng.uniform(74, 82, 50), rng.uniform(252, 272, 50),
           rng.uniform(1e5, 6e5, 50))
    assert tm.nbasis == 12 * 100
    A = tm.basis(*pts)
    np.testing.assert_array_equal(A, np.asarray(jm.basis(*pts)))
    pts_day = (day["lat"], day["lon"], day["alt"])
    np.testing.assert_array_equal(tm.basis(*pts_day),
                                  np.asarray(jm.basis(*pts_day)))
    np.testing.assert_array_equal(tm.eval_psi(), np.asarray(jm.eval_psi()))
    Aref = oracle_basis(12, 10, 10.0, 78.0, 262.0, *pts)
    sup = np.abs(Aref).max(0)
    live = sup > 0
    assert live.sum() > 1000
    err = np.abs(A - Aref).max(0)[live] / sup[live]
    assert err.max() < 2e-7


def test_fast_fit_matches_jax(day):
    """'fast' on the NREC records against the JAX package's fast fit of
    them: chi2 within 2e-2 relative and the W-weighted field within 1e-2
    (measured 2.2e-3 and 1.1e-3 at most: the final solve keeps or drops
    modes at the gelsd cutoff at a condition number of ~1e17), and alpha
    within 1e-6 decades (the whitened pencil's root is smooth in the
    statistics: measured 3.1e-8)."""
    _, tm = _pair()
    A = tm.basis(day["lat"], day["lon"], day["alt"])
    C, _, chi2, rp = (x.numpy() for x in fit_records(
        day["values"], day["errors"], A, tm.eval_psi()[None],
        regparam_mode="fast", device="cpu"))
    dla = _held(C, chi2, rp, "fast", A, day["values"], day["errors"], 2e-2,
                1e-2)
    assert dla.max() <= 1e-6


EXACT_CHILD = r"""
import sys
import numpy as np
import torch
from volumetricinterp_tpu_torch.ops.fit import fit_records

d = np.load(sys.argv[1])
nthreads = torch.get_num_threads()
C, _, chi2, rp = fit_records(d["values"], d["errors"], d["A"], d["R"],
                             regparam_mode="exact", device="cpu")
np.savez(sys.argv[2], C=C.numpy(), chi2=chi2.numpy(), rp=rp.numpy(),
         nthreads=nthreads)
"""


def test_exact_fit_finishes_at_default_threads(day, tmp_path):
    """The shipped default, 'exact', on the NREC records in a child process
    at 8 intra-op threads finishes within 60 s (about 6 s here) and lands
    on the JAX package's exact fit: chi2 within 0.1 relative and the
    W-weighted field within 5e-2 (the cutoff staircase moves the roots of
    two correct solvers apart, here by up to 0.52 decades; measured 2.9e-2
    and 1.05e-2 at most).  Before solve.batched_solve, MKL's batched LU of
    the exact search's kept-block solves at n = 1200 reported "Parameter 6
    was incorrect on entry to DLASWP" and never returned, once the host
    pool's workers had called torch.set_num_threads."""
    _, tm = _pair()
    A = tm.basis(day["lat"], day["lon"], day["alt"])
    data, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(data, values=day["values"], errors=day["errors"], A=A,
             R=tm.eval_psi()[None])
    res = subprocess.run([sys.executable, "-c", EXACT_CHILD, str(data),
                          str(out)], capture_output=True, text=True,
                         env=_env(), timeout=60)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "DLASWP" not in res.stderr
    got = np.load(out)
    assert int(got["nthreads"]) == 8
    _held(got["C"], got["chi2"], got["rp"], "exact", A, day["values"],
          day["errors"], 0.1, 5e-2)


def test_tail_exact_fit_matches_jax(day):
    """'exact' on the first NREC records of the day's last chunk (records
    896-899; on the card that chunk holds 104 records padded to 128)
    against the JAX package's exact fit of records 896-999
    (highorder_exact_tail): chi2 within 0.1 relative and the W-weighted
    field within 5e-2, the exact fit's bars above (measured 1.6e-2 and
    6.3e-3 at most; record 897's root 0.24 decades off on the cutoff
    staircase)."""
    _, tm = _pair()
    A = tm.basis(day["lat"], day["lon"], day["alt"])
    C, _, chi2, rp = (x.numpy() for x in fit_records(
        day["tail_values"], day["tail_errors"], A, tm.eval_psi()[None],
        regparam_mode="exact", device="cpu"))
    _held(C, chi2, rp, "exact_tail", A, day["tail_values"],
          day["tail_errors"], 0.1, 5e-2, start=TAIL)


def test_gcv_fit_matches_jax(day):
    """REGULARIZATION_METHOD = gcv in its exact mode on the first two
    records against the JAX package's GCV fit of the day's first 32
    (highorder_gcv): the NaN set, no negative chi2, chi2 within 2e-2
    relative and the W-weighted field within 1e-2, the fast fit's bars
    (measured on the first four: 4.4e-3 and 1.6e-3, the Nelder-Mead
    minima 0.024-0.071 decades apart).  Two records, not four: each
    Nelder-Mead evaluation inverts ten kept blocks of 1200 x 1200 a
    record, ~45 s for two on 8 idle cores."""
    _, tm = _pair()
    A = tm.basis(day["lat"], day["lon"], day["alt"])
    C, _, chi2, rp = (x.numpy() for x in fit_records(
        day["values"][:2], day["errors"][:2], A, tm.eval_psi()[None],
        method="gcv", regparam_mode="exact", device="cpu"))
    _held(C, chi2, rp, "gcv", A, day["values"][:2], day["errors"][:2],
          2e-2, 1e-2)


def test_exact_grid_fit_matches_jax(day):
    """'exact_grid' (the 101-point grid and 40 bisection rounds, 142 host
    eighs of 1200 x 1200 a record) on the first two records against the
    JAX package's exact_grid fit of the day's first 8 (highorder_exact_grid):
    chi2 within 2e-2 relative and the W-weighted field within 1e-2, the
    fast fit's bars (measured 7.2e-4 and 5.7e-4; the roots 1.6e-2 decades
    apart at most)."""
    _, tm = _pair()
    A = tm.basis(day["lat"], day["lon"], day["alt"])
    C, _, chi2, rp = (x.numpy() for x in fit_records(
        day["values"][:2], day["errors"][:2], A, tm.eval_psi()[None],
        regparam_mode="exact_grid", device="cpu"))
    _held(C, chi2, rp, "exact_grid", A, day["values"][:2],
          day["errors"][:2], 2e-2, 1e-2)


BATCHED_CHILD = r"""
import sys
import numpy as np
import torch
from volumetricinterp_tpu_torch.ops import solve

d, out = np.load(sys.argv[1]), {}
if sys.argv[3] == "pool":  # the pool's workers set 1, the caller its count
    solve._host_pool()
    torch.set_num_threads(torch.get_num_threads())
for n in (144, 1200):
    X, B = torch.as_tensor(d[f"X{n}"]), torch.as_tensor(d[f"B{n}"])
    if sys.argv[3] == "plain":
        out[f"x{n}"] = torch.linalg.solve_ex(X, B)[0].numpy()
        out[f"i{n}"] = torch.linalg.inv_ex(X)[0].numpy()
    else:
        out[f"x{n}"] = solve.batched_solve(X, B).numpy()
        out[f"i{n}"] = solve.batched_inv(X).numpy()
np.savez(sys.argv[2], **out)
"""


def test_batched_solve_after_a_thread_count_is_set(tmp_path):
    """solve.batched_solve and batched_inv on the CPU, after the host
    pool's workers and the caller have set their thread counts: the bits
    of torch.linalg's batched calls in a process that never set one, at
    the production order and at nbasis 1200."""
    rng = np.random.default_rng(1)
    arrays = {}
    for n in (144, 1200):
        X = rng.normal(size=(5, n, n))
        arrays[f"X{n}"] = X + X.transpose(0, 2, 1)
        arrays[f"B{n}"] = rng.normal(size=(5, n, 1))
    data = tmp_path / "in.npz"
    np.savez(data, **arrays)
    got = {}
    for how in ("plain", "pool"):
        out = tmp_path / f"{how}.npz"
        res = subprocess.run([sys.executable, "-c", BATCHED_CHILD, str(data),
                              str(out), how], capture_output=True, text=True,
                             env=_env(), timeout=60)
        assert res.returncode == 0, res.stderr[-3000:]
        got[how] = dict(np.load(out))
    for k, x in got["plain"].items():
        np.testing.assert_array_equal(got["pool"][k], x, err_msg=k)


def test_lambda_sweep_matches_jax_and_is_monotone():
    """tests/test_highorder.py's lambda sweep (a fresh model, 800 points,
    W = 1e-21, 15 log10 alphas in [-40, 0]) by solve.cutoff_chi2, the 15
    alphas in one batch: within 1e-6 of the largest value plus 1e-4
    relative of the JAX package's cutoff_chi2 at each alpha (the
    unregularized end of this underdetermined problem is solver noise near
    0, where the two differ by up to 0.39 relative, 2.9e-7 of the largest
    value), and monotone to the JAX test's slack."""
    o = np.load(ORACLE / "highorder_lambda_sweep.npz")
    _, tm = _pair()
    rng = np.random.default_rng(7)
    npts = 800
    lat = rng.uniform(74, 82, npts)
    lon = rng.uniform(252, 272, npts)
    alt = rng.uniform(1e5, 6e5, npts)
    A = torch.as_tensor(tm.basis(lat, lon, alt))
    v = torch.as_tensor(4e11 * np.exp(-(((alt - 3e5) / 1.2e5) ** 2)))
    err = torch.full_like(v, 1e-21 ** -0.5)
    AtWA, AtWb, btWb, _ = (x[0] for x in solve.suff_stats(A, v[None],
                                                          err[None]))
    a = torch.as_tensor(10.0 ** o["log10_alphas"])[:, None, None]
    vals = solve.cutoff_chi2(a, AtWA, AtWb, btWb,
                             torch.as_tensor(tm.eval_psi())).numpy()
    ref = o["chi2"]
    assert np.all(np.abs(vals - ref) <= 1e-6 * ref.max() + 1e-4 * ref)
    floor = 1e-6 * max(vals)
    assert all(b >= a - abs(a) * 0.02 - floor
               for a, b in zip(vals, vals[1:]))


def test_grid_evaluator_matches_jax():
    """GridEvaluator at (maxl, maxk) = (10, 12), 55 pairs, degree 28, on
    2,048 points of the FoV's box: the float64 twin within 1e-9 of the sup
    of the JAX package's XLA float64 evaluator (measured 1.4e-13), the
    float32 twin (what the card's kernel is held against) within 5e-5
    (measured 3.0e-5), the same NaN set; one kernel launch would take the
    8 records (record_chunks), at one point a thread."""
    jm, tm = _pair()
    rng = np.random.default_rng(9)
    n = 2048
    lat = rng.uniform(74, 82, n)
    lon = rng.uniform(252, 272, n)
    alt = rng.uniform(1e5, 6e5, n)
    _, t, _ = jcoords.np_geodetic_to_cap(lat, lon, alt, 78.0, 262.0)
    band = (t.min(), t.max())
    C = rng.normal(size=(2, tm.nbasis)) * 1e11
    jev = JEval(jm, band, impl="xla", dtype=jnp.float64, tol=1e-13)
    ref = np.stack([np.asarray(jev(c, lat, lon, alt)) for c in C])
    ev64 = GridEvaluator(tm, band, dtype=torch.float64, tol=1e-13,
                         device="cpu")
    ev32 = GridEvaluator(tm, band, device="cpu")
    assert (ev32.npairs, ev32.degree) == (55, 28)
    ok = np.isfinite(ref)
    sup = np.abs(ref[ok]).max()
    for ev, tol in ((ev64, 1e-9), (ev32, 5e-5)):
        out = ev.eval_records(C, lat, lon, alt).numpy()
        np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
        assert np.abs(out[ok] - ref[ok]).max() <= tol * sup
    cfg = grid_eval_cuda.kernel_config(10, 12)
    assert cfg.pt == 1
    assert len(grid_eval_cuda.record_chunks(cfg, ev32.degree, 8)) == 1


def test_lobo_matches_jax(day):
    """lobo_cv at (10, 12) on the first record, all 20 beams, at two of
    the oracle's log10 alphas, against the JAX package's lobo_cv of the
    same bytes.  At -22 every entry within 1e-3 relative (measured
    2.0e-4).  At -25, near the exact fits' roots (-25.45 .. -23.65 on the
    oracle's first records), the leave-one-out systems keep modes within a
    few eps of the gelsd cutoff, where two LAPACK builds keep or scale a
    mode differently (tests/test_torch_sweep.py): the median entry within
    2e-2 (measured 6.9e-3; two entries move 0.31 and 0.17)."""
    o = np.load(ORACLE / "day1000_seed1_highorder_lobo.npz")
    la = [-25.0, -22.0]
    cols = [list(o["alphas"]).index(a) for a in la]
    _, tm = _pair()
    A = tm.basis(day["lat"], day["lon"], day["alt"])
    _, per = lobo_cv(day["values"][:1], day["errors"][:1], A, day["bidx"],
                     tm.eval_psi(), la, device="cpu")
    ref = o["per"][:1][..., cols]
    rel = np.abs(per - ref) / np.abs(ref)
    assert per.shape == (1, 20, 2)
    assert rel[..., 1].max() <= 1e-3, rel
    assert np.median(rel[..., 0]) <= 2e-2, rel
