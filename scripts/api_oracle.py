#!/usr/bin/env python
"""Build tests/oracle/api_surface_oracle.npz: the NumPy/SciPy oracle's GCV
regularization parameter of chip_smoke.py's reference-API problem
(chip_smoke.api_problem: 580 points, nbasis 144, seed 12).

The search is tests/oracle/ref_impl.py's oracle_gcv_param: scipy's
Nelder-Mead from log10 alpha = -20 over the sum of W-weighted squared
residuals of brute-force leave-one-out refits, each refit an
oracle_eval_C call.  One objective call is 580 refits at 144 x 144, ~0.5 s
each on one core, so this script spreads each call's refits over worker
processes (the same refits, summed in the same order); the search still
takes tens of minutes, which is why chip_smoke.py phase 10 reads the stored
root instead of running it on the card's host.  The cheap oracles
(oracle_eval_C, oracle_chi2_param, _chi2_of) run live there.  The file also
stores the SHA-1 of the problem's bytes, which phase 10 compares with the
problem it regenerates from the seed.

Usage:  python scripts/api_oracle.py [workers]   (NumPy/SciPy; no JAX)
"""
import multiprocessing
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

_ref = _prob = None


def _init():
    global _ref, _prob
    _ref = cs.oracle_module()
    _prob = cs.api_problem()


def _loo_term(args):
    """The i-th term of oracle_gcv_param's objective at 10^a_log."""
    a_log, i = args
    A0, b0, W0, R = _prob
    A, b, W = (np.delete(x, i, 0) for x in (A0, b0, W0))
    C = _ref.oracle_eval_C(A, b, W, [R], [10.0 ** a_log])
    return (float(A0[i] @ C) - b0[i]) ** 2 * W0[i]


def main():
    import scipy.optimize

    workers = int(sys.argv[1]) if len(sys.argv) > 1 else os.cpu_count()
    A, b, W, R = cs.api_problem()
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    calls = []
    with ctx.Pool(workers, initializer=_init) as pool:
        def obj(alpha_log):
            a_log = float(np.asarray(alpha_log).reshape(-1)[0])
            terms = pool.map(_loo_term, [(a_log, i) for i in range(len(b))])
            calls.append(a_log)
            return sum(terms)

        sol = scipy.optimize.minimize(obj, -20.0, method="Nelder-Mead")
    secs = time.perf_counter() - t0
    gcv = 10.0 ** sol.x[0] if sol.success else np.nan
    out = ROOT / "tests" / "oracle" / "api_surface_oracle.npz"
    np.savez(out, gcv=gcv, digest=cs.api_digest(A, b, W, R))
    print(f"{out.name}: oracle_gcv_param = {gcv!r} (log10 {sol.x[0]:.6f}, "
          f"{len(calls)} objective calls) in {secs:.1f} s on {workers} "
          f"processes")


if __name__ == "__main__":
    main()
