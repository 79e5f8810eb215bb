#!/usr/bin/env python
"""The spread of the leave-one-beam-out scores between correct solvers.

The sweep's held-out chi2 (volumetricinterp_tpu_torch/sweep.py) at the
production order (MAXK=4, MAXL=6) on the first 64 records of the seed-1
day, over the oracle's 9 log10 alphas, computed three ways on this host
in float64 from the same statistics: the port as shipped (its
decompositions by solve.host_eigh, LAPACK syevd, the routine of the JAX
package's CPU eigh), the port with solve.host_eigh swapped for
scipy.linalg.eigh(driver='evr') (MRRR, another LAPACK algorithm), and the
JAX package (tests/oracle/day1000_seed1_lobo.npz, scripts/window_oracle.py
lobo).  Prints, per alpha, the median and max per-entry relative
difference and the summed-score relative difference of each pair, and the
order sweep's scores and argmin against the oracle's.  The port's syevd
against the oracle's (one routine, the statistics formed by two packages)
sets chip_smoke phase 7's bars; evr against syevd shows how far a second
correct algorithm lands from the same statistics, where the leave-one-out
systems at small alpha carry modes at the gelsd cutoff.

Usage:  python scripts/lobo_spread.py    (CPU, about two minutes on 8 cores)
"""
import contextlib
import sys
import time
from pathlib import Path

import numpy as np
import scipy.linalg
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from volumetricinterp_tpu_torch.config import Config  # noqa: E402
from volumetricinterp_tpu_torch.io.amisr import beam_indices  # noqa: E402
from volumetricinterp_tpu_torch.io.amisr import qc_datasets  # noqa: E402
from volumetricinterp_tpu_torch.io.synth import synthetic_amisr_datasets  # noqa: E402
from volumetricinterp_tpu_torch.models.sphharmlag import Model  # noqa: E402
from volumetricinterp_tpu_torch.ops import solve  # noqa: E402
from volumetricinterp_tpu_torch import sweep  # noqa: E402


def evr_eigh(X):
    """solve.host_eigh by scipy's MRRR routine, matrix by matrix (X on the
    CPU)."""
    Xn = X.numpy().reshape((-1,) + X.shape[-2:])
    w, V = zip(*(scipy.linalg.eigh(x, driver="evr") for x in Xn))
    return (torch.as_tensor(np.stack(w)).reshape(X.shape[:-1]),
            torch.as_tensor(np.stack(V)).reshape(X.shape))


@contextlib.contextmanager
def evr():
    """The sweep's decompositions by evr_eigh: solve.normalized_eigh looks
    its default, solve.host_eigh, up at each call."""
    shipped = solve.host_eigh
    solve.host_eigh = evr_eigh
    try:
        yield
    finally:
        solve.host_eigh = shipped


def stats(a, b):
    rel = np.abs(a - b) / np.abs(b)
    return np.median(rel, axis=(0, 1)), rel.max(axis=(0, 1)), \
        np.abs(a.sum((0, 1)) - b.sum((0, 1))) / np.abs(b.sum((0, 1)))


def main():
    o = np.load(ROOT / "tests" / "oracle" / "day1000_seed1_lobo.npz")
    la = [float(a) for a in o["alphas"]]
    model = Model(Config.from_text(cs.MODEL_CFG))
    d = synthetic_amisr_datasets(smooth_in_model=model, **cs.DAY)
    _, lat, lon, alt, v, e = qc_datasets(d, "dens", [1e10, 1e13], [0.1, 10.0],
                                         [1, 2, 3, 4])
    bidx = beam_indices(d)
    v, e = v[:cs.LOBO_NREC], e[:cs.LOBO_NREC]
    A, R = model.basis(lat, lon, alt), model.eval_psi()
    t0 = time.perf_counter()
    _, torch_per = sweep.lobo_cv(v, e, A, bidx, R, la, device="cpu")
    t1 = time.perf_counter()
    with evr():
        _, evr_per = sweep.lobo_cv(v, e, A, bidx, R, la, device="cpu")
    print(f"host_eigh (syevd) {t1 - t0:.1f} s, evr "
          f"{time.perf_counter() - t1:.1f} s")
    pairs = {"port (host_eigh, syevd) vs oracle": (torch_per, o["per"]),
             "port(evr) vs oracle": (evr_per, o["per"]),
             "port vs port(evr)": (torch_per, evr_per)}
    for name, (a, b) in pairs.items():
        med, mx, summed = stats(a, b)
        print(f"{name}: all entries median {np.median(np.abs(a - b) / np.abs(b)):.4e}")
        for i, al in enumerate(la):
            print(f"  log10 alpha {al:6.1f}: median {med[i]:.4e} max "
                  f"{mx[i]:.4e} summed {summed[i]:.4e}")
    orders = [tuple(int(x) for x in oi) for oi in o["orders"]]
    res = sweep.order_sweep(cs.MODEL_CFG, v, e, lat, lon, alt, bidx, orders,
                            la, device="cpu")
    with evr():
        res_evr = sweep.order_sweep(cs.MODEL_CFG, v, e, lat, lon, alt, bidx,
                                    orders, la, device="cpu")
    for name, sc, ref in (
            ("port (host_eigh, syevd) vs oracle", res["scores"], o["scores"]),
            ("port(evr) vs oracle", res_evr["scores"], o["scores"]),
            ("port vs port(evr)", res["scores"], res_evr["scores"])):
        rel = np.abs(sc - ref) / np.abs(ref)
        print(f"order sweep, {name}: summed-score relative difference, max "
              f"over alphas by order: "
              f"{dict(zip(orders, rel.max(1).round(6).tolist()))}")
    print(f"argmin: port {res['best_order']} {res['best_log10_alpha']}, "
          f"port(evr) {res_evr['best_order']} {res_evr['best_log10_alpha']}, "
          f"oracle {tuple(o['best_order'])} {float(o['best_log10_alpha'])}")


if __name__ == "__main__":
    main()
