#!/usr/bin/env python3
"""The jointly time-regularized solve on the card against its JAX CPU
float64 oracle, with the block Thomas inverses computed in turn by each
candidate.

    python3 scripts/joint_witness.py        # on a CUDA machine

chip_smoke.py phase 4e feeds ops/timejoint.joint_time_solve the
statistics of the day stored in tests/oracle/day1000_seed1_timeaxis.npz
and the oracle's alphas, and holds the joint coefficients to the
oracle's in the W-weighted field.  This script takes the same
inputs (the statistics of the oracle's stored day, in float64 on the
host) and runs the solve on the card with each record's 144x144 inverse
from: torch.linalg.inv_ex on the card (the shipped code), a Cholesky
inverse on the card, torch.linalg.solve against the identity on the card,
and torch.linalg.inv_ex on the host; and the whole solve on the host.
For each it prints the W-weighted field max and median against the
oracle, and the seconds; then the largest relative difference between
the card's and the host's inverse of the same S_r matrices, and between
this machine's synthetic day and the oracle's.
"""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from volumetricinterp_tpu_torch.config import Config  # noqa: E402
from volumetricinterp_tpu_torch.io.amisr import qc_datasets  # noqa: E402
from volumetricinterp_tpu_torch.io.synth import synthetic_amisr_datasets  # noqa: E402
from volumetricinterp_tpu_torch.models.sphharmlag import Model  # noqa: E402
from volumetricinterp_tpu_torch.ops import timejoint  # noqa: E402


def cholesky_inv(S):
    return torch.cholesky_inverse(torch.linalg.cholesky(S)), None


def solve_inv(S):
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    return torch.linalg.solve(S, eye), None


def host_inv(S):
    return torch.linalg.inv(S.cpu()).to(S.device), None


def main():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    text = cs.FIT_CFG.format(raw="day", out="", method="chi2", mode="exact",
                             extra=cs.TIME_AXIS_CFG)
    model = Model(Config.from_text(text))
    data = synthetic_amisr_datasets(smooth_in_model=model, **cs.DAY)
    _, lat, lon, alt, value, error = qc_datasets(
        data, "dens", [1e10, 1e13], [0.1, 10.0], [1, 2, 3, 4])
    A = model.basis(lat, lon, alt)
    o = np.load(ROOT / "tests" / "oracle" / "day1000_seed1_timeaxis.npz")
    ok = np.isfinite(value)
    sw = ok / np.where(ok, error, 1.0)
    ref = o["C_joint"]

    def field(C):
        wf = (np.linalg.norm(sw * ((C - ref) @ A.T), axis=1)
              / np.linalg.norm(sw * (ref @ A.T), axis=1))
        return f"field max {wf.max():.4e} median {np.median(wf):.4e}"

    with np.errstate(invalid="ignore"):
        print(f"this machine's day against the oracle's: values within "
              f"{np.nanmax(np.abs(value - o['value']) / np.abs(o['value'])):.3e} "
              f"relative", flush=True)
    host = [torch.as_tensor(x, dtype=torch.float64)
            for x in (o["value"], o["error"], A)]
    AtWA, AtWb = timejoint.time_stats(*host)
    with np.errstate(divide="ignore"):
        la = torch.as_tensor(np.log10(np.where(o["reg"] > 0, o["reg"], 0.0)))
    R = torch.as_tensor(model.eval_psi()[None])
    inv = torch.linalg.inv_ex
    for label, device, f in (("card, inv_ex (shipped)", "cuda", inv),
                             ("card, Cholesky inverse", "cuda", cholesky_inv),
                             ("card, solve(S, I)", "cuda", solve_inv),
                             ("card, inverses on the host", "cuda", host_inv),
                             ("host, inv_ex", "cpu", inv)):
        torch.linalg.inv_ex = f
        try:
            args = [x.to(device) for x in (AtWA, AtWb, R, la)]
            t0 = time.perf_counter()
            C = timejoint.joint_time_solve(*args, 1e-4).cpu().numpy()
            secs = time.perf_counter() - t0
        finally:
            torch.linalg.inv_ex = inv
        print(f"{label}: {field(C)}, {secs:.3f} s", flush=True)
    # one record's inverse on both sides
    s = torch.diagonal(AtWA, dim1=-2, dim2=-1).sum(-1).mean() / AtWA.shape[-1]
    D = AtWA[:8] / s + 2.0001e-4 * torch.eye(AtWA.shape[-1], dtype=AtWA.dtype)
    card = torch.linalg.inv_ex(D.cuda())[0].cpu()
    cpu = torch.linalg.inv_ex(D)[0]
    print(f"inverse of 8 diagonal blocks, card against host: max relative "
          f"{float(((card - cpu).abs().amax((-2, -1)) / cpu.abs().amax((-2, -1))).max()):.4e}; "
          f"condition numbers {torch.linalg.cond(D).min():.3e}.."
          f"{torch.linalg.cond(D).max():.3e}", flush=True)


if __name__ == "__main__":
    main()
