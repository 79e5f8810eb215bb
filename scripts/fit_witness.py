#!/usr/bin/env python3
"""The port's production-order fits on the card and on a CPU, side by side.

    python3 scripts/fit_witness.py card OUT.npz   # on a CUDA machine
    python3 scripts/fit_witness.py cpu OUT.npz    # then on a CPU, same file

chip_smoke.py holds each fit setting against the JAX package's CPU float64
oracle.  This script tells apart where a card run and a CPU run of the same
port part: in the search's alpha, or in the solve at a given alpha, and
which of the exact search's eigendecompositions decides it.  Both stages
fit through chip_smoke.fit_day, the code phases 4b and 4c run, on the
in-memory synthetic day, so the inputs are the same bytes on both sides.

The exact search decomposes four matrices a record: AtWA (``atwa``,
ops/fit.atwa_eig), the whitened pencil (``pencil``, solve.whiten_pencil)
and two M-shift anchors (``anchors``, regparam.chi2_reg_param).  The card
stage fits exact (the shipped default) over the whole seed-1, -2 and -3
day once for each PLACEMENTS entry: every eigendecomposition on the card
(``card``), one of the three sites in LAPACK float64 on the host
(solve.host_eigh, results copied back), or all three (``all``); then fast
and gcv (exact) over the seed-1 64-record window, as shipped.  It stores
chi2, alpha and C of each, with the card's nvidia-smi name and power limit,
and prints fit_records seconds and host_eigh against torch.linalg.eigh on
the card for one record chunk.  The cpu stage fits the same settings on
the CPU (where every placement is the host) and prints, per setting:
  * card and CPU against the JAX oracles: the NaN set and chi2 relative to
    tests/oracle/day1000_seed{1,2,3}_oracle.npz (scripts/day_check.py
    --oracle --seed N), and, for seed 1, the W-weighted field of the
    first 64 records against the setting's window oracle;
  * card against CPU: chi2 relative, W-weighted field over every record,
    |dlog10 alpha|;
  * for exact with every eigendecomposition on the card: solve.final_solve
    (a fresh eigendecomposition at the given alpha) at the card's own
    alphas, run on the card (card stage) and on the CPU, against each
    other (the solve alone, card against CPU at equal alpha), and the
    CPU's against the card's own anchored solve.
Medians and maxima leave out NaN records; "field" is chip_smoke.wfield.
"""

import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from volumetricinterp_tpu_torch.ops import fit as ops_fit  # noqa: E402
from volumetricinterp_tpu_torch.ops import regparam, solve  # noqa: E402

cs.HAVE_H5PY = False  # the in-memory day on both sides
SEEDS = (1, 2, 3)
NWIN = 64
# the exact search's eigendecompositions placed on the host, by setting
PLACEMENTS = {"card": (), "atwa": ("atwa",), "pencil": ("pencil",),
              "anchors": ("anchors",), "all": ("atwa", "pencil", "anchors")}
# (key, method, mode, seed, records, placement); None: the shipped code
SETTINGS = [(f"exact_seed{s}_{p}", "chi2", "exact", s, None, p)
            for s in SEEDS for p in PLACEMENTS]
SETTINGS += [("fast", "chi2", "fast", 1, NWIN, None),
             ("gcv", "gcv", "exact", 1, NWIN, None)]


@contextlib.contextmanager
def placed(sites):
    """The exact search with the eigendecompositions of ``sites`` on the
    host (solve.host_eigh) and every other one on the card."""
    atwa, whiten, anchors = (ops_fit.atwa_eig, regparam.whiten_pencil,
                             regparam.normalized_eigh)

    def pencil_on_host(R, eig_AtWA):
        eigh, solve.eigh = solve.eigh, solve.host_eigh
        try:
            return whiten(R, eig_AtWA)
        finally:
            solve.eigh = eigh

    ops_fit.atwa_eig = (atwa if "atwa" in sites
                        else lambda X: solve.normalized_eigh(X))
    if "pencil" in sites:
        regparam.whiten_pencil = pencil_on_host
    if "anchors" in sites:
        regparam.normalized_eigh = (
            lambda X: solve.normalized_eigh(X, solve.host_eigh))
    try:
        yield
    finally:
        ops_fit.atwa_eig, regparam.whiten_pencil = atwa, whiten
        regparam.normalized_eigh = anchors


def run(device):
    """Fit every setting on ``device``; returns {key: fit dict}."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, method, mode, seed, nwin, placement in SETTINGS:
            if device == "cpu" and placement not in (None, "atwa"):
                continue  # on the CPU every placement is the host
            day = dict(cs.DAY, seed=seed)
            sites = PLACEMENTS.get(placement, ("atwa",))
            with placed(sites):
                out[key] = cs.fit_day(Path(tmp), device, method, mode, nwin,
                                      day)
            print(f"{key}: {out[key]['fit_rec_s']:.3f} s of fit_records, "
                  f"{int(np.isnan(out[key]['chi2']).sum())} NaN",
                  flush=True)
    return out


def eigh_seconds(batch=128, reps=3):
    """(torch.linalg.eigh on the card, solve.host_eigh) seconds for one
    record chunk of random 144x144 float64 SPD matrices."""
    g = torch.randn(batch, 144, 600, dtype=torch.float64, device="cuda")
    X = g @ g.transpose(-1, -2)
    out = []
    for f in (torch.linalg.eigh, solve.host_eigh):
        f(X)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            f(X)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / reps)
    return out


def stage_card(path):
    cs.phase_device()
    card_s, host_s = eigh_seconds()
    print(f"one 128-record chunk of AtWA: torch.linalg.eigh on the card "
          f"{card_s:.4f} s, solve.host_eigh ({solve.HOST_EIGH_THREADS} "
          f"threads) {host_s:.4f} s", flush=True)
    fits = run("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    arrays = {f"{k}_{f}": np.asarray(v[f]) for k, v in fits.items()
              for f in ("C", "chi2", "reg")}
    for key, method, mode, _, _, placement in SETTINGS:
        if placement == "card":
            arrays[f"{key}_C_at"], arrays[f"{key}_chi2_at"] = at_alphas(
                fits[key], fits[key]["reg"], "cuda")
    np.savez_compressed(path, card=smi.splitlines()[0], **arrays)
    print(f"wrote {path}")


def stats(v):
    v = np.asarray(v)[np.isfinite(v)]
    return f"median {np.median(v):.4e} max {v.max():.4e}"


def field(fit, C, C_ref):
    """chip_smoke.wfield of C against C_ref over every record of fit."""
    return cs.wfield(dict(fit, C=C), C_ref, len(C_ref))


def log_alphas(reg):
    """The card's RAW alphas as the LOG10 alphas fit_records searched."""
    with np.errstate(divide="ignore"):
        return np.log10(reg)


def at_alphas(fit, reg, device):
    """solve.final_solve of fit's records at the given RAW alphas on
    ``device``: host (C, chi2), NaN where the alpha is NaN."""
    interp = fit["interp"]
    _, lat, lon, alt, value, error = interp.read_datafile(interp.filename)
    n = len(reg)
    dev = lambda x: torch.as_tensor(x, dtype=torch.float64, device=device)  # noqa: E731
    A = dev(interp.model.basis(lat, lon, alt))
    R = dev(np.stack([interp._reg_matrices()[r]
                      for r in interp.regularization_list]))
    la = dev(log_alphas(reg))[:, None]
    Cs, chi2s = [], []
    for s in range(0, n, 128):
        AtWA, AtWb, btWb, _ = solve.suff_stats(
            A, dev(value[s:s + 128]), dev(error[s:s + 128]))
        C, _, chi2 = solve.final_solve(AtWA, AtWb, btWb, R, la[s:s + 128])
        Cs.append(C.cpu().numpy())
        chi2s.append(chi2.cpu().numpy())
    C, chi2 = np.concatenate(Cs), np.concatenate(chi2s)
    bad = np.isnan(reg)
    C[bad], chi2[bad] = np.nan, np.nan
    return C, chi2


def stage_cpu(path):
    card = np.load(path)
    print(f"card: {card['card']}; CPU: {torch.get_num_threads()} threads")
    cpu = run("cpu")
    report = {}
    for key, method, mode, seed, nwin, placement in SETTINGS:
        ref = cpu[f"exact_seed{seed}_atwa" if placement else key]
        c = {f: card[f"{key}_{f}"] for f in ("C", "chi2", "reg")}
        n = len(c["chi2"])
        lines = {}
        sides = [("card", c["C"], c["chi2"], c["reg"])]
        if placement in (None, "atwa"):
            sides.append(("cpu", ref["C"], ref["chi2"], ref["reg"]))
        for side, C, chi2, reg in sides:
            if n == 1000:
                o = cs.day_oracle(seed)
                nan, nan_o = np.isnan(chi2), np.isnan(o["chi2"])
                lines[f"{side} vs oracle: NaN records, {side} / oracle / "
                      "both"] = (f"{nan.sum()} / {nan_o.sum()} / "
                                 f"{(nan & nan_o).sum()}")
                lines[f"{side} vs oracle: chi2 rel"] = stats(
                    np.abs(chi2 - o["chi2"]) / o["chi2"])
                lines[f"{side} vs oracle: |dlog10 alpha|"] = stats(
                    cs.dlog10(reg, o["reg"][:, 0]))
                lines[f"{side}: negative chi2"] = int((chi2 < 0).sum())
            if seed == 1:
                tag = "exact" if mode == "exact" and method == "chi2" else key
                C_o, _, reg_o = cs.window_oracle(tag, NWIN)
                lines[f"{side} vs oracle: field, first {NWIN}"] = stats(
                    field(ref, C[:NWIN], C_o))
        lines["card vs cpu: chi2 rel"] = stats(
            np.abs(c["chi2"] - ref["chi2"]) / ref["chi2"])
        lines["card vs cpu: field"] = stats(field(ref, c["C"], ref["C"]))
        lines["card vs cpu: |dlog10 alpha|"] = stats(
            cs.dlog10(c["reg"], ref["reg"]))
        nan_c, nan_x = np.isnan(c["chi2"]), np.isnan(ref["chi2"])
        lines["NaN records, card / cpu / both"] = (
            f"{nan_c.sum()} / {nan_x.sum()} / {(nan_c & nan_x).sum()}")
        if placement == "card":
            C_x, chi2_x = at_alphas(ref, c["reg"], "cpu")
            C_at, chi2_at = card[f"{key}_C_at"], card[f"{key}_chi2_at"]
            lines["final_solve at card alphas, card vs cpu: chi2 rel"] = stats(
                np.abs(chi2_at - chi2_x) / chi2_x)
            lines["final_solve at card alphas, card vs cpu: field"] = stats(
                field(ref, C_at, C_x))
            lines["cpu final_solve at card alphas vs card fit: chi2 rel"] = \
                stats(np.abs(c["chi2"] - chi2_x) / chi2_x)
        report[key] = lines
        print(f"\n{key} ({method}, {mode}, seed {seed}, {n} records):")
        for k, v in lines.items():
            print(f"  {k}: {v}")
    return report


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] not in ("card", "cpu"):
        sys.exit(__doc__)
    if sys.argv[1] == "card":
        stage_card(sys.argv[2])
    else:
        print(json.dumps(stage_cpu(sys.argv[2])))
