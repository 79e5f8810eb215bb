#!/usr/bin/env python3
"""The port's production-order fits on the card and on a CPU, side by side.

    python3 scripts/fit_witness.py card OUT.npz   # on a CUDA machine
    python3 scripts/fit_witness.py cpu OUT.npz    # then on a CPU, same file

chip_smoke.py holds each fit setting against the JAX package's CPU float64
oracle.  This script tells apart where a card run and a CPU run of the same
port part: in the search's alpha, or in the solve at a given alpha.  Both
stages fit through chip_smoke.fit_day, the code phases 4b and 4c run, on the
in-memory synthetic day, so the inputs are the same bytes on both sides.

The card stage fits:
  * exact (the shipped default) over the whole seed-1, -2 and -3 day;
  * exact over the same days again with every eigendecomposition computed
    on the host CPU and copied back (``host eigh``; all else on the card);
  * fast and gcv (exact) over the seed-1 64-record window;
and stores chi2, alpha and C of each, with the card's nvidia-smi name and
power limit.  The cpu stage fits the same settings on the CPU (``host
eigh`` is the CPU fit itself there) and prints, per setting:
  * card and CPU against the JAX oracles (seed 1 only): chi2 relative to
    tests/oracle/day1000_seed1_oracle.npz, and the W-weighted field of the
    first 64 records against the setting's window oracle;
  * card against CPU: chi2 relative, W-weighted field over every record,
    |dlog10 alpha|;
  * for exact: solve.final_solve (a fresh eigendecomposition at the given
    alpha) at the card's own alphas, run on the card (card stage) and on
    the CPU, against each other (the solve alone, card against CPU at equal
    alpha), the CPU's against the card's own anchored solve (two solves at
    one alpha on the cutoff wall; also the CPU's own pair), and against the
    oracle (what the card's alphas are worth).
Medians and maxima leave out NaN records; "field" is chip_smoke.wfield.
"""

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from volumetricinterp_tpu_torch.ops import solve  # noqa: E402

cs.HAVE_H5PY = False  # the in-memory day on both sides
SEEDS = (1, 2, 3)
NWIN = 64
# (key, method, mode, seed, records, eigh on the host)
SETTINGS = [(f"exact_seed{s}", "chi2", "exact", s, None, False) for s in SEEDS]
SETTINGS += [(f"exact_seed{s}_host_eigh", "chi2", "exact", s, None, True)
             for s in SEEDS]
SETTINGS += [("fast", "chi2", "fast", 1, NWIN, False),
             ("gcv", "gcv", "exact", 1, NWIN, False)]


def host_eigh(X):
    """solve.eigh, computed on the host CPU, results moved back."""
    w, V = torch.linalg.eigh(X.cpu())
    return w.to(X.device), V.to(X.device)


def run(device):
    """Fit every setting on ``device``; returns {key: fit dict}."""
    out = {}
    eigh = solve.eigh
    with tempfile.TemporaryDirectory() as tmp:
        for key, method, mode, seed, nwin, on_host in SETTINGS:
            if on_host and device == "cpu":
                continue
            solve.eigh = host_eigh if on_host else eigh
            try:
                day = dict(cs.DAY, seed=seed)
                out[key] = cs.fit_day(Path(tmp), device, method, mode, nwin, day)
            finally:
                solve.eigh = eigh
            print(f"{key}: {out[key]['fit_rec_s']:.3f} s of fit_records",
                  flush=True)
    return out


def stage_card(path):
    cs.phase_device()
    fits = run("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    arrays = {f"{k}_{f}": np.asarray(v[f]) for k, v in fits.items()
              for f in ("C", "chi2", "reg")}
    for key, method, mode, _, _, on_host in SETTINGS:
        if (method, mode, on_host) == ("chi2", "exact", False):
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
    oracle = np.load(ROOT / "tests" / "oracle" / "day1000_seed1_oracle.npz")
    report = {}
    for key, method, mode, seed, nwin, on_host in SETTINGS:
        ref = cpu[f"exact_seed{seed}" if on_host else key]
        c = {f: card[f"{key}_{f}"] for f in ("C", "chi2", "reg")}
        n = len(c["chi2"])
        lines = {}
        if seed == 1:
            tag = "exact" if mode == "exact" and method == "chi2" else key
            C_o, _, reg_o = cs.window_oracle(tag, NWIN)
            for side, C, chi2, reg in (
                    ("card", c["C"], c["chi2"], c["reg"]),
                    ("cpu", ref["C"], ref["chi2"], ref["reg"])):
                lines[f"{side} vs oracle: field, first {NWIN}"] = stats(
                    field(ref, C[:NWIN], C_o))
                if n == 1000:
                    o = oracle["chi2"][:n]
                    lines[f"{side} vs oracle: chi2 rel"] = stats(
                        np.abs(chi2 - o) / o)
                    reg_o = oracle["reg"][:n, 0]
                lines[f"{side} vs oracle: |dlog10 alpha|"] = stats(
                    cs.dlog10(reg, reg_o))
        lines["card vs cpu: chi2 rel"] = stats(
            np.abs(c["chi2"] - ref["chi2"]) / ref["chi2"])
        lines["card vs cpu: field"] = stats(field(ref, c["C"], ref["C"]))
        lines["card vs cpu: |dlog10 alpha|"] = stats(
            cs.dlog10(c["reg"], ref["reg"]))
        nan_c, nan_x = np.isnan(c["chi2"]), np.isnan(ref["chi2"])
        lines["NaN records, card / cpu / both"] = (
            f"{nan_c.sum()} / {nan_x.sum()} / {(nan_c & nan_x).sum()}")
        if mode == "exact" and method == "chi2" and not on_host:
            C_y, chi2_y = at_alphas(ref, ref["reg"], "cpu")
            lines["cpu fit vs cpu final_solve at its alphas: chi2 rel"] = \
                stats(np.abs(ref["chi2"] - chi2_y) / chi2_y)
            lines["cpu fit vs cpu final_solve at its alphas: field"] = stats(
                field(ref, ref["C"], C_y))
            C_x, chi2_x = at_alphas(ref, c["reg"], "cpu")
            C_at, chi2_at = card[f"{key}_C_at"], card[f"{key}_chi2_at"]
            lines["final_solve at card alphas, card vs cpu: chi2 rel"] = stats(
                np.abs(chi2_at - chi2_x) / chi2_x)
            lines["final_solve at card alphas, card vs cpu: field"] = stats(
                field(ref, C_at, C_x))
            lines["cpu final_solve at card alphas vs card fit: chi2 rel"] = \
                stats(np.abs(c["chi2"] - chi2_x) / chi2_x)
            lines["cpu final_solve at card alphas vs card fit: field"] = stats(
                field(ref, c["C"], C_x))
            if seed == 1:
                o = oracle["chi2"][:n]
                lines["cpu final_solve at card alphas vs oracle: chi2 rel"] = stats(
                    np.abs(chi2_x - o) / o)
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
