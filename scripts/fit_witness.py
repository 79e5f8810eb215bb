#!/usr/bin/env python3
"""The port's production-order fits on the card and on a CPU, side by side.

    python3 scripts/fit_witness.py card OUT.npz   # on a CUDA machine
    python3 scripts/fit_witness.py cpu OUT.npz    # then on a CPU, same file
    python3 scripts/fit_witness.py layout         # the layout stage alone

chip_smoke.py holds each fit setting against the JAX package's CPU float64
oracle.  This script tells apart which of a fit's eigendecompositions
decides where a card run lands against the oracle and against a CPU run,
and how far the result follows the layout of the record batch.  Every fit
goes through chip_smoke.fit_day (the code phases 4b-4d run) on the
in-memory synthetic day, or through ops/fit.fit_records on its 64-record
window, so the inputs are the same bytes on both sides.

A fit decomposes matrices at six sites (SITES).  A placement names the
sites whose decompositions run in LAPACK float64 on the host
(solve.host_eigh); every other site runs on the card (solve.eigh,
cuSOLVER); ``shipped`` leaves the code as it is.  The card stage fits

  * exact (the shipped default) over the whole seed-1, -2 and -3 days in
    each EXACT_PLACEMENTS entry, and the 64-record window of seed 1 in fast,
    gcv (exact), manual and exact_grid mode in each of that mode's
    placements (WINDOW_MODES), each against its JAX CPU float64 oracle:
    NaN set, chi2 relative (days: tests/oracle/day1000_seed{1,2,3}_
    oracle.npz) and the W-weighted field (windows: ..._window64_<tag>.npz;
    manual has no oracle and is held against the CPU only);
  * the layout stage: the window fitted whole, as two 32-record batches,
    and with its statistics the sum of two point halves' (as the parallel
    layer formed them before, a rounding-level change), in every mode,
    with every site on the card, in the earlier placement (AtWA on the host)
    and with every site on the host: how many roots move by more than
    chip_smoke.SHARD_TOL in log10 alpha, and the chi2 / alpha / field
    spreads against the whole batch;
  * the host pool: the seed-1 exact day with every site on the host, with
    a pool of host threads for each calling thread (what ships) and with
    one pool shared by the prepare thread and the search, in turns;
  * one 128-record chunk of AtWA by torch.linalg.eigh on the card and by
    solve.host_eigh.

It stores chi2, alpha and C of each fit with the card's nvidia-smi name and
power limit.  The cpu stage fits every setting as the code ships on the
CPU (every site is LAPACK there), prints the layout stage on the CPU, and
per card setting its lines against the oracle beside the CPU's, and card
against CPU (chi2 relative, W-weighted field, |dlog10 alpha|).  Medians and
maxima leave out NaN records; "field" is chip_smoke.wfield.
"""

import contextlib
import functools
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
from volumetricinterp_tpu_torch import interpolate  # noqa: E402
from volumetricinterp_tpu_torch.config import Config  # noqa: E402
from volumetricinterp_tpu_torch.models.sphharmlag import Model  # noqa: E402
from volumetricinterp_tpu_torch.ops import fit as ops_fit  # noqa: E402
from volumetricinterp_tpu_torch.ops import regparam, solve  # noqa: E402

cs.HAVE_H5PY = False  # the in-memory day on both sides
SEEDS = (1, 2, 3)
NWIN = 64
# the decomposition sites of a fit
SITES = ("atwa",  # AtWA's (ops/fit.atwa_eig): exact, gcv and fast searches
         "pencil",  # the whitened pencil's (regparam.pencil): exact, fast
         "anchors",  # the exact search's seed and endgame M-shift anchors
         "rbasis",  # R's once a run (ops/fit.reg_mats_eig): exact, gcv
         "solve",  # the final cutoff solve: fast, gcv, manual, exact_grid
         "grid")  # exact_grid's 101-point grid and bisection
HOST = SITES
EARLIER = ("atwa",)  # the earlier route: AtWA's on the host, the rest on the card
EXACT_PLACEMENTS = {"card": (), "atwa": EARLIER, "pencil": ("pencil",),
                    "anchors": ("anchors",),
                    "atwa+pencil": ("atwa", "pencil"),
                    "atwa+anchors": ("atwa", "anchors"),
                    "atwa+pencil+anchors": ("atwa", "pencil", "anchors"),
                    "host": HOST, "shipped": None}
# window tag: (method, mode, the sites its fit has)
WINDOW_MODES = {"fast": ("chi2", "fast", ("atwa", "pencil", "solve")),
                "gcv": ("gcv", "exact", ("atwa", "rbasis", "solve")),
                "manual": ("manual", "exact", ("solve",)),
                "exact_grid": ("chi2", "exact_grid", ("grid", "solve"))}


def window_placements(sites):
    """Every site on the card, each alone on the host, all on the host,
    and as shipped."""
    out = {"card": ()}
    if len(sites) > 1:
        out.update({s: (s,) for s in sites})
    out.update(host=HOST, shipped=None)
    return out


# (key, method, mode, seed, records, placement)
SETTINGS = [(f"exact_seed{s}_{p}", "chi2", "exact", s, None, p)
            for s in SEEDS for p in EXACT_PLACEMENTS]
SETTINGS += [(f"{tag}_{p}", method, mode, 1, NWIN, p)
             for tag, (method, mode, sites) in WINDOW_MODES.items()
             for p in window_placements(sites)]
LAYOUT_MODES = {"exact": ("chi2", "exact"), **{
    tag: (method, mode) for tag, (method, mode, _) in WINDOW_MODES.items()}}
# name: (host sites, where the statistics are formed: None on the fit's
# device, "cpu" in float64 on the host CPU and copied to the fit's device)
LAYOUT_PLACEMENTS = {"card": ((), None), "atwa": (EARLIER, None),
                     "host": (HOST, None),
                     "host, statistics on the host": (HOST, "cpu")}
# (name, record batches, point shards)
LAYOUTS = (("whole", 1, 1), ("2 batches of 32", 2, 1),
           ("2 point halves added", 1, 2))


def host_sites(key):
    """The host sites of a setting's placement (None: as shipped)."""
    tag, placement = key.rsplit("_", 1)
    if tag.startswith("exact_seed"):
        return EXACT_PLACEMENTS[placement]
    return window_placements(WINDOW_MODES[tag][2])[placement]


@contextlib.contextmanager
def placed(sites):
    """Each site of SITES by solve.host_eigh if it is in ``sites``, else by
    solve.eigh on the fit's device; ``sites`` None: as the code ships.
    Every patched name is a module global the fit looks up at call time."""
    if sites is None:
        yield
        return
    route = {s: solve.host_eigh if s in sites else solve.eigh for s in SITES}
    patches = [
        (ops_fit, "atwa_eig",
         lambda X: solve.normalized_eigh(X, route["atwa"])),
        (regparam, "whiten_pencil",
         functools.partial(solve.whiten_pencil, decompose=route["pencil"])),
        (regparam, "normalized_eigh",
         functools.partial(solve.normalized_eigh, decompose=route["anchors"])),
        (ops_fit, "final_solve",
         functools.partial(solve.final_solve, decompose=route["solve"])),
        (regparam, "cutoff_chi2_x",
         functools.partial(solve.cutoff_chi2_x, decompose=route["grid"])),
    ]
    rbasis = lambda R: solve.normalized_eigh(R, route["rbasis"])[1:]  # noqa: E731
    patches += [(ops_fit, "reg_mats_eig", rbasis),
                (interpolate, "reg_mats_eig", rbasis)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, f in patches:
        setattr(mod, name, f)
    try:
        yield
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)


def run(device, settings):
    """Fit every setting on ``device``; returns {key: fit dict}."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, method, mode, seed, nwin, _ in settings:
            day = dict(cs.DAY, seed=seed)
            with placed(host_sites(key)):
                out[key] = cs.fit_day(Path(tmp), device, method, mode, nwin,
                                      day)
            f = out[key]
            print(f"{key}: {f['fit_rec_s']:.3f} s of fit_records, "
                  f"{f['eigh'] - f['host_eigh']} card and {f['host_eigh']} "
                  f"host eighs, {int(np.isnan(f['chi2']).sum())} NaN",
                  flush=True)
    return out


def stats(v):
    v = np.asarray(v)[np.isfinite(v)]
    if not len(v):
        return "none"
    return f"median {np.median(v):.4e} max {v.max():.4e}"


def oracle_lines(side, key, method, mode, seed, fit):
    """``side``'s fit against the JAX CPU float64 oracle of its setting."""
    lines = {}
    C, chi2, reg = fit["C"], fit["chi2"], fit["reg"]
    if len(chi2) == cs.DAY["nrec"]:
        o = cs.day_oracle(seed)
        nan, nan_o = np.isnan(chi2), np.isnan(o["chi2"])
        lines[f"{side} vs oracle: NaN records, {side} / oracle / both"] = (
            f"{nan.sum()} / {nan_o.sum()} / {(nan & nan_o).sum()}")
        lines[f"{side} vs oracle: chi2 rel"] = stats(
            np.abs(chi2 - o["chi2"]) / o["chi2"])
        lines[f"{side} vs oracle: |dlog10 alpha|"] = stats(
            cs.dlog10(reg, o["reg"][:, 0]))
        lines[f"{side}: negative chi2"] = int((chi2 < 0).sum())
    tag = "exact" if mode == "exact" and method == "chi2" else key.rsplit(
        "_", 1)[0]
    if seed == 1 and tag != "manual":
        C_o, chi2_o, reg_o = cs.window_oracle(tag, NWIN)
        lines[f"{side} vs oracle: field, first {NWIN}"] = stats(
            cs.wfield(fit, C_o, NWIN))
        lines[f"{side} vs oracle: chi2 rel, first {NWIN}"] = stats(
            np.abs(chi2[:NWIN] - chi2_o) / chi2_o)
    return lines


def window_inputs(device):
    """The seed-1 window's values and errors, A and R on ``device``."""
    _, lat, lon, alt, v, e = cs.qc(cs.day_data(cs.DAY))
    model = Model(Config.from_text(cs.MODEL_CFG))
    dev = lambda x: torch.as_tensor(x, dtype=torch.float64, device=device)  # noqa: E731
    return dict(v=dev(v[:NWIN]), e=dev(e[:NWIN]), A=dev(model.basis(lat, lon,
                                                                     alt)),
                R=dev(model.eval_psi()[None]), ok=np.isfinite(v[:NWIN]),
                err=e[:NWIN])


def layout_stats(inp, halves, stats_device=None):
    """The window's statistics, the sum of those of ``halves`` point
    shards, formed on ``stats_device`` (the inputs' when None) and
    returned on the inputs' device."""
    dev = inp["A"].device
    v, e, A = (inp[k].to(stats_device or dev) for k in ("v", "e", "A"))
    cut = np.linspace(0, A.shape[0], halves + 1).round().astype(int)
    st = None
    for j in range(halves):
        pts = slice(int(cut[j]), int(cut[j + 1]))
        sj = solve.suff_stats(A[pts], v[:, pts], e[:, pts])
        st = sj if st is None else [a + b for a, b in zip(st, sj)]
    return [x.to(dev) for x in st]


def stats_diff(got, ref):
    """max over records of max |got - ref| / max |ref|, per statistic."""
    line = []
    for k, a, b in zip(("AtWA", "AtWb", "btWb", "N"), got, ref):
        ax = tuple(range(1, b.dim()))
        d = (a - b).abs().amax(ax) if ax else (a - b).abs()
        m = b.abs().amax(ax) if ax else b.abs()
        line.append(f"{k} {float((d / m.clamp(min=1e-300)).max()):.3e}")
    return ", ".join(line)


def layout_fit(inp, method, mode, batches, st, device):
    """fit_records of the window in ``batches`` record batches from the
    statistics ``st``; host (C, chi2, alpha).  On the card prepare_stats
    pads each batch to solve.CARD_BATCH records, so two batches of 32 are
    the whole batch's bits there."""
    v, e, A, R = inp["v"], inp["e"], inp["A"], inp["R"]
    per = v.shape[0] // batches
    manual = [regparam.manual_reg_param("0thorder")]
    parts = []
    for i in range(batches):
        sl = slice(i * per, (i + 1) * per)
        prepared = ops_fit.prepare_stats(v[sl], e[sl],
                                         tuple(x[sl] for x in st), R, method,
                                         mode)
        C, _, chi2, rp = ops_fit.fit_records(
            None, None, A, R, method=method, manual_params=manual,
            regparam_mode=mode, device=device, prepared=prepared)
        parts.append([C.cpu().numpy(), chi2.cpu().numpy(),
                      rp[:, 0].cpu().numpy()])
    return [np.concatenate(x) for x in zip(*parts)]


def layout_stage(device, placements):
    """The layout stage (module docstring) on ``device``: one printed line
    per mode, placement and layout; returns them as a dict."""
    inp = window_inputs(device)
    A = inp["A"].cpu().numpy()
    sw = inp["ok"] / np.where(inp["ok"], inp["err"], 1.0)
    out = {}
    formed = {}
    for sdev in sorted({d for _, d in placements.values()}, key=str):
        formed[sdev] = {h: layout_stats(inp, h, sdev) for h in (1, 2)}
        pairs = [(f"statistics on {sdev or device}, two point halves vs "
                  "whole", formed[sdev][2], formed[sdev][1])]
        if sdev is not None and None in formed:
            pairs.append((f"statistics whole, on {device} vs on {sdev}",
                          formed[None][1], formed[sdev][1]))
        for what, got, ref in pairs:
            out[what] = stats_diff(got, ref)
            print(f"layout {device}: {what}, max over records of max |diff| "
                  f"/ max |ref|: {out[what]}", flush=True)
    for tag, (method, mode) in LAYOUT_MODES.items():
        for pname, (sites, sdev) in placements.items():
            with placed(sites):
                fits = {name: layout_fit(inp, method, mode, b,
                                         formed[sdev][h], device)
                        for name, b, h in LAYOUTS}
            C0, chi20, a0 = fits["whole"]
            for name, _, _ in LAYOUTS[1:]:
                C, chi2, a = fits[name]
                ok = np.isfinite(a0) & (a0 > 0) & np.isfinite(a) & (a > 0)
                outcome = int(((np.isfinite(a0) & (a0 > 0)) != ok).sum())
                dla = np.abs(np.log10(a[ok]) - np.log10(a0[ok]))
                rel_a = np.abs(a[ok] / a0[ok] - 1.0)
                fin = np.isfinite(chi20)
                rel = np.abs(chi2 - chi20)[fin] / chi20[fin]
                wf = (np.linalg.norm(sw * ((C - C0) @ A.T), axis=1)
                      / np.linalg.norm(sw * (C0 @ A.T), axis=1))[fin]
                moved = int((dla > cs.SHARD_TOL).sum())
                line = (f"{moved} of {int(ok.sum())} roots moved > "
                        f"{cs.SHARD_TOL:g} decades, {outcome} outcomes "
                        f"changed; chi2 rel {stats(rel)}; |dlog10 alpha| "
                        f"{stats(dla)}; alpha rel max "
                        f"{rel_a.max(initial=0.0):.3e}; field {stats(wf)}")
                out[f"{tag} {pname} {name}"] = line
                print(f"layout {device} {tag} ({pname}) {name} vs whole: "
                      f"{line}", flush=True)
    return out


def pool_seconds(device, reps=2):
    """The seed-1 exact day with every site on the host: host_eigh with a
    pool for each calling thread (shipped) and with one shared pool, in
    turns; returns {name: [(day s, fit_records s, host_eigh s), ...]}."""
    shared = solve._one_thread_pool(solve.HOST_EIGH_THREADS)
    own = solve._host_pool
    out = {"own pools": [], "one shared pool": []}
    order = ["own pools", "one shared pool"] * reps
    order = order[:reps] + order[reps:][::-1]  # own, shared, shared, own
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name in order:
                solve._host_pool = own if name == "own pools" else (
                    lambda: shared)
                with placed(HOST):
                    f = cs.fit_day(Path(tmp), device, "chi2", "exact",
                                   day=cs.DAY)
                out[name].append((f["fit_s"], f["fit_rec_s"], f["host_s"]))
                print(f"host pool, {name}: day {f['fit_s']:.3f} s, "
                      f"fit_records {f['fit_rec_s']:.3f} s, host_eigh "
                      f"{f['host_s']:.3f} s", flush=True)
    finally:
        solve._host_pool = own
        shared.shutdown()
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card_s, host_s = eigh_seconds()
    print(f"one 128-record chunk of AtWA: torch.linalg.eigh on the card "
          f"{card_s:.4f} s, solve.host_eigh ({solve.HOST_EIGH_THREADS} "
          f"threads) {host_s:.4f} s", flush=True)
    fits = run("cuda", SETTINGS)
    report = {}
    for key, method, mode, seed, nwin, _ in SETTINGS:
        report[key] = oracle_lines("card", key, method, mode, seed, fits[key])
        print(f"\n{key}:")
        for k, v in report[key].items():
            print(f"  {k}: {v}")
    print()
    report["layout"] = layout_stage("cuda", LAYOUT_PLACEMENTS)
    report["pool"] = pool_seconds("cuda")
    arrays = {f"{k}_{f}": np.asarray(v[f]) for k, v in fits.items()
              for f in ("C", "chi2", "reg")}
    np.savez_compressed(path, card=smi.splitlines()[0], **arrays)
    print(f"card: {smi}\nwrote {path}")
    print(json.dumps(report))


def stage_cpu(path):
    card = np.load(path)
    print(f"card: {card['card']}; CPU: {torch.get_num_threads()} threads")
    shipped = [s for s in SETTINGS if s[5] == "shipped"]
    cpu = run("cpu", shipped)
    report = {"layout": layout_stage("cpu", {"shipped": (None, None)})}
    for key, method, mode, seed, nwin, _ in SETTINGS:
        ref_key = next(k for k, _, m, sd, _, _ in shipped
                       if k.rsplit("_", 1)[0] == key.rsplit("_", 1)[0])
        ref = cpu[ref_key]
        c = dict(ref, **{f: card[f"{key}_{f}"] for f in ("C", "chi2", "reg")})
        lines = oracle_lines("card", key, method, mode, seed, c)
        if key == ref_key:
            lines.update(oracle_lines("cpu", key, method, mode, seed, ref))
        lines["card vs cpu: chi2 rel"] = stats(
            np.abs(c["chi2"] - ref["chi2"]) / ref["chi2"])
        lines["card vs cpu: field"] = stats(
            cs.wfield(c, ref["C"], len(ref["C"])))
        lines["card vs cpu: |dlog10 alpha|"] = stats(
            cs.dlog10(c["reg"], ref["reg"]))
        nan_c, nan_x = np.isnan(c["chi2"]), np.isnan(ref["chi2"])
        lines["NaN records, card / cpu / both"] = (
            f"{nan_c.sum()} / {nan_x.sum()} / {(nan_c & nan_x).sum()}")
        report[key] = lines
        print(f"\n{key} ({method}, {mode}, seed {seed}):")
        for k, v in lines.items():
            print(f"  {k}: {v}")
    return report


if __name__ == "__main__":
    if sys.argv[1:] == ["layout"]:
        cs.phase_device()
        print(json.dumps(layout_stage("cuda", LAYOUT_PLACEMENTS)))
        sys.exit(0)
    if len(sys.argv) != 3 or sys.argv[1] not in ("card", "cpu"):
        sys.exit(__doc__)
    if sys.argv[1] == "card":
        stage_card(sys.argv[2])
    else:
        print(json.dumps(stage_cpu(sys.argv[2])))
