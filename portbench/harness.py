"""The benchmark's general runner: a cell's program set-up, its closed-loop
window of calls, the check of what the window produced against the plain
reference, and the readings of a traced run.

Everything of one cell is found by name: its configuration in
``configs/<config>.json``, its traffic mix (a data file of parameters) in
``traffic/<traffic>.json``, the limits of its check in
``checks/<workload>.json``, each per-layer metric's reader in
``metrics/<metric>.py``, and the operation that the mix names (``op``) in
``operations/<op>.py``.  A new mix of an existing operation is a data file;
a new kind of call (another grid walk, another search) is a new operation
file; neither edits a file that is there.

An operation's ``Runner(cfg, traffic, device)`` refuses a configuration
its reference does not model, and has ``rate`` (the end-to-end metric's
name and unit), ``work_per_op``, ``load(seed)``, ``call(i, keep)`` (the
operations it completed), ``failed()``, ``timers()``, ``release()`` and
``check(rng, k, control=False)`` (the compared numbers).  The window runs
for ``--seconds`` and at least the mix's ``min_calls`` calls (default 1),
the call running at ``--seconds`` finished and counted.

The program is driven only through its public classes; the reference
(``reference/``) imports nothing of it and takes nothing it made.
"""

from __future__ import annotations

import datetime as dt
import importlib
import importlib.util
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np

from .metrics import trace_math

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
EPOCH = dt.datetime(1970, 1, 1)
PROGRAM = "volumetricinterp_tpu_torch"
# top-level modules no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "volumetricinterp_tpu")
INI_SECTIONS = ("DEFAULT", "MODEL", "TPU")


def load_json(*parts):
    return json.loads(ROOT.joinpath(*parts).read_text())


def manifest():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def cell_files(workload):
    """(workload entry, config, traffic, limits) of a cell of the manifest."""
    cells = {w["name"]: w for w in manifest()["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the manifest has "
                         f"{sorted(cells)}")
    w = cells[workload]
    return (w, load_json("configs", f"{w['config']}.json"),
            load_json("traffic", f"{w['traffic']}.json"),
            load_json("checks", f"{workload}.json"))


def ini_text(cfg):
    """The configuration's INI text, as the program reads it."""
    lines = []
    for sec in INI_SECTIONS:
        lines.append(f"[{sec}]")
        for k, v in cfg.get(sec, {}).items():
            v = ",".join(map(str, v)) if isinstance(v, list) else v
            lines.append(f"{k} = {v}")
    return "\n".join(lines) + "\n"


def forbidden_modules():
    """Top-level names in sys.modules that no run may hold."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def operation(name):
    """The Runner class of operations/<name>.py."""
    if not name.isidentifier() or not (ROOT / "operations"
                                       / f"{name}.py").is_file():
        raise ValueError(f"no operation {name!r} in {ROOT / 'operations'}")
    return importlib.import_module(f"portbench.operations.{name}").Runner


def load_reader(name):
    """The per-layer metric reader metrics/<name>.py (its ``read``)."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def seed_words(seed):
    """The seed as the non-negative entropy numpy's SeedSequence takes:
    every seed from 0 to 2**64 - 1 is itself, a negative one wraps."""
    return int(seed) % 2**64


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def seconds_of(utime_row):
    return EPOCH + dt.timedelta(seconds=float(utime_row))


# ----------------------------------------------------------------------
# a run
# ----------------------------------------------------------------------


def phase_totals(timers):
    out = {}
    for t in timers:
        for k, v in t.report().items():
            out[k] = out.get(k, 0.0) + v
    return out


def counters():
    """The program's own counts (module counters of ops/solve, ops/fit and
    ops/grid_eval_cuda)."""
    from volumetricinterp_tpu_torch.ops import fit, grid_eval_cuda, solve

    return {"eigh_matrices": solve.eigh_matrices,
            "host_eigh_matrices": solve.host_eigh_matrices,
            "host_eigh_seconds": solve.host_eigh_seconds,
            "grid_eval_launches": grid_eval_cuda.launches,
            "grid_eval_tiled_launches": grid_eval_cuda.tiled_launches,
            "negative_chi2_reports": fit.negative_chi2_reports}


def run_cell(workload, cfg, traffic, limits, seed, seconds, trace, device,
             t_process=None, per_layer=(), log=print):
    """One run of a cell; returns the result's dict (the contract's last
    line).  ``per_layer``: the manifest's per-layer metric entries of this
    cell, read when ``trace``."""
    import torch

    t_process = time.perf_counter() if t_process is None else t_process
    seed = seed_words(seed)
    device = torch.device(device)
    drv = operation(traffic["op"])(cfg, traffic, device)
    logging.getLogger(PROGRAM).setLevel(logging.WARNING)
    drv.load(seed)
    drv.call(0, keep=False)  # the warm-up: every shape of the cell
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    phases0, counts0 = phase_totals(drv.timers()), counters()
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    ops, i, traced = 0, 1, None
    ntrace = int(traffic["trace_calls"]) if trace else 0
    min_calls = max(int(traffic.get("min_calls", 1)), ntrace)
    names = set(phases0)
    while True:
        if i <= ntrace:
            with trace_math.profiled(device, names) as tr:
                ops += drv.call(i)
                sync(device)
            traced = trace_math.merge(traced, tr)
        else:
            ops += drv.call(i)
            sync(device)
        t_end = time.perf_counter()
        i += 1
        if t_end - t0 >= seconds and i > min_calls:
            break
    window_s = t_end - t0
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    phases = {k: v - phases0.get(k, 0.0)
              for k, v in phase_totals(drv.timers()).items()}
    counts = {k: v - counts0[k] for k, v in counters().items()}
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"the run holds {bad} in sys.modules")
    run = {"workload": workload, "config": cfg, "traffic": traffic,
           "ops": ops, "calls": i - 1, "phases": phases, "counts": counts,
           "window_s": window_s, "trace": traced, "runner": drv}
    failed = drv.failed()
    drv.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 3]))
    t_check = time.perf_counter()
    got = drv.check(rng, int(traffic["check_samples"]))
    log(f"check: {time.perf_counter() - t_check:.3f} s against the "
        f"reference, {got}", file=sys.stderr)
    checks = {k: {"value": got[k], "limit": lim["limit"]}
              for k, lim in limits["compared"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
            file=sys.stderr)

    if trace:
        metrics = {}
        for m in per_layer:
            v = load_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        name, unit = drv.rate
        metrics = {name: {"value": ops * drv.work_per_op / window_s,
                          "unit": unit},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(ops),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if trace and traced is not None:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        result["breakdown"] = trace_math.breakdown(traced)
    result["checks"] = checks
    return result
