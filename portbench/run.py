"""Run one cell of the port's benchmark on the card this process runs on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The cell's set-up (its inputs made from
the seed, the program's set-up and one warm-up call of every shape the cell
uses) counts in ``setup_s``; then the cell's closed loop of calls runs for
``--seconds`` (the call still running then is finished and counted); then
what the window produced is checked against the plain reference.  The last
line on standard output is one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones read from a profiled stretch of the window), device and,
last, checks (each compared number beside its limit, also printed as the
last lines on standard error).  Without a CUDA card the run prints no
result and exits with status 2.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cell_metrics(bench, workload):
    """(end-to-end, per-layer) metric entries the cell reports."""
    def listed(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [])
                 or ("workloads" not in m and m["moves"] in names)]
    return e2e, per_layer


def main(argv=None):
    args = parse(argv)
    sys.path.insert(0, str(REPO))
    import torch

    from portbench import harness

    w, cfg, traffic, limits = harness.cell_files(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"portbench: the cell needs {w['chips']} CUDA card(s); this "
              f"machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    _, per_layer = cell_metrics(harness.manifest(), args.workload)
    result = harness.run_cell(args.workload, cfg, traffic, limits, args.seed,
                              args.seconds, bool(args.trace), "cuda",
                              t_process=T_PROCESS, per_layer=per_layer)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
