"""The readings a cell's limits are set from, many seeds in one process:
for each seed, the cell's inputs, ``--calls`` calls of its timed path at
its own sizes (after one warm-up call in the process), and the numbers its
check compares, for the program and for the control (the reference one
precision lower in the program's place: the fit in float32, the product's
contraction in TF32 and its hull test in float32).

    python3 portbench/readings.py --workload <cell> --seeds 11 12 ... \
        [--calls 1] [--control-seeds 3] [--samples K] [--out <file>]

``--samples`` sets the program's sampled comparisons (0: only the numbers
an operation takes over every record of the window, which need no
reference search); the control always samples as the mix does.

One JSON line a seed; with --out, all of them in one file.  Without a
CUDA card it exits with status 2.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def readings(workload, cfg, traffic, seeds, calls, device, control_seeds,
             samples=None):
    """[{seed, program, control, seconds}] for each seed (the control on
    the first ``control_seeds`` seeds only, None on the others)."""
    from portbench import harness

    drv = harness.operation(traffic["op"])(cfg, traffic, device)
    out = []
    for n, seed in enumerate(map(harness.seed_words, seeds)):
        t0 = time.perf_counter()
        drv.load(seed)
        if n == 0:
            drv.call(0, keep=False)
        for i in range(1, calls + 1):
            drv.call(i)
        harness.sync(device)
        t_calls = time.perf_counter() - t0
        k = int(traffic["check_samples"])
        rng = np.random.default_rng(np.random.SeedSequence([int(seed), 3]))
        prog = drv.check(rng, k if samples is None else samples)
        ctrl = None
        if n < control_seeds:
            rng = np.random.default_rng(
                np.random.SeedSequence([int(seed), 3]))
            try:
                ctrl = drv.check(rng, k, control=True)
            except RuntimeError as e:  # a control that crashes has failed
                ctrl = {"crashed": f"{type(e).__name__}: {e}"}
        out.append({"workload": workload, "seed": seed, "program": prog,
                    "control": ctrl, "calls_s": t_calls,
                    "seconds": time.perf_counter() - t0})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--calls", type=int, default=1)
    p.add_argument("--control-seeds", type=int, default=3,
                   help="read the control on the first N seeds")
    p.add_argument("--samples", type=int)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    from portbench import harness

    _, cfg, traffic, _ = harness.cell_files(args.workload)
    if not torch.cuda.is_available():
        print("portbench: readings need a CUDA card", file=sys.stderr)
        return 2
    res = readings(args.workload, cfg, traffic, args.seeds, args.calls,
                   torch.device("cuda"), args.control_seeds, args.samples)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
