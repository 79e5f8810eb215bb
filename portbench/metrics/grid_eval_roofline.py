"""The share of its roofline that csrc/grid_eval.cu's kernel reaches in
the traced requests, in %: the least time the card could take for those
requests' evaluations (kernel_work, from the configuration's sizes and the
live points of the benchmark's own FoV mask) over the device time of the
kernels named grid_eval_kernel in the profiler's trace.  Where none of
them ran (an order that routes to csrc/grid_eval_tiled.cu, whose share is
another metric's), it returns nothing and says so on standard error."""

import sys

from portbench.metrics.kernel_work import bound_s, grid_eval_work

KERNEL = "grid_eval_kernel"


def read(run):
    tr = run["trace"]
    if run["traffic"]["op"] != "product" or tr is None:
        return None
    t = sum(s for n, s in tr["ops"].items() if KERNEL in n)
    if t <= 0.0:
        seen = sorted(n for n in tr["ops"] if "grid_eval" in n)
        print(f"grid_eval_roofline: no {KERNEL} in the traced requests "
              f"(grid kernels seen: {seen or 'none'})", file=sys.stderr)
        return None
    drv = run["runner"]
    model = run["config"]["MODEL"]
    nbasis = int(model["MAXK"]) * int(model["MAXL"]) ** 2
    flop, nbytes = grid_eval_work(drv.npts, drv.live_points, drv.nrec, nbasis)
    requests = int(run["traffic"]["trace_calls"])
    return 100.0 * requests * bound_s(flop, nbytes) / t
