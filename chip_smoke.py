#!/usr/bin/env python3
"""Smoke run of the PyTorch port (volumetricinterp_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root; needs CUDA + nvcc

Phases, one output line each (phase 3 one per shape), any failure exits
non-zero:
  1. device   the card (nvidia-smi name and power limit), TF32 off;
  2. build    nvcc builds, all at once, the kernel instantiations of the
              production order, of ORDER_CASES and of HI_ORDER, from
              csrc/grid_eval.cu and, for the orders kernel_config routes
              there (maxl 10), csrc/grid_eval_tiled.cu (seconds, registers,
              spills of each);
  3. kernel   the grid-evaluation kernel against its plain twin at the
              production order (MAXK=4, MAXL=6, nbasis=144) at the shapes
              the main path launches (KERNEL_SHAPES): float32 kernel within
              5e-5 of the sup of the float64 twin, same NaN set; its time,
              the work the inputs need and the card's bound for that work;
              then the same check at the ORDER_CASES orders ((10,16) on
              the tiled kernel);
  4. fit      the main path's fit half: Interpolate.calc_coeffs in
              exact_grid mode over the first 64 records of the seed-1
              synthetic day, held against the JAX package's CPU float64 fits
              of the same records (tests/oracle/day1000_seed1_oracle.npz,
              exact mode; ..._window64_exact_grid.npz, exact_grid mode) in
              chi2 and the W-weighted field residual;
  4b. fit     the shipped default, REGPARAM_MODE = exact, over the whole
              1000-record day (through cli.main when h5py is installed):
              the oracle's NaN set, no negative chi2 (and how many records
              reported the whitened chi2 for a negative one), chi2 against
              the exact oracle and the first 64 records' W-weighted field
              against ..._window64_exact.npz (chi2 median bar
              DAY_CHI2_MEDIAN_TOL); day and fit_records seconds,
              eigendecompositions a record on the card (none) and on the
              host, and the host's seconds;
  4c. fit     the 64-record window in fast mode and in gcv (exact) mode,
              each against its own window oracle (..._window64_fast.npz,
              ..._window64_gcv.npz): NaN set and W-weighted field, and
              eigendecompositions a record on the card (none) and host;
  4d. fit     the fault the host placement of AtWA's eigendecomposition
              repairs: the whole seed-2 and seed-3 days in exact mode, each
              against its JAX CPU float64 day oracle
              (tests/oracle/day1000_seed{2,3}_oracle.npz): the oracle's NaN
              set, no negative chi2, chi2 bars; records/s and the seconds of
              the host eigendecompositions;
  4e. fit     the time axis: the seed-1 day with REGULARIZATION_PROFILE,
              TIME_COUPLING and TIME_SMOOTHING set, against the JAX CPU
              float64 oracle of the same day and configuration
              (tests/oracle/day1000_seed1_timeaxis.npz, scripts/
              window_oracle.py timeaxis): the independent fit, the joint
              solve fed the oracle's alphas (1e-8 in the W-weighted field),
              the joint fit end to end, the records the coupling carries,
              and the time spline at the record mid-times;
  5. product  the main path's product half on phase 4b's coefficients:
              Estimate.evaluate_records of 8 records on the 512x512x128
              grid with the FoV mask, through the kernel (launch count >
              0), FoV finite fraction 0.2809 +- 0.001, and grid_eval
              against the float64 point API;
  6. radbasfun the whole seed-1 day fitted with NAME = radbasfun at the
              config defaults (343 Gaussian RBFs, no regularization) by
              Interpolate.calc_coeffs, against the JAX CPU float64 oracle
              (tests/oracle/day1000_seed1_radbasfun.npz): NaN set, no
              negative chi2, chi2 and W-weighted field bars; then
              evaluate_records of 8 of its records on the config-4 grid
              with the FoV mask, against the float64 basis at 10^4
              points; seconds, points/s, peak device memory;
  7. sweep    lobo_cv on the first 64 records at the production order over
              all 20 beams and 9 log10 alphas, and order_sweep over (2,3),
              (3,5), (4,6), against the JAX CPU float64 oracle
              (tests/oracle/day1000_seed1_lobo.npz): argmin, summed and
              per-entry scores (bars LOBO_*); every eigendecomposition on
              the host (solve.host_eigh), none on the card, and their
              seconds; the first 32 records alone under the profiler, their
              scores the bits of the 64-record call's, and the sweep's
              seconds split into host eighs, copies and device work;
  8. parallel fit_records_sharded (exact and fast) of the 64-record window
              and grid_eval_sharded on config-4 x 1 in a 1-rank nccl world
              in this process, and in a 2-rank gloo world of two child
              processes that both compute on cuda:0, in layouts (2,1) and
              (1,2), against the single-process split of each layout and
              the whole batch (fast to the sharding bars, exact to the day
              bars, the roots that moved printed);
  9. busy     one 128-record chunk of the exact fit under
              utils/profiling.trace: the device's busy share of the traced
              window;
 10. api      the reference-API surface on the card: (a) the models'
              device design path (tensor points, float64) at the production
              order on 10^6 points of the config-4 FoV, sphharmlag basis
              and grad_basis and the radbasfun basis (343 RBFs), each
              within 1e-11 of every column's sup of the host float64 route,
              with the seconds of both routes; (b) Estimate.check_hull on
              phase 5's grid against phase 5's host mask (points may differ
              only where the host's max_f d lies within 1e-12 x scale of
              the threshold), its seconds cold and warm beside phase 5's
              grid_hull seconds, and its peak device memory; (c)
              Interpolate(device="cuda")'s eval_C (with calccov),
              find_reg_param (chi2, gcv, manual) and chi2objfunct at three
              alphas on a well-conditioned random problem (nbasis 144, 580
              points) against tests/oracle/ref_impl.py (the GCV root stored
              by scripts/api_oracle.py);
 11. highorder BASELINE config 3, the lmax=10 x 12 radial basis (HI_ORDER,
              nbasis 1200), its kernel launches counted from 0, every
              fit on the oracles' own QC'd bytes: (a) the basis against the
              NumPy oracle, then the whole 1000-record seed-1 day through
              Interpolate.calc_coeffs in exact mode (8 chunks, the last
              padded from 104 to 128 records): no NaN beyond the QC'd empty
              records, no negative chi2, 0 card and 4.097 host eighs a
              record, records 0-127 and 896-999 against the JAX CPU float64
              oracles (tests/oracle/day1000_seed1_highorder_{exact,
              exact_tail}.npz: NaN set, chi2 and W-weighted field bars);
              seconds, records/s, host_eigh seconds, peak device,
              page-locked and host memory, each line with the card's name
              and power limit; (b) through calc_coeffs, fast mode and
              REGULARIZATION_METHOD = manual (alpha 1e-23) on the first
              128 records and exact_grid on 4, each against its JAX oracle
              (..._highorder_{fast,manual,exact_grid}.npz: NaN set, no
              negative chi2, W-weighted field bars; chi2 to the fit bars in
              fast and manual and to its max in exact_grid; manual's alpha
              the config's), then tests/test_highorder.py's lambda sweep,
              monotone; (c) the day's keogram: all 1000 fitted
              records at the 65,536 meridian points through
              Estimate.evaluate_records, one launch of the tiled kernel,
              against the float64 twin: the same NaN set, each point within
              5e-5 of its record's sup plus 1e-6 of its gross sum (phase
              5's bar for fitted records); (d) lobo_cv on 2 records x 20
              beams x 9 alphas against ..._highorder_lobo.npz's rows for
              them (argmin, per-entry median);
              (e) 8 of the day's records on the config-4 grid with the FoV
              mask through evaluate_records (the tiled kernel's HI_ORDER
              instantiation) against the float64 design path x C; (f) that
              kernel against its float64 twin at config-4 x 8 (FoV-like
              mask), 8.4M x 8, keograms of 65,536 x 512 and x 1000 and
              config-4 x 1, its time, bound and share at each (beside a
              float32 matmul of the contraction's shape as a yardstick), the
              fitted records printed, and the subset property: half the
              grid, the grid under a cut-down mask and one record give the
              bits of the whole launch; (g) the exact day dropped, the
              whole day again with REGULARIZATION_METHOD = gcv (exact
              mode; regparam.GCV_SLICE_BYTES bounds the search's device
              memory): no NaN beyond the QC'd empty records, no negative
              chi2, 0 card and 2,049 host eighs, records 0-31 and
              968-999 against ..._highorder_{gcv,gcv_tail}.npz (NaN set,
              W-weighted field bars; chi2 and alpha printed), peak device
              memory under the unsliced 32-record window's 56.6 GiB, the
              other numbers of (a), and its keogram as (c).  Last the
              page-locked memory held, against solve.host_eigh's slice
              bound.
The depth cuts that keep the run inside its time limit (TIME_CUTS) print
first.  Then a JSON line with the kernels (the production instantiation of
grid_eval.cu with its launches on phases 4-10, grid_eval_tiled.cu's
HI_ORDER one with phase 11's but (f)'s), and last
{"ok": true, "device": ...}.
The coefficient file goes through h5py when it is installed; otherwise
the same classes run on in-memory data (h5py: absent), as on the card,
which has neither h5py nor matplotlib: phases 4d and 4e take that branch,
and Validate's PNG is held on the CPU only (tests/test_torch_grad_validate.py).
"""

import contextlib
import datetime as dt
import gc
import hashlib
import importlib.util
import io
import json
import re
import resource
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from volumetricinterp_tpu_torch import Estimate, Interpolate  # noqa: E402
from volumetricinterp_tpu_torch.cli import main as cli_main  # noqa: E402
from volumetricinterp_tpu_torch.config import Config  # noqa: E402
from volumetricinterp_tpu_torch.coords import (  # noqa: E402
    np_geodetic2ecef, np_geodetic_to_cap)
from volumetricinterp_tpu_torch.io.amisr import qc_datasets  # noqa: E402
from volumetricinterp_tpu_torch.io.coeffs import load_coeff_file  # noqa: E402
from volumetricinterp_tpu_torch.io.synth import (  # noqa: E402
    synthetic_amisr_datasets, write_synthetic_amisr)
from volumetricinterp_tpu_torch.models import make_model  # noqa: E402
from volumetricinterp_tpu_torch.models.sphharmlag import Model  # noqa: E402
from volumetricinterp_tpu_torch.ops import fit as ops_fit  # noqa: E402
from volumetricinterp_tpu_torch.ops import grid_eval_cuda, regparam, solve  # noqa: E402
from volumetricinterp_tpu_torch.ops import timejoint  # noqa: E402
from volumetricinterp_tpu_torch.ops.grid_eval import GridEvaluator  # noqa: E402
from volumetricinterp_tpu_torch.ops.timesmooth import eval_time_spline  # noqa: E402
from volumetricinterp_tpu_torch.io.amisr import beam_indices  # noqa: E402
from volumetricinterp_tpu_torch import parallel, sweep  # noqa: E402
from volumetricinterp_tpu_torch.parallel import distributed  # noqa: E402
from volumetricinterp_tpu_torch.utils.hull import hull_equations  # noqa: E402
from volumetricinterp_tpu_torch.utils.profiling import trace  # noqa: E402

EPOCH = dt.datetime(1970, 1, 1)
# the production order (bench.py's model configuration)
MODEL_CFG = """
[MODEL]
NAME = sphharmlag
MAXK = 4
MAXL = 6
CAP_LIM = 10
MAX_Z_INT = INF
LATCP = 78
LONCP = 262
[TPU]
QUAD_MODE = gauss
"""
# scripts/day_check.py's fit, in a given method and mode (extra: more
# [DEFAULT] lines)
FIT_CFG = """
[DEFAULT]
FILENAME = {raw}
OUTPUTFILENAME = {out}
REGULARIZATION_LIST = 0thorder
REGULARIZATION_METHOD = {method}
{extra}""" + MODEL_CFG + "REGPARAM_MODE = {mode}\n"
# phase 4e's options, those of scripts/window_oracle.py timeaxis
TIME_AXIS_CFG = ("REGULARIZATION_PROFILE = chapman,1e11,300,50\n"
                 "TIME_COUPLING = 1e-4\nTIME_SMOOTHING = gcv\n")
JOINT_TOL = 1e-8  # W-weighted field, joint solve at the oracle's alphas
DAY = dict(nrec=1000, seed=1, nan_frac=0.03, bad_frac=0.01, t0=1480286700.0,
           cadence=60.0)
KERNEL_TOL = 5e-5  # of the sup: float32 theta resolution (tests/test_grid_eval.py)
# Fit bars.  At this basis order the day's normal matrices carry a dense
# wall of modes at the gelsd cutoff, so chi2(alpha) is a staircase whose
# steps move with rounding: any two correct solvers land at different
# roots (PARITY_NOTES #4, #7, #8) and alpha itself is not data-determined.
# Measured on this window, CPU float64: the JAX package's exact mode vs the
# committed exact oracle, chi2 rel median 2.7e-2 max 0.17 (|dlog10 alpha|
# median 0.59, max 57); its exact_grid mode vs its exact mode, W-weighted
# field rel median 3.1e-2 max 8.5e-2.  PARITY_NOTES #4 gives 0.30 as the
# day-scale worst-record chi2 bound.  Phases 4b and 4c hold each setting
# against the JAX package's CPU float64 fit in the same setting
# (scripts/window_oracle.py) with the same bars.
CHI2_MEDIAN_TOL = 0.05
# The exact days of phases 4b and 4d, every eigendecomposition in host
# LAPACK float64 (solve.host_eigh), are held closer: chi2 median against
# the day oracle 0.02.  scripts/fit_witness.py put the card with every
# site on the host at 1.7622e-2, 1.7663e-2 and 1.7314e-2 on seeds 1-3
# (with AtWA's alone there, the earlier route, 3.1946e-2, 3.1424e-2,
# 3.1424e-2), and the port on a CPU at 1.8944e-2, 1.5808e-2 and
# 1.6952e-2 (PERF.md).  Where the CPU's median is above 0.016 (seed 3)
# the bar is 1.25 times the CPU's; seed 1's rests on the earlier
# witness, 1.59e-2 on the card and 1.78e-2 on a CPU.
DAY_CHI2_MEDIAN_TOL = {1: 0.02, 2: 0.02, 3: 1.25 * 1.6952e-2}
CHI2_MAX_TOL = 0.30
WFIELD_MEDIAN_TOL = 0.05
WFIELD_MAX_TOL = 0.15
GRID_TOL = 5e-5  # of the sup, as KERNEL_TOL, plus
GROSS_TOL = 1e-6  # of the point's gross sum: 16 float32 ulps (see phase 5)
FINITE_FRAC = 0.2809  # FoV finite fraction of the config-4 grid (BENCH_r05)
# phase 3's shapes, the kernel launches of the main path: (label, grid
# axes (nlat, lons, nalt), records, mask).  "fov" is fov_like_mask.
KERNEL_SHAPES = (
    ("8.4M x 8", (512, 512, 32), 8, None),  # the first port's timing row
    ("config-4 x 4 FoV", (512, 512, 128), 4, "fov"),  # an evaluate_records chunk
    ("config-4 x 1", (512, 512, 128), 1, None),  # Estimate.grid_eval
    ("keogram 65536 x 512", (256, (262.0,), 256), 512, None),  # a day's meridian
)
# (maxl, maxk) orders whose instantiations the production order does not
# run: no sin branch (maxl 1), maxk bucket 12, and the tiled kernel at
# four float4s a coefficient row (maxl 10, maxk 16).  Each is held against
# the twin on ORDER_AXES, a ragged point count (a partial last tile), with
# and without its last point (grid_eval.cu's scalar and vector paths).
ORDER_CASES = ((1, 1), (2, 9), (10, 16))
ORDER_AXES, ORDER_NREC = (13, 17, 19), 5
# phase 11: BASELINE config 3, the lmax=10 x 12 radial basis (nbasis 1200,
# tests/test_highorder.py's HI_CFG) on the seed-1 day, against the JAX CPU
# float64 oracles of scripts/window_oracle.py highorder_*: the whole day in
# exact mode and in GCV, each held on its first and last chunk
# (HI_DAY_WINDOWS); the windows of HI_WINDOWS.  At 580 points every record is
# underdetermined; the fits are held to the fit bars above, lobo_cv's
# argmin to the oracle's and its per-entry median to about three times the
# CPU port's distance (phase_highorder_lobo("cpu") on an 8-core CPU:
# 3.4120e-3 on 4 records, 3.0930e-3 on the 2 of TIME_CUTS; the columns at
# log10 alpha -29..-26, where the leave-one-out systems keep modes at the
# gelsd cutoff, 0.026-0.083)
HI_ORDER = (10, 12)  # (maxl, maxk)
HI_NREC, HI_LOBO_NREC, HI_PRODUCT_NREC = 128, 2, 8
HI_TAIL = 896
# phase 11 (b): (oracle tag, REGULARIZATION_METHOD, REGPARAM_MODE, records)
HI_EXACT_GRID_NREC = 4
HI_WINDOWS = (("fast", "chi2", "fast", 128),
              ("manual", "manual", "exact", 128),
              ("exact_grid", "chi2", "exact_grid", HI_EXACT_GRID_NREC))
# phase 11 (a) and (g): the day's oracle windows by REGULARIZATION_METHOD,
# (oracle tag, first record, records or None for the oracle's): the first
# chunk and the last (104 records, padded to 128 on the card); GCV's
# oracles are a JAX CPU search of 32 records each (~21 min on 3 cores)
HI_DAY_WINDOWS = {"chi2": (("exact", 0, None), ("exact_tail", HI_TAIL, None)),
                  "gcv": (("gcv", 0, None), ("gcv_tail", 968, None))}
# phase 11 (g): the peak device memory of GCV on the day's first 32
# records (one card batch of 128) before the objective took its records in
# regparam.GCV_SLICE_BYTES slices (five candidates x 128 records of 1200 x
# 1200 a tensor; PERF.md §2), which the day stays under
GCV_WINDOW_PEAK_GIB = 56.6
# phase 11 (c): the day's meridian keogram, HI_KERNEL_SHAPES' axes
HI_KEOGRAM = (256, (262.0,), 256)
# depth cuts so that the whole run keeps inside its 1200 s limit beside
# phase 11 (g)'s GCV day, printed at the start: (what, records, records
# before the cut).  The fast window keeps its 128 records: the card pads a
# shorter window to 128 and decomposes as many
TIME_CUTS = (("phase 11 (b): exact_grid", HI_EXACT_GRID_NREC, 8),
             ("phase 11 (d): lobo_cv", HI_LOBO_NREC, 4))
# page-locked buffers solve.host_eigh may hold at once: a slice's matrices
# and its results, and the results of the slice before on their way to the
# card, in each of calc_coeffs' two calling threads (the search's and the
# look-ahead worker's)
PINNED_SLICES = 2 * 3
HI_SWEEP = np.linspace(-40.0, 0.0, 15)  # test_highorder.py's lambda sweep
HI_SWEEP_SLACK = 0.02  # and its slack, plus 1e-6 of the largest value
HI_ORACLE_TOL = 2e-7  # of each column's sup where scipy does not underflow
HI_LOBO_ENTRY_MEDIAN_TOL = 1e-2
# phase 6: the radbasfun day at the JAX package's [MODEL] defaults (EPS =
# 1e5 m, LATRANGE 74,80, LONRANGE 260,285, ALTRANGE 100,600 km, NUMGRIDPNT
# = 7), no regularization (scripts/window_oracle.py radbasfun)
RBF_CFG = """
[DEFAULT]
FILENAME = {raw}
OUTPUTFILENAME =
REGULARIZATION_LIST =
REGULARIZATION_METHOD = chi2
[MODEL]
NAME = radbasfun
"""
# phase 7 (scripts/window_oracle.py lobo): every decomposition through
# solve.host_eigh, LAPACK syevd as in the JAX package's CPU eigh.  The bars
# are the CPU port's distance from the oracle with a margin
# (scripts/lobo_spread.py: per-entry median 3.6382e-2, summed scores by
# order 1e-6 at (2,3), 0.300978 at (3,5), 0.134119 at (4,6)); the same
# statistics under scipy's MRRR eigh read 0.16736 and 2.656049 at (3,5)
# against syevd: the leave-one-out systems at small alpha carry modes at
# the gelsd cutoff, so the LAPACK routine, not only the float64
# arithmetic, sets the scores there
LOBO_NREC = 64
LOBO_ENTRY_MEDIAN_TOL = 0.05
LOBO_SUM_TOL = {(2, 3): 1e-2, (3, 5): 0.5, (4, 6): 0.5}
# phase 8: the JAX package's sharding bars (chi2 rtol 1e-3, log10 alpha
# 1e-3, fast alphas rtol 1e-6, field 1e-3 of the sup).  Every layout is
# held to them against its split_fit, and fast against the whole batch
# too.  Exact is held to the day bars against the whole batch: a record
# batch of another size moves some of its roots on the card along the
# production order's cutoff staircase (scripts/fit_witness.py, every
# site on the host: 6 of 64 in two batches of 32, up to 0.16 decades,
# chi2 3.6e-2, field 2.2e-2 of the sup; fast by 1e-11), and the roots
# that moved are printed (PERF.md)
SHARD_TOL = 1e-3
# host eighs a record of the exact search (AtWA's, the whitened pencil's,
# the seed and endgame anchors'); R's once a run
EXACT_EIGHS = 4
# host eighs a record of a whole-day fit in exact mode by
# REGULARIZATION_METHOD, R's once a run beside them: the chi2 search's
# EXACT_EIGHS; GCV's AtWA and final solve
DAY_EIGHS = {"chi2": EXACT_EIGHS, "gcv": 2}
SITE = (74.72955, 265.09424)  # the synthetic day's radar (io/synth.py)
# phase 10: (a) the design path's points and bar; (b) the band around the
# hull threshold where the host and the card may disagree; (c) the
# reference-API problem of tests/test_api_surface.py (random design, weight
# 100) at nbasis 144 and 580 points, with coefficients of scale API_TAU
# under noise API_NOISE and the matrix I + 0.1 at a scale that puts the GCV
# minimum two decades from the search's start (log10 alpha -17.85) and the
# chi2 = nu root inside the bracket (-16.42)
API_POINTS = 10**6
HOST_ROUTE_CHUNK = 5000  # points, a chunk of the host route (_host_route)
DESIGN_TOL = 1e-11  # of each column's sup
HULL_BAND = 1e-12  # of the hull's scale, max |facet offset|
API_CFG = "[DEFAULT]\nREGULARIZATION_LIST = 0thorder\n" + MODEL_CFG
API_NPTS, API_SEED = 580, 12
API_TAU, API_NOISE, API_SCALE = 0.05, 0.07, 1e20
API_EVAL_ALPHA = 1e-18
API_ALPHAS = (-19.0, -17.0, -16.0)
# NVIDIA's H100 SXM data sheet: float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
try:
    import h5py  # noqa: F401
    HAVE_H5PY = True
except ImportError:
    HAVE_H5PY = False


CARD = "cpu"  # nvidia-smi's name and power limit, once phase 1 has run


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps):
    """Mean device milliseconds per call of fn, by CUDA events, warmed up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def grid(nlat, nlon, nalt):
    """The product grid: nlat x nlon x nalt over the FoV's box; nlon may be
    a sequence of longitudes (a meridian keogram)."""
    lons = np.linspace(252.0, 272.0, nlon) if np.isscalar(nlon) else nlon
    return np.meshgrid(np.linspace(74.0, 82.0, nlat), lons,
                       np.linspace(1.0e5, 6.0e5, nalt))


def fov_like_mask(lat, lon, alt, frac=FINITE_FRAC):
    """Points inside a cone about the vertical at the synthetic radar's
    site, opened so that ``frac`` of the points are inside: the FoV's shape
    (a cone from the ground, entered along altitude, the fastest grid axis,
    in one run) at the config-4 grid's finite fraction, without the host
    hull test.  A sphere of radius RE is close enough for a mask."""
    from volumetricinterp_tpu_torch.constants import RE

    def unit(la, lo):
        la, lo = torch.deg2rad(la), torch.deg2rad(lo)
        return torch.stack([torch.cos(la) * torch.cos(lo),
                            torch.cos(la) * torch.sin(lo), torch.sin(la)], -1)

    up = unit(*torch.tensor(SITE, dtype=torch.float64, device=lat.device))
    v = (RE + alt.double())[:, None] * unit(lat.double(), lon.double()) - RE * up
    cos_off = (v @ up) / v.norm(dim=-1)
    k = int(round((1.0 - frac) * cos_off.numel()))
    return cos_off > cos_off.sort().values[k]


def kernel_work(ev, npts, nrec, n_live, masked):
    """(flop, bytes) the evaluation needs at these inputs, whatever the
    implementation: per live point (in the band and the mask) the pair
    series, one FMA per coefficient each pair's degree keeps plus degree - 2
    for the T_d recurrence; per live point-record the contraction, one FMA
    per basis function (the [points x nbasis] x [nbasis x nrec] product);
    every input byte read once (lat/lon/alt float32, the uint8 mask, the
    band table and the records' coefficients) and every output written
    once."""
    series = int(np.sum(ev.pair_degree)) + max(ev.degree - 2, 0)
    flop = 2 * n_live * (series + nrec * ev.model.nbasis)
    nbytes = (npts * (12 + int(masked) + 4 * nrec)
              + 4 * ev.degree * ev.npairs + 4 * nrec * 2 * ev.npairs * ev.maxk)
    return flop, nbytes


def bound_ms(flop, nbytes):
    """The least time the card could take: (ms, what sets it)."""
    t_ops, t_bytes = flop / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def model_cfg(order=None):
    """MODEL_CFG, at another (maxl, maxk) when ``order`` is given."""
    if order is None:
        return MODEL_CFG
    return MODEL_CFG.replace("MAXK = 4", f"MAXK = {order[1]}").replace(
        "MAXL = 6", f"MAXL = {order[0]}")


def kernel_inputs(axes, nrec, mask, device, seed=0, order=None, Cs=None):
    """One phase 3 case, at the production order unless ``order`` is
    given: (evaluator, float32 and float64 points, float32 and float64
    folded records, mask or None).  The records are random (``seed``)
    unless ``Cs`` [nrec, nbasis] is given."""
    model = Model(Config.from_text(model_cfg(order)))
    glat, glon, galt = grid(*axes)
    _, t, _ = np_geodetic_to_cap(glat.ravel(), glon.ravel(), galt.ravel(),
                                 model.latcp, model.loncp)
    ev = GridEvaluator(model, (t.min(), t.max()), device=device)
    if Cs is None:
        Cs = np.random.default_rng(seed).normal(
            size=(nrec, model.nbasis)) * 1e11
    pts64 = [torch.as_tensor(a.ravel(), dtype=torch.float64, device=device)
             for a in (glat, glon, galt)]
    pts32 = [p.float() for p in pts64]
    inside = fov_like_mask(*pts64) if mask == "fov" else None
    return (ev, pts32, pts64, ev.fold_coeffs(Cs),
            ev.fold_coeffs(Cs, torch.float64), inside)


def held_against_twin(out, ref, what):
    """Max |kernel - float64 twin| of the live points, checked against
    KERNEL_TOL x sup; the NaN sets must be equal."""
    nan, nan_ref = torch.isnan(out), torch.isnan(ref)
    check(torch.equal(nan, nan_ref), f"{what}: kernel and twin NaN sets differ")
    ok = ~nan_ref
    sup = float(ref[ok].abs().max())
    err = float((out.double() - ref)[ok].abs().max())
    check(err <= KERNEL_TOL * sup,
          f"{what}: kernel error {err:.3e} > {KERNEL_TOL} x sup {sup:.3e}")
    return err, sup


def phase_device():
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global CARD
    CARD = smi.splitlines()[0]
    print(CARD)
    print(f"phase 1 device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, allow_tf32 "
          f"matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)


def ptxas_usage(log):
    """(registers, bytes of spill stores) of the kernel in an nvcc -v log."""
    regs = [int(w) for line in log.splitlines() if "Used" in line
            for w, nxt in zip(line.split(), line.split()[1:])
            if nxt.startswith("registers")]
    spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", log))
    return max(regs, default=0), spills


def phase_build():
    """Builds the instantiations of the production order, of ORDER_CASES
    and of HI_ORDER (phase 11), from both sources, one nvcc each, all
    started together (no later phase builds another)."""
    model = Model(Config.from_text(MODEL_CFG))
    cfgs = [grid_eval_cuda.kernel_config(model.maxl, model.maxk)]
    cfgs += [grid_eval_cuda.kernel_config(*o)
             for o in ORDER_CASES + (HI_ORDER,)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cfgs)) as pool:
        infos = list(pool.map(grid_eval_cuda.build, cfgs))
    wall = time.perf_counter() - t0
    for info in infos:
        log = Path(info["log"])
        check(log.exists(), f"no ptxas log beside {info['path']}")
        regs, spills = ptxas_usage(log.read_text())
        cfg = info["config"]
        print(f"phase 2 build: {cfg.source.name}, maxl {cfg.maxl}, maxk "
              f"bucket {cfg.maxkb}, " + ("" if cfg.tiled else
                                         f"{cfg.pt} points a thread, ")
              + f"{cfg.minblocks} blocks an SM: "
              f"{info['seconds']:.1f} s nvcc, {regs} registers, {spills} "
              f"bytes of spill stores ({log.relative_to(ROOT)})", flush=True)
    print(f"phase 2 build: {len(infos)} instantiations in {wall:.1f} s",
          flush=True)


def phase_kernel(device="cuda", shapes=KERNEL_SHAPES, reps=20):
    """Kernel vs plain twin at each shape; returns the kernel's JSON entry,
    with the times and bound of the first shape."""
    cuda = device == "cuda"
    entry = None
    for label, axes, nrec, mask in shapes:
        ev, pts32, pts64, ceff32, ceff64, inside = kernel_inputs(
            axes, nrec, mask, device)
        npts = pts32[0].numel()
        out = grid_eval_cuda.eval_records(*pts32, ceff32, ev, inside)
        ref = grid_eval_cuda.eval_records_plain(*pts64, ceff64, ev, inside)
        err, sup = held_against_twin(out, ref, label)
        n_live = int((~torch.isnan(ref[0])).sum())
        if entry is None:
            # every 7th point masked out as well: point groups that are
            # partly masked keep the NaN set of the twin
            seventh = torch.arange(npts, device=device) % 7 != 0
            ref7 = torch.where(seventh, ref, float("nan"))
            out7 = grid_eval_cuda.eval_records(*pts32, ceff32, ev, seventh)
            held_against_twin(out7, ref7, f"{label}, every 7th point masked")
            check(int(torch.isnan(out7).sum()) == nrec * int((~seventh).sum()),
                  "unexpected NaNs")
            # the kernel's scalar path: an odd count at a 4-byte offset
            tail = grid_eval_cuda.eval_records(*[p[1:] for p in pts32], ceff32,
                                               ev, seventh[1:])
            held_against_twin(tail, ref7[:, 1:], f"{label}, points 1..")
            # a point's arithmetic does not depend on its group (the CPU
            # twin's matmuls do, so this holds the kernel only)
            check(not cuda or torch.equal(
                tail.view(torch.int32), out7[:, 1:].contiguous().view(torch.int32)),
                f"{label}: points 1.. differ from the same points in the grid")
        flop, nbytes = kernel_work(ev, npts, nrec, n_live, inside is not None)
        b_ms, b_by = bound_ms(flop, nbytes)
        ms = cuda_ms(lambda: grid_eval_cuda.eval_records(
            *pts32, ceff32, ev, inside), reps) if cuda else float("nan")
        line = (f"phase 3 kernel, {label}: {npts} points x {nrec} records"
                f"{', FoV-like mask' if inside is not None else ''}, degree "
                f"{ev.degree}, {n_live} live points: kernel {ms:.4f} ms "
                f"({npts * nrec / ms * 1e3:.4e} point-records/s); work "
                f"{flop:.4e} flop, {nbytes:.4e} bytes, bound {b_ms:.4f} ms "
                f"({b_by}), share {b_ms / ms:.3f}; max|kernel - f64 twin| = "
                f"{err:.4e} = {err / sup:.3e} of sup {sup:.4e} (bar "
                f"{KERNEL_TOL}), NaN sets equal")
        if entry is None:
            plain_ms = cuda_ms(lambda: grid_eval_cuda.eval_records_plain(
                *pts32, ceff32, ev, inside), 2) if cuda else float("nan")
            plain64_ms = cuda_ms(lambda: grid_eval_cuda.eval_records_plain(
                *pts64, ceff64, ev, inside), 1) if cuda else float("nan")
            line += f"; f32 twin {plain_ms:.4f} ms, f64 twin {plain64_ms:.4f} ms"
            entry = {"name": "grid_eval_records", "route": "cuda",
                     "source": "volumetricinterp_tpu_torch/csrc/grid_eval.cu",
                     "replaces": "volumetricinterp_tpu/ops/grid_eval_pallas.py:94",
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "share": b_ms / ms,
                     # no single PyTorch call computes this function
                     "library_ms": None}
        print(line, flush=True)
    for order in ORDER_CASES:
        ev, pts32, pts64, ceff32, ceff64, inside = kernel_inputs(
            ORDER_AXES, ORDER_NREC, None, device, order=order)
        npts = pts32[0].numel()
        seventh = torch.arange(npts, device=device) % 7 != 0
        ref = torch.where(seventh, grid_eval_cuda.eval_records_plain(
            *pts64, ceff64, ev), float("nan"))
        errs = []
        for n in (npts, npts - 1):  # odd: scalar path; even: vector path
            out = grid_eval_cuda.eval_records(*[p[:n] for p in pts32], ceff32,
                                              ev, seventh[:n])
            errs.append(held_against_twin(out, ref[:, :n].contiguous(),
                                          f"order {order}, {n} points"))
        cfg = grid_eval_cuda.kernel_config(*order)
        print(f"phase 3 kernel, order (maxl, maxk) = {order}: {npts} and "
              f"{npts - 1} points x {ORDER_NREC} records, every 7th masked, "
              f"degree {ev.degree}, {cfg.source.name}"
              + ("" if cfg.tiled else f", {cfg.pt} points a thread")
              + ": max|kernel - "
              f"f64 twin| = " + ", ".join(f"{e / s:.3e}" for e, s in errs)
              + f" of sup (bar {KERNEL_TOL}), NaN sets equal", flush=True)
    return entry


_DAYS = {}  # the in-memory synthetic days, made once a run


def fit_day(workdir, device, method, mode, nwin=None, day=DAY, cli=False,
            extra=""):
    """Fit the synthetic day's first nwin records (all when None) in one
    setting (``extra``: more [DEFAULT] lines).  With h5py the day is an
    AMISR file and the coefficients a file, fitted through cli.main when
    ``cli``; without, the same classes run on in-memory data.  Returns a
    dict: the Interpolate (its read_datafile and model serve the checks;
    its ``independent`` holds the per-record fits before any time
    coupling), C, chi2, reg, est (the result's Estimate), the seconds of
    the synthetic day, of the fit (calc_coeffs or cli.main) and of
    fit_records, eigh (matrices the fit decomposed), host_eigh and host_s
    (those of them decomposed on the host, and those calls' seconds) and
    guarded (records whose negative chi2 was reported as the whitened
    chi2)."""
    seed = day["seed"]
    raw = workdir / f"day{seed}.h5"
    tag = "timeaxis_" if extra else ""
    out = workdir / f"coef_{tag}{method}_{mode}_{seed}.h5" if HAVE_H5PY else ""
    text = FIT_CFG.format(raw=raw, out=out, method=method, mode=mode,
                          extra=extra)
    model = Model(Config.from_text(text))
    t0 = time.perf_counter()
    if HAVE_H5PY and not raw.exists():
        write_synthetic_amisr(str(raw), smooth_in_model=model, **day)
    if not HAVE_H5PY:
        data = day_data(day)

    class SmokeInterpolate(Interpolate):
        def _run_fit_pipeline(self, *args, **kw):
            self.independent = super()._run_fit_pipeline(*args, **kw)
            return self.independent

        if not HAVE_H5PY:
            def read_datafile(self, filename):
                return qc_datasets(data, self.param, self.errlim,
                                   self.chi2lim, self.goodfitcode)

    interp = SmokeInterpolate(text, device=device)
    synth_s = time.perf_counter() - t0

    start = end = None
    if nwin is not None:
        start = EPOCH + dt.timedelta(seconds=day["t0"])
        end = start + dt.timedelta(seconds=day["cadence"] * nwin)
    eigh0, neg0 = solve.eigh_matrices, ops_fit.negative_chi2_reports
    host0, host_s0 = solve.host_eigh_matrices, solve.host_eigh_seconds
    t0 = time.perf_counter()
    if cli and HAVE_H5PY:
        cfg = workdir / f"{method}_{mode}.ini"
        cfg.write_text(text)
        argv = [str(cfg), "--profile", "--device", device]
        if start is not None:
            argv += ["--starttime", start.isoformat(),
                     "--endtime", end.isoformat()]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli_main(argv)
        prof = {w[0]: float(w[1]) for w in map(str.split,
                                               buf.getvalue().splitlines())}
        res = load_coeff_file(str(out))
        C, chi2, reg = res["Coeffs"], res["chi2"], res["reg_params"][:, 0]
    else:
        interp.calc_coeffs(start, end)
        prof = interp.timer.report()
        C, chi2, reg = interp.Coeffs, interp.chi_sq, interp.reg_params[:, 0]
    if device == "cuda":
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    res = dict(interp=interp, C=C, chi2=chi2, reg=reg, synth_s=synth_s,
               fit_s=fit_s, fit_rec_s=prof["fit_records"], prof=prof,
               eigh=solve.eigh_matrices - eigh0,
               host_eigh=solve.host_eigh_matrices - host0,
               host_s=solve.host_eigh_seconds - host_s0,
               guarded=ops_fit.negative_chi2_reports - neg0)

    if HAVE_H5PY:
        if not cli:
            interp.saveh5()
        res["est"] = Estimate(str(out), device=device)
        return res

    res["est"] = mem_estimate(interp, device, str(raw))
    return res


def mem_estimate(interp, device, raw):
    """An Estimate of a fitted Interpolate's arrays, no file."""
    class MemEstimate(Estimate):
        def loadh5(self, filename=None):
            self.Coeffs, self.Covariance = interp.Coeffs, interp.Covariance
            self.time, self.hull_vert = interp.time, interp.hull_vert
            self.config_file_text = interp.config.raw_text
            self.chi2, self.raw_filename = interp.chi_sq, raw

    return MemEstimate(None, device=device)


def day_data(day=DAY):
    """The day's in-memory datasets (made once a run), with the production
    model as its smooth-in model, as fit_day makes it."""
    key = json.dumps(day, sort_keys=True)
    if key not in _DAYS:
        _DAYS[key] = synthetic_amisr_datasets(
            smooth_in_model=Model(Config.from_text(MODEL_CFG)), **day)
    return _DAYS[key]


def oracle_day(nrec):
    """The seed-1 day's QC'd value and error as the JAX oracles saw them
    (stored with tests/oracle/day1000_seed1_timeaxis.npz): the synthetic
    day's projection of its truth follows the LAPACK build in its last bits
    (PERF.md, PR 4), so phases 6 and 7 feed the oracles' own bytes."""
    o = np.load(ROOT / "tests" / "oracle" / "day1000_seed1_timeaxis.npz")
    return o["value"][:nrec], o["error"][:nrec]


def qc(data):
    """qc_datasets of the day at FIT_CFG's [DEFAULT] QC settings."""
    return qc_datasets(data, "dens", [1e10, 1e13], [0.1, 10.0], [1, 2, 3, 4])


def wfield(fit, C_ref, nwin, start=0):
    """The W-weighted field residual of the fit's nwin records from
    ``start`` against C_ref (docs/PARITY_NOTES.md #7): |sw A (C - C_ref)| /
    |sw A C_ref| per record, sw = 1/error on the record's valid points; NaN
    on the records C_ref leaves NaN."""
    interp = fit["interp"]
    _, lat, lon, alt, value, error = interp.read_datafile(interp.filename)
    A = interp.model.basis(lat, lon, alt)
    rows = slice(start, start + nwin)
    ok = np.isfinite(value[rows])
    sw = ok / np.where(ok, error[rows], 1.0)
    C = fit["C"][rows]
    return (np.linalg.norm(sw * ((C - C_ref) @ A.T), axis=1)
            / np.linalg.norm(sw * (C_ref @ A.T), axis=1))


def window_oracle(tag, nwin):
    o = np.load(ROOT / "tests" / "oracle" / f"day1000_seed1_window64_{tag}.npz")
    return o["C"][:nwin], o["chi2"][:nwin], o["reg"][:nwin, 0]


def held_to_bars(what, vals, median_tol, max_tol):
    """Checks median and max of vals (NaN entries left out); returns both."""
    v = vals[np.isfinite(vals)]
    med, mx = float(np.median(v)), float(v.max())
    check(med <= median_tol and mx <= max_tol,
          f"{what}: median {med:.3e} (bar {median_tol}), max {mx:.3e} (bar "
          f"{max_tol}, record {int(np.nanargmax(vals))})")
    return med, mx


def dlog10(a, b):
    """|log10 a - log10 b| on the records where both are positive."""
    ok = (a > 0) & (b > 0)
    return np.abs(np.log10(a[ok]) - np.log10(b[ok]))


def fitted(nrec, device):
    """The records a fit of nrec records in Interpolate's chunks decomposes:
    on the card each chunk padded to a multiple of solve.CARD_BATCH
    (ops/fit.prepare_stats)."""
    if device != "cuda":
        return nrec
    return sum(-(-n // solve.CARD_BATCH) * solve.CARD_BATCH
               for n in chunk_sizes(nrec))


def chunk_sizes(nrec):
    """Interpolate's record chunks: min(nrec, 128) records each."""
    chunk = min(nrec, 128)
    return [min(chunk, nrec - s) for s in range(0, nrec, chunk)]


def check_eighs(what, fit, want):
    """Every matrix the fit decomposed went through the host route
    (solve.host_eigh), ``want`` of them: none on the card."""
    check(fit["eigh"] == fit["host_eigh"] == want,
          f"{what}: {fit['eigh'] - fit['host_eigh']} eighs on the card, "
          f"{fit['host_eigh']} on the host; 0 and {want} expected")


def eighs_line(fit, nrec, device):
    """The fit's eighs a record, card and host, and the host's seconds."""
    return (f"eighs a record: card {(fit['eigh'] - fit['host_eigh']) / nrec:.3f}"
            f", host {fit['host_eigh'] / nrec:.3f} ({fitted(nrec, device)} "
            f"records with the card's padding; {fit['host_s']:.3f} s in "
            f"host_eigh)")


def grid_eighs(interp, nwin, device, reg, start=0):
    """The host eighs of an exact_grid fit of nwin records from ``start``
    (regparam.chi2_reg_param_grid): the 101 grid points of each record
    with points (the card's padding and an empty record have none), 40
    bisection rounds for each root, the final solve of each record, the
    padding's too."""
    value = interp.read_datafile(interp.filename)[4][start:start + nwin]
    live = int(np.isfinite(value).any(1).sum())
    return (regparam.N_GRID * live + fitted(nwin, device)
            + regparam.N_BISECT * int((reg > 0).sum()))


def phase_fit(workdir, device="cuda", nwin=64, day=DAY):
    """Phase 4, exact_grid over the first nwin records."""
    fit = fit_day(workdir, device, "chi2", "exact_grid", nwin, day)
    chi2, reg, C = fit["chi2"], fit["reg"], fit["C"]
    check(chi2.shape == (nwin,) and C.shape == (nwin, 144),
          f"fit shapes {chi2.shape} {C.shape}")
    check(np.isfinite(chi2).all() and (reg > 0).all() and np.isfinite(C).all(),
          "non-finite fit records")
    check((chi2 >= 0).all(), "negative chi2")
    oracle = np.load(ROOT / "tests" / "oracle" / "day1000_seed1_oracle.npz")
    check(np.array_equal(np.isnan(chi2), np.isnan(oracle["chi2"][:nwin])),
          "NaN set differs from the oracle")
    rel = np.abs(chi2 - oracle["chi2"][:nwin]) / oracle["chi2"][:nwin]
    dla = dlog10(reg, oracle["reg"][:nwin, 0])
    held_to_bars("chi2 vs the exact oracle", rel, CHI2_MEDIAN_TOL,
                 CHI2_MAX_TOL)
    # the data-determined metric against the exact_grid window oracle
    C_o, chi2_o, reg_o = window_oracle("exact_grid", nwin)
    wf = wfield(fit, C_o, nwin)
    rel_g = np.abs(chi2 - chi2_o) / chi2_o
    dla_g = dlog10(reg, reg_o)
    held_to_bars("W-weighted field vs the exact_grid oracle", wf,
                 WFIELD_MEDIAN_TOL, WFIELD_MAX_TOL)
    check(rel_g.max() <= CHI2_MAX_TOL, f"chi2 vs the exact_grid oracle: max "
          f"{rel_g.max():.3e} (record {int(rel_g.argmax())})")
    # on the host the 101 grid points of a record with points, 40
    # bisection rounds a record with a root, and the final solve of every
    # record and of the card's padding; none on the card
    want = grid_eighs(fit["interp"], nwin, device, reg)
    check_eighs("exact_grid", fit, want)
    fit_rec_s = fit["fit_rec_s"]
    print(f"phase 4 fit: h5py: {'present' if HAVE_H5PY else 'absent'}; "
          f"synthetic day {fit['synth_s']:.2f} s; calc_coeffs({nwin} records, "
          f"exact_grid) {fit['fit_s']:.3f} s, of which fit_records "
          f"{fit_rec_s:.3f} s = {nwin / fit_rec_s:.3f} records/s; "
          f"{eighs_line(fit, nwin, device)}; 0 NaN, 0 negative chi2; "
          f"vs exact oracle: chi2 rel median {np.median(rel):.4e} max "
          f"{rel.max():.4e}, |dlog10 alpha| median {np.median(dla):.4e} max "
          f"{dla.max():.4e}; vs exact_grid oracle: W-weighted field rel "
          f"median {np.median(wf):.4e} max {wf.max():.4e}, chi2 rel median "
          f"{np.median(rel_g):.4e} max {rel_g.max():.4e}, |dlog10 alpha| "
          f"median {np.median(dla_g):.4e} max {dla_g.max():.4e}", flush=True)
    return fit["est"]


def phase_fit_default(workdir, device="cuda", nwin=64, day=DAY):
    """Phase 4b, the shipped default (chi2, exact) over the whole day;
    returns its Estimate for phase 5."""
    fit = fit_day(workdir, device, "chi2", "exact", None, day, cli=True)
    nrec = day["nrec"]
    chi2, reg, C = fit["chi2"], fit["reg"], fit["C"]
    check(chi2.shape == (nrec,) and C.shape == (nrec, 144),
          f"fit shapes {chi2.shape} {C.shape}")
    oracle = np.load(ROOT / "tests" / "oracle" / "day1000_seed1_oracle.npz")
    nan = np.isnan(chi2)
    check(np.array_equal(nan, np.isnan(oracle["chi2"][:nrec])),
          "NaN set differs from the oracle")
    check(np.isfinite(C[~nan]).all(), "non-finite coefficients")
    check((chi2[~nan] >= 0).all(),
          f"{int((chi2[~nan] < 0).sum())} negative chi2")
    rel = np.abs(chi2 - oracle["chi2"][:nrec]) / oracle["chi2"][:nrec]
    rel_med, rel_max = held_to_bars("chi2 vs the exact oracle", rel,
                                    DAY_CHI2_MEDIAN_TOL[day["seed"]],
                                    CHI2_MAX_TOL)
    dla = dlog10(reg, oracle["reg"][:nrec, 0])
    C_o, chi2_o, reg_o = window_oracle("exact", nwin)
    wf_med, wf_max = held_to_bars(
        "W-weighted field vs the exact window oracle",
        wfield(fit, C_o, nwin), WFIELD_MEDIAN_TOL, WFIELD_MAX_TOL)
    dla_w = dlog10(reg[:nwin], reg_o)
    check_eighs("exact", fit, EXACT_EIGHS * fitted(nrec, device) + 1)
    print(f"phase 4b fit, exact (the shipped default): "
          f"{'cli.main' if HAVE_H5PY else 'Interpolate.calc_coeffs (h5py absent)'}"
          f" on the whole {nrec}-record day: {fit['fit_s']:.3f} s, of which "
          f"fit_records {fit['fit_rec_s']:.3f} s = "
          f"{nrec / fit['fit_rec_s']:.3f} records/s; "
          f"{eighs_line(fit, nrec, device)}; "
          f"{int(nan.sum())} NaN as the oracle, 0 negative "
          f"chi2 ({fit['guarded']} records reported the whitened chi2 at "
          f"the root for a negative one); vs exact oracle: chi2 rel median {rel_med:.4e} max "
          f"{rel_max:.4e}, |dlog10 alpha| median {np.median(dla):.4e} max "
          f"{dla.max():.4e}; first {nwin} vs exact window oracle: W-weighted "
          f"field rel median {wf_med:.4e} max {wf_max:.4e}, |dlog10 alpha| "
          f"median {np.median(dla_w):.4e} max {dla_w.max():.4e}", flush=True)
    return fit["est"]


def day_oracle(seed):
    """The JAX package's CPU float64 exact fit of the seed's day
    (scripts/day_check.py --oracle --seed N): chi2 and reg."""
    return np.load(ROOT / "tests" / "oracle" / f"day1000_seed{seed}_oracle.npz")


def phase_fit_fault(workdir, device="cuda", seeds=(2, 3), day=DAY):
    """Phase 4d: the whole seed-2 and seed-3 days in exact mode, each held
    to its day oracle's NaN set (the card's cuSOLVER AtWA eigh NaN-failed
    records 441, and 547 and 653, that the oracle fits), no negative chi2,
    and the chi2 bars."""
    for seed in seeds:
        fit = fit_day(workdir, device, "chi2", "exact", None,
                      dict(day, seed=seed))
        nrec = day["nrec"]
        chi2 = fit["chi2"]
        o = day_oracle(seed)
        nan = np.isnan(chi2)
        check(np.array_equal(nan, np.isnan(o["chi2"][:nrec])),
              f"seed {seed}: NaN records {np.flatnonzero(nan).tolist()}, the "
              f"oracle's {np.flatnonzero(np.isnan(o['chi2'])).tolist()}")
        check((chi2[~nan] >= 0).all(),
              f"seed {seed}: {int((chi2[~nan] < 0).sum())} negative chi2")
        rel = np.abs(chi2 - o["chi2"][:nrec]) / o["chi2"][:nrec]
        med, mx = held_to_bars(f"seed {seed}: chi2 vs its day oracle", rel,
                               DAY_CHI2_MEDIAN_TOL[seed], CHI2_MAX_TOL)
        check_eighs(f"seed {seed}", fit,
                    EXACT_EIGHS * fitted(nrec, device) + 1)
        dla = dlog10(fit["reg"], o["reg"][:nrec, 0])
        print(f"phase 4d fit, exact, seed {seed}, the whole {nrec}-record "
              f"day: calc_coeffs {fit['fit_s']:.3f} s, fit_records "
              f"{fit['fit_rec_s']:.3f} s = {nrec / fit['fit_rec_s']:.3f} "
              f"records/s; {eighs_line(fit, nrec, device)}; "
              f"{int(nan.sum())} NaN as the oracle, 0 negative chi2 "
              f"({fit['guarded']} reported the whitened chi2); vs its day "
              f"oracle: chi2 rel median {med:.4e} max {mx:.4e}, |dlog10 "
              f"alpha| median {np.median(dla):.4e} max {dla.max():.4e}",
              flush=True)


def phase_time_axis(workdir, device="cuda", day=DAY):
    """Phase 4e: the seed-1 day with TIME_AXIS_CFG against
    tests/oracle/day1000_seed1_timeaxis.npz.  Every number is printed
    before any is checked.

    The chi2 max bar of the independent fit is CHI2_MAX_TOL plus, per
    record, the reference's own spread between its fits of this day with
    and without the profile (tests/oracle/day1000_seed1_oracle.npz): at the
    roots the pull is a rounding-sized change of the normal equations, and
    on the cutoff-wall staircase it moves the JAX package's own chi2 by up
    to 0.229 (median 1.9e-2)."""
    fit = fit_day(workdir, device, "chi2", "exact", None, day,
                  extra=TIME_AXIS_CFG)
    interp, nrec = fit["interp"], day["nrec"]
    o = np.load(ROOT / "tests" / "oracle" / "day1000_seed1_timeaxis.npz")
    plain = day_oracle(day["seed"])["chi2"]
    C_ind, _, chi2_ind, rp = interp.independent
    field = lambda C, C_ref: wfield(dict(fit, C=C), C_ref, nrec)  # noqa: E731
    stat = lambda v: (float(np.nanmedian(v)), float(np.nanmax(v)))  # noqa: E731
    # the profile-pulled independent fit
    nan = np.isnan(chi2_ind)
    rel = np.abs(chi2_ind - o["chi2"]) / o["chi2"]
    spread = np.abs(o["chi2"] - plain) / plain
    c2, sp = stat(rel), stat(spread)
    over = np.flatnonzero(rel > CHI2_MAX_TOL)
    wf = stat(field(C_ind, o["C"]))
    # the joint solve alone, on the card, at the oracle's alphas and on the
    # statistics of the oracle's own data (the synthetic day projects its
    # truth by a least-squares solve at rcond 1e-10, whose last bits follow
    # the LAPACK build: this machine's day and the joint solve on its
    # statistics are printed beside)
    _, lat, lon, alt, value, error = interp.read_datafile(interp.filename)
    A = torch.as_tensor(interp.model.basis(lat, lon, alt), device=device)
    with np.errstate(divide="ignore", invalid="ignore"):
        la = torch.as_tensor(np.log10(np.where(o["reg"] > 0, o["reg"], 0.0)),
                             device=device)
        dvalue = float(np.nanmax(np.abs(value - o["value"])
                                 / np.abs(o["value"])))
    R = torch.as_tensor(interp._reg_matrices()["0thorder"][None],
                        device=device)
    beta = interp.config.fit.time_coupling
    wf_at = []
    for v, e in ((o["value"], o["error"]), (value, error)):
        t0 = time.perf_counter()
        AtWA, AtWb = timejoint.time_stats(
            *(torch.as_tensor(x, device=device) for x in (v, e)), A)
        C_at = timejoint.joint_time_solve(AtWA, AtWb, R, la,
                                          beta).cpu().numpy()
        joint_s = time.perf_counter() - t0
        wf_at.append(float(field(C_at, o["C_joint"]).max()))
    # the joint fit end to end, and the records it carries
    wf_j = stat(field(fit["C"], o["C_joint"]))
    carried = int((nan & np.isfinite(fit["chi2"])).sum())
    carried_o = int((np.isnan(o["chi2"]) & np.isfinite(o["chi2_joint"])).sum())
    # the time spline at the record mid-times
    tf = interp.timefit
    mt = np.mean(interp.time, axis=1)
    Cs = eval_time_spline(tf, mt)
    Cs_o = eval_time_spline({k: o[k] for k in ("knots", "S", "lam")}, mt)
    wf_s = stat(field(Cs, Cs_o))
    prof = fit["prof"]
    print(f"phase 4e fit, the time axis (REGULARIZATION_PROFILE = "
          f"chapman,1e11,300,50, TIME_COUPLING = 1e-4, TIME_SMOOTHING = gcv) "
          f"on the whole {nrec}-record day: calc_coeffs {fit['fit_s']:.3f} s, "
          f"fit_records {prof['fit_records']:.3f} s, time_coupled_solve "
          f"{prof['time_coupled_solve']:.3f} s, time_spline "
          f"{prof['time_spline']:.3f} s; independent fit: {int(nan.sum())} "
          f"NaN (oracle {int(np.isnan(o['chi2']).sum())}), "
          f"{int((rp == 0).sum())} too smooth (oracle "
          f"{int((o['reg'] == 0).sum())}), {int((chi2_ind < 0).sum())} "
          f"negative chi2, chi2 rel median {c2[0]:.4e} max {c2[1]:.4e} (over "
          f"{CHI2_MAX_TOL}: records {over.tolist()} at "
          f"{np.round(rel[over], 4).tolist()}, the reference's own spread "
          f"there {np.round(spread[over], 4).tolist()}; spread median "
          f"{sp[0]:.4e} max {sp[1]:.4e}), W-weighted field median "
          f"{wf[0]:.4e} max {wf[1]:.4e}; joint solve at the oracle's alphas "
          f"({joint_s:.3f} s with its statistics): W-weighted field max "
          f"{wf_at[0]:.4e} on the oracle's data (bar {JOINT_TOL}), "
          f"{wf_at[1]:.4e} on this machine's day (values within {dvalue:.3e} "
          f"relative of the oracle's); joint fit: field median "
          f"{wf_j[0]:.4e} max {wf_j[1]:.4e}, {carried} NaN-filled records "
          f"carried (oracle {carried_o}); spline (lam {tf['lam']:.4g}, oracle "
          f"{float(o['lam']):.4g}, {tf['S'].shape[0]} coefficients a "
          f"trajectory): field median {wf_s[0]:.4e} max {wf_s[1]:.4e}",
          flush=True)
    check(np.array_equal(nan, np.isnan(o["chi2"])),
          "independent fit: NaN set differs from the oracle's")
    check((chi2_ind[~nan] >= 0).all(), "independent fit: negative chi2")
    check(np.array_equal(rp == 0, o["reg"] == 0),
          "independent fit: too-smooth records differ from the oracle's")
    check(c2[0] <= CHI2_MEDIAN_TOL and np.all(
        rel[~nan] <= CHI2_MAX_TOL + spread[~nan]),
        "independent fit: chi2 vs the oracle beyond its bars")
    check(wf[0] <= WFIELD_MEDIAN_TOL and wf[1] <= WFIELD_MAX_TOL,
          "independent fit: W-weighted field beyond its bars")
    check(wf_at[0] <= JOINT_TOL, "joint solve at the oracle's alphas: "
          f"W-weighted field beyond {JOINT_TOL}")
    check(np.isfinite(fit["C"]).all(), "joint fit: non-finite coefficients")
    check(wf_j[0] <= WFIELD_MEDIAN_TOL and wf_j[1] <= WFIELD_MAX_TOL,
          "joint fit: W-weighted field beyond its bars")
    check(carried == carried_o, "joint fit: carried records differ")
    check(wf_s[0] <= WFIELD_MEDIAN_TOL and wf_s[1] <= WFIELD_MAX_TOL,
          "time spline: W-weighted field beyond its bars")


def phase_fit_windows(workdir, device="cuda", nwin=64, day=DAY):
    """Phase 4c, the nwin-record window in fast mode and in gcv mode, each
    against its own window oracle."""
    for tag, method, mode, per_rec in (("fast", "chi2", "fast", 3),
                                       ("gcv", "gcv", "exact", 2)):
        fit = fit_day(workdir, device, method, mode, nwin, day)
        chi2, reg = fit["chi2"], fit["reg"]
        C_o, chi2_o, reg_o = window_oracle(tag, nwin)
        nan = np.isnan(chi2)
        check(np.array_equal(nan, np.isnan(chi2_o)),
              f"{tag}: NaN set differs from its window oracle")
        wf_med, wf_max = held_to_bars(
            f"{tag}: W-weighted field vs its window oracle",
            wfield(fit, C_o, nwin), WFIELD_MEDIAN_TOL, WFIELD_MAX_TOL)
        rel = (np.abs(chi2 - chi2_o) / chi2_o)[~nan]
        dla = dlog10(reg, reg_o)
        # on the host, fast: AtWA's, the whitened pencil's and the final
        # solve's a record; gcv: AtWA's and the final solve's, R's once
        check_eighs(tag, fit,
                    per_rec * fitted(nwin, device) + (method == "gcv"))
        print(f"phase 4c fit, {tag} (REGULARIZATION_METHOD = {method}, "
              f"REGPARAM_MODE = {mode}), {nwin} records: fit_records "
              f"{fit['fit_rec_s']:.3f} s = {nwin / fit['fit_rec_s']:.3f} "
              f"records/s, {eighs_line(fit, nwin, device)}; "
              f"{int(nan.sum())} NaN as its oracle, "
              f"{int((chi2[~nan] < 0).sum())} negative chi2; vs its window "
              f"oracle: W-weighted field rel median {wf_med:.4e} max "
              f"{wf_max:.4e}, chi2 rel median {np.median(rel):.4e} max "
              f"{rel.max():.4e}, |dlog10 alpha| median {np.median(dla):.4e} "
              f"max {dla.max():.4e} (printed, not held)", flush=True)


def phase_product(est, device="cuda", shape=(512, 512, 128), nrec=8,
                  finite_frac=FINITE_FRAC):
    """The product half; returns the kernel launches it made, the host FoV
    mask it built (numpy, the grid's shape) and the seconds of that host
    test (the cold call's grid_hull phase), for phase 10."""
    times = [EPOCH + dt.timedelta(seconds=float(t))
             for t in np.mean(est.time, axis=1)[:nrec]]
    glat, glon, galt = grid(*shape)
    before = grid_eval_cuda.launches
    t0 = time.perf_counter()
    vol = est.evaluate_records(times, glat, glon, galt, check_hull=True)
    cold_s = time.perf_counter() - t0
    launched = grid_eval_cuda.launches - before
    cold = est.timer.report()
    # the host FoV mask of the grid, before grid_eval below prepares another
    inside = est._prepared_grid["inside"].cpu().numpy().reshape(glat.shape)
    t0 = time.perf_counter()
    vol2 = est.evaluate_records(times, glat, glon, galt, check_hull=True)
    warm_s = time.perf_counter() - t0
    warm = {k: v - cold.get(k, 0.0) for k, v in est.timer.report().items()}
    check(vol.shape == (nrec,) + glat.shape and vol.dtype == np.float32,
          f"product shape {vol.shape} {vol.dtype}")
    check(np.array_equal(vol, vol2, equal_nan=True), "repeat call differs")
    ff = float(np.isfinite(vol).mean())
    if finite_frac is not None:
        check(abs(ff - finite_frac) <= 1e-3,
              f"finite fraction {ff:.4f} != {finite_frac} +- 0.001")
    # one record on 10^4 grid points: float32 grid_eval vs float64 __call__
    idx = np.random.default_rng(3).choice(glat.size, 10_000, replace=False)
    pts = [a.ravel()[idx] for a in (glat, glon, galt)]
    fast = est.grid_eval(times[0], *pts)
    exact = est(times[0], *pts)
    check(np.array_equal(np.isnan(fast), np.isnan(exact)),
          "grid_eval and __call__ NaN sets differ")
    check(np.array_equal(fast, vol[0].ravel()[idx], equal_nan=True),
          "grid_eval differs from evaluate_records")
    # float32 error model: a fitted production-order record cancels its
    # terms ~3e3-fold (sub-cutoff coefficient directions, PARITY_NOTES #8),
    # so the floor is float32 rounding of the GROSS sum sum_n |C_n B_n(x)|:
    # the TPU kernel (interpret mode) and this kernel's twin both measure
    # ~2e-4 of the sup on record 0 of this window, 5e-8 of the gross sum
    C0 = np.asarray(est.get_C(times[0])[0], np.float64)
    gross = np.abs(est.model.basis(*pts) * C0).sum(-1)
    fin = np.isfinite(exact)
    sup = np.max(np.abs(exact[fin]))
    diff = np.abs(fast - exact)[fin]
    check((diff <= GRID_TOL * sup + GROSS_TOL * gross[fin]).all(),
          f"grid_eval error {diff.max():.3e} beyond {GRID_TOL} x sup "
          f"{sup:.3e} + {GROSS_TOL} x gross")
    npts = glat.size * nrec
    print(f"phase 5 product: evaluate_records({nrec} records x {glat.size} "
          f"points, FoV mask) cold {cold_s:.3f} s ({npts / cold_s:.4e} "
          f"points/s: {_phases(cold)}), warm {warm_s:.3f} s ({npts / warm_s:.4e} "
          f"points/s: {_phases(warm)}); "
          f"finite fraction {ff:.4f}; grid_eval vs f64 __call__ at 10^4 "
          f"points ({int(fin.sum())} in the FoV): max {diff.max() / sup:.3e} "
          f"of sup, {np.max(diff / gross[fin]):.3e} of the gross sum; kernel "
          f"launches {launched}", flush=True)
    return {"launched": launched, "inside": inside,
            "grid_hull_s": cold["grid_hull"]}


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def _peak_gib(device):
    """Peak device memory since the last reset, GiB (nan off the card)."""
    if device != "cuda":
        return float("nan")
    return torch.cuda.max_memory_allocated() / 2**30


def _reset_peak(device):
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def phase_radbasfun(device="cuda", day=DAY, shape=(512, 512, 128), nrec=8,
                    finite_frac=FINITE_FRAC):
    """Phase 6: the radbasfun day through Interpolate.calc_coeffs against
    its JAX oracle, then its product on the config-4 grid."""
    data = day_data(day)
    value, error = oracle_day(day["nrec"])

    class RbfInterpolate(Interpolate):
        def read_datafile(self, filename):
            ut, lat, lon, alt, _, _ = qc_datasets(
                data, self.param, self.errlim, self.chi2lim, self.goodfitcode)
            return ut, lat, lon, alt, value, error

    _reset_peak(device)
    t0 = time.perf_counter()
    interp = RbfInterpolate(RBF_CFG.format(raw="day1.h5"), device=device)
    interp.calc_coeffs()
    _sync(device)
    fit_s = time.perf_counter() - t0
    fit_gib = _peak_gib(device)
    ndays, nb = day["nrec"], interp.model.nbasis
    C, chi2 = interp.Coeffs, interp.chi_sq
    check(C.shape == (ndays, 343) and nb == 343, f"radbasfun shapes {C.shape}")
    o = np.load(ROOT / "tests" / "oracle" / "day1000_seed1_radbasfun.npz")
    nan = np.isnan(chi2)
    check(np.array_equal(nan, np.isnan(o["chi2"][:ndays])),
          "radbasfun: NaN set differs from the oracle")
    check(np.isfinite(C[~nan]).all(), "radbasfun: non-finite coefficients")
    check((chi2[~nan] >= 0).all(),
          f"radbasfun: {int((chi2[~nan] < 0).sum())} negative chi2")
    rel = np.abs(chi2 - o["chi2"][:ndays]) / o["chi2"][:ndays]
    c2 = held_to_bars("radbasfun: chi2 vs its oracle", rel, CHI2_MEDIAN_TOL,
                      CHI2_MAX_TOL)
    wf = held_to_bars("radbasfun: W-weighted field vs its oracle",
                      wfield(dict(interp=interp, C=C), o["C"][:ndays], ndays),
                      WFIELD_MEDIAN_TOL, WFIELD_MAX_TOL)

    # the product: 8 records on the config-4 grid, FoV-masked
    est = mem_estimate(interp, device, "day1.h5")
    times = [EPOCH + dt.timedelta(seconds=float(t))
             for t in np.mean(est.time, axis=1)[:nrec]]
    glat, glon, galt = grid(*shape)
    _reset_peak(device)
    t0 = time.perf_counter()
    vol = est.evaluate_records(times, glat, glon, galt, check_hull=True)
    cold_s = time.perf_counter() - t0
    cold = est.timer.report()
    t0 = time.perf_counter()
    vol2 = est.evaluate_records(times, glat, glon, galt, check_hull=True)
    warm_s = time.perf_counter() - t0
    prod_gib = _peak_gib(device)
    warm = {k: v - cold.get(k, 0.0) for k, v in est.timer.report().items()}
    check(vol.shape == (nrec,) + glat.shape and vol.dtype == np.float32,
          f"radbasfun product shape {vol.shape} {vol.dtype}")
    check(np.array_equal(vol, vol2, equal_nan=True),
          "radbasfun product: repeat call differs")
    ff = float(np.isfinite(vol).mean())
    if finite_frac is not None:
        check(abs(ff - finite_frac) <= 1e-3,
              f"radbasfun product: finite fraction {ff:.4f} != {finite_frac}")
    idx = np.random.default_rng(3).choice(glat.size, 10_000, replace=False)
    pts = [a.ravel()[idx] for a in (glat, glon, galt)]
    exact = est(times[0], *pts)
    fast = vol[0].ravel()[idx]
    check(np.array_equal(np.isnan(fast), np.isnan(exact)),
          "radbasfun product: NaN set differs from the float64 point API")
    gross = np.abs(est.model.basis(*pts) * np.asarray(est.get_C(times[0])[0])
                   ).sum(-1)
    fin = np.isfinite(exact)
    sup = np.max(np.abs(exact[fin]))
    diff = np.abs(fast - exact)[fin]
    check((diff <= GRID_TOL * sup + GROSS_TOL * gross[fin]).all(),
          f"radbasfun product: error {diff.max():.3e} beyond {GRID_TOL} x sup "
          f"{sup:.3e} + {GROSS_TOL} x gross")
    npts = glat.size * nrec
    print(f"phase 6 radbasfun: NAME = radbasfun ({nb} Gaussian RBFs, EPS "
          f"{interp.model.eps:g} m, no regularization), the whole {ndays}-"
          f"record day (the oracle's QC'd bytes) through "
          f"Interpolate.calc_coeffs: {fit_s:.3f} s, of which fit_records "
          f"{interp.timer.report()['fit_records']:.3f} s = "
          f"{ndays / interp.timer.report()['fit_records']:.3f} records/s, "
          f"peak device memory {fit_gib:.3f} GiB; {int(nan.sum())} NaN as the "
          f"oracle, 0 negative chi2; vs its oracle: chi2 rel median "
          f"{c2[0]:.4e} max {c2[1]:.4e}, W-weighted field median {wf[0]:.4e} "
          f"max {wf[1]:.4e}; product evaluate_records({nrec} records x "
          f"{glat.size} points, FoV mask) cold {cold_s:.3f} s "
          f"({npts / cold_s:.4e} points/s: {_phases(cold)}), warm "
          f"{warm_s:.3f} s ({npts / warm_s:.4e} points/s: {_phases(warm)}), "
          f"peak device memory {prod_gib:.3f} GiB; finite fraction {ff:.4f}; "
          f"vs the float64 basis at 10^4 points: max {diff.max() / sup:.3e} "
          f"of sup, {np.max(diff / gross[fin]):.3e} of the gross sum",
          flush=True)


def eigh_counts():
    """(matrices decomposed, of them on the host, host_eigh seconds) since
    import (ops/solve's counters)."""
    return (solve.eigh_matrices, solve.host_eigh_matrices,
            solve.host_eigh_seconds)


def eighs_since(c0):
    """(card eighs, host eighs, host_eigh seconds) since eigh_counts()
    gave c0."""
    n, host, host_s = (x - x0 for x, x0 in zip(eigh_counts(), c0))
    return n - host, host, host_s


def device_activity(prof):
    """The device's activity in a torch.profiler window: (busy seconds,
    the union of its CUDA activity intervals; seconds of memcpy
    activities; seconds of the others; number of activities), or None
    when it recorded none (the CPU)."""
    evs = [ev for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        return None
    busy, end = 0.0, -np.inf
    for a, b in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in evs):
        if b > end:
            busy += b - max(a, end)
            end = b
    copy = sum(ev.time_range.elapsed_us() for ev in evs
               if "memcpy" in ev.name.lower())
    other = sum(ev.time_range.elapsed_us() for ev in evs) - copy
    return busy * 1e-6, copy * 1e-6, other * 1e-6, len(evs)


def phase_sweep(device="cuda", day=DAY):
    """Phase 7: lobo_cv and order_sweep on the first LOBO_NREC records
    against tests/oracle/day1000_seed1_lobo.npz, every eigendecomposition
    through solve.host_eigh; then the first half of the records alone,
    under the profiler: its scores must be the bits of the whole call's,
    and the trace splits the sweep's seconds into host eighs, copies and
    device work."""
    o = np.load(ROOT / "tests" / "oracle" / "day1000_seed1_lobo.npz")
    data = day_data(day)
    _, lat, lon, alt, _, _ = qc(data)
    v, e = oracle_day(LOBO_NREC)
    bidx = beam_indices(data)
    la = [float(a) for a in o["alphas"]]
    orders = [tuple(int(x) for x in oi) for oi in o["orders"]]
    model = Model(Config.from_text(MODEL_CFG))
    A, R = model.basis(lat, lon, alt), model.eval_psi()
    c0 = eigh_counts()
    _sync(device)
    t0 = time.perf_counter()
    scores, per = sweep.lobo_cv(v, e, A, bidx, R, la, device=device)
    _sync(device)
    lobo_s = time.perf_counter() - t0
    lobo = eighs_since(c0)
    half = LOBO_NREC // 2
    c0 = eigh_counts()
    with tempfile.TemporaryDirectory(prefix=".smoke-trace-", dir=ROOT) as tmp:
        with trace(tmp) as prof:
            _sync(device)
            t0 = time.perf_counter()
            _, per_half = sweep.lobo_cv(v[:half], e[:half], A, bidx, R, la,
                                        device=device)
            _sync(device)
            half_s = time.perf_counter() - t0
    half_eighs = eighs_since(c0)
    act = device_activity(prof)
    c0 = eigh_counts()
    t0 = time.perf_counter()
    res = sweep.order_sweep(MODEL_CFG, v, e, lat, lon, alt, bidx, orders, la,
                            device=device)
    _sync(device)
    sweep_s = time.perf_counter() - t0
    swept = eighs_since(c0)
    rel = np.abs(per - o["per"]) / np.abs(o["per"])
    srel = np.abs(res["scores"] - o["scores"]) / np.abs(o["scores"])
    best = (tuple(int(x) for x in res["best_order"]),
            float(res["best_log10_alpha"]))
    best_o = (tuple(int(x) for x in o["best_order"]),
              float(o["best_log10_alpha"]))
    n_lobo = LOBO_NREC * 20 * len(la)
    print(f"phase 7 sweep: lobo_cv({LOBO_NREC} records x 20 beams x "
          f"{len(la)} log10 alphas {la[0]:g}..{la[-1]:g}, MAXK=4 MAXL=6) "
          f"{lobo_s:.3f} s, eighs card {lobo[0]} host {lobo[1]} "
          f"(lobo_scores_per_s {n_lobo / lobo_s:.1f}, host_eigh_seconds "
          f"{lobo[2]:.3f}); order_sweep({orders}) {sweep_s:.3f} s, eighs "
          f"card {swept[0]} host {swept[1]} (host_eigh_seconds "
          f"{swept[2]:.3f}); argmin {best} (oracle {best_o}); per-entry rel "
          f"median {np.median(rel):.4e} (bar {LOBO_ENTRY_MEDIAN_TOL}), by "
          f"alpha {np.round(np.median(rel, axis=(0, 1)), 4).tolist()}; "
          f"summed scores rel max by order "
          f"{dict(zip(orders, np.round(srel.max(1), 6).tolist()))} (bars "
          f"{LOBO_SUM_TOL}); lobo_cv's own sums vs its order_sweep row "
          f"{float(np.max(np.abs(scores - res['scores'][-1]) / scores)):.2e}",
          flush=True)
    diff = per_half != per[:half]
    diff_rel = float(np.max(np.abs(per_half - per[:half]) / np.abs(per[:half])))
    spent = (f"device busy {act[0]:.3f} s (share {act[0] / half_s:.4f}) "
             f"over {act[3]} activities: memcpy {act[1]:.3f} s, the others "
             f"{act[2]:.3f} s" if act else "device activity not measured")
    print(f"phase 7 sweep layout: lobo_cv of the first {half} records alone "
          f"under the profiler: {half_s:.3f} s, eighs card {half_eighs[0]} "
          f"host {half_eighs[1]}, host_eigh_seconds {half_eighs[2]:.3f} "
          f"(the copy to the host and LAPACK), the rest, the queued copy "
          f"back included, {half_s - half_eighs[2]:.3f} s; "
          f"{spent}; scores equal to the {LOBO_NREC}-record call's "
          f"in {diff.size - int(diff.sum())} of {diff.size} entries (max rel "
          f"{diff_rel:.3e})",
          flush=True)
    for what, (card, host, _), want in (
            ("lobo_cv", lobo, n_lobo),
            ("lobo_cv half", half_eighs, n_lobo // 2),
            ("order_sweep", swept, n_lobo * len(orders))):
        check(card == 0 and host == want,
              f"{what}: {card} eighs on the card, {host} on the host; 0 and "
              f"{want} expected")
    check(per.shape == o["per"].shape, f"lobo_cv per {per.shape}")
    check(not diff.any(), f"lobo_cv: {int(diff.sum())} scores of the first "
          f"{half} records differ between a {half}- and a {LOBO_NREC}-record "
          f"call")
    check(best == best_o, f"sweep argmin {best} != the oracle's {best_o}")
    check(np.median(rel) <= LOBO_ENTRY_MEDIAN_TOL,
          f"lobo per-entry median {np.median(rel):.3e}")
    for i, order in enumerate(orders):
        check(srel[i].max() <= LOBO_SUM_TOL[order],
              f"order {order}: summed scores rel {srel[i].max():.3e}")


def _free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def parallel_inputs(day=DAY, nwin=64, shape=(512, 512, 128), device="cuda"):
    """Phase 8's inputs, the same in every process: the window's values
    and errors, A, R, the grid, its evaluator and a record's coefficients."""
    _, lat, lon, alt, v, e = qc(day_data(day))
    model = Model(Config.from_text(MODEL_CFG))
    glat, glon, galt = grid(*shape)
    _, t, _ = np_geodetic_to_cap(glat.ravel(), glon.ravel(), galt.ravel(),
                                 model.latcp, model.loncp)
    ev = GridEvaluator(model, (t.min(), t.max()), device=device)
    Cg = np.random.default_rng(0).normal(size=model.nbasis) * 1e11
    return dict(v=v[:nwin], e=e[:nwin], A=model.basis(lat, lon, alt),
                R=model.eval_psi()[None], grid=(glat, glon, galt), ev=ev,
                Cg=Cg)


SHARD_MODES = ("exact", "fast")


def sharded_run(inp, mesh, device):
    """fit_records_sharded in SHARD_MODES and grid_eval_sharded over mesh:
    {mode: (C, dC, chi2, rp) host arrays, "grid": the field}."""
    out = {}
    for mode in SHARD_MODES:
        out[mode] = [x.cpu().numpy() for x in parallel.fit_records_sharded(
            inp["v"], inp["e"], inp["A"], inp["R"], mesh,
            regparam_mode=mode, device=device)]
    out["grid"] = parallel.grid_eval_sharded(
        inp["ev"], inp["Cg"], *inp["grid"], mesh).cpu().numpy()
    return out


def split_fit(inp, mode, layout, device):
    """What fit_records_sharded computes in a records x points layout, in
    one process and without collectives: each row's statistics, which are
    the whole batch's bits in any points layout (the shards gather the
    blocks of ops/solve.stat_blocks and add them in order), and each
    rank's share of the row's records fitted as its own batch.  On the card
    a batch's size moves some exact roots along the cutoff staircase
    (PERF.md), so this, not the whole-batch fit, is what a layout
    must reproduce to the bit; against the whole batch each layout is held
    as phase_parallel says."""
    r, p = layout
    v, e, A, R = (torch.as_tensor(x, device=device)
                  for x in (inp["v"], inp["e"], inp["A"], inp["R"]))
    check(v.shape[0] % (r * p) == 0, "split_fit needs whole shares")
    per_row = v.shape[0] // r
    per = per_row // p
    parts = []
    for i in range(r):
        rows = slice(i * per_row, (i + 1) * per_row)
        st = solve.suff_stats(A, v[rows], e[rows])
        for j in range(p):
            mine = slice(j * per, (j + 1) * per)
            prepared = ops_fit.prepare_stats(
                v[rows][mine], e[rows][mine], tuple(x[mine] for x in st), R,
                "chi2", mode)
            parts.append([x.cpu().numpy() for x in ops_fit.fit_records(
                None, None, A, R, regparam_mode=mode, device=device,
                prepared=prepared)])
    return [np.concatenate(x) for x in zip(*parts)]


def shard_stats(got, ref, inp):
    """Per mode (chi2 rel, |dlog10 alpha|, W-weighted field) of got against
    ref on the records ref fits; the NaN sets and too-smooth sets must be
    equal."""
    out = {}
    ok_v = np.isfinite(inp["v"])
    sw = ok_v / np.where(ok_v, inp["e"], 1.0)
    for mode in SHARD_MODES:
        C, _, chi2, rp = got[mode]
        Cr, _, chi2r, rpr = ref[mode]
        nan = np.isnan(chi2r)
        check(np.array_equal(np.isnan(chi2), nan), f"{mode}: NaN sets differ")
        ok = (rpr[:, 0] > 0) & np.isfinite(rpr[:, 0])
        check(np.array_equal((rp[:, 0] > 0) & np.isfinite(rp[:, 0]), ok),
              f"{mode}: too-smooth or failed records differ")
        wf = (np.linalg.norm(sw * ((C - Cr) @ inp["A"].T), axis=1)
              / np.linalg.norm(sw * (Cr @ inp["A"].T), axis=1))[~nan]
        out[mode] = ((np.abs(chi2 - chi2r) / chi2r)[~nan],
                     np.abs(np.log10(rp[ok, 0]) - np.log10(rpr[ok, 0])), wf)
    return out


def held_to_shard_bars(what, got, ref, inp, strict=SHARD_MODES):
    """got against ref: the modes in ``strict`` with every record within
    SHARD_TOL in chi2 (relative), log10 alpha and the W-weighted field
    (fast: the alphas within rtol 1e-6); the others to the day bars
    (CHI2_* and WFIELD_*: the cutoff staircase).  Returns a printable
    summary with the roots that moved by more than SHARD_TOL decades."""
    line = []
    for mode, (rel, dla, wf) in shard_stats(got, ref, inp).items():
        line.append(f"{mode}: {int((dla > SHARD_TOL).sum())} of {len(dla)} "
                    f"roots moved, chi2 rel median {np.median(rel):.3e} max "
                    f"{rel.max():.3e}, |dlog10 alpha| median "
                    f"{np.median(dla):.3e} max {dla.max():.3e}, W-weighted "
                    f"field median {np.median(wf):.3e} max {wf.max():.3e}")
        if mode in strict:
            alpha_ok = (np.all(10 ** dla - 1 <= 1e-6) if mode == "fast"
                        else dla.max() <= SHARD_TOL)
            check(rel.max() <= SHARD_TOL and wf.max() <= SHARD_TOL
                  and alpha_ok, f"{what}: {line[-1]} (bar {SHARD_TOL})")
        else:
            check(np.median(rel) <= CHI2_MEDIAN_TOL and rel.max() <= CHI2_MAX_TOL
                  and np.median(wf) <= WFIELD_MEDIAN_TOL
                  and wf.max() <= WFIELD_MAX_TOL,
                  f"{what}: {line[-1]} (the day bars)")
    if "grid" in got:
        check(np.array_equal(got["grid"], ref["grid"], equal_nan=True),
              f"{what}: the sharded grid differs from the local grid")
    return "; ".join(line)


def parallel_child(rank, port, out, device, shape):
    """A rank of phase 8's 2-rank gloo world (both ranks on ``device``,
    cuda:0 on the card)."""
    inp = parallel_inputs(shape=tuple(int(n) for n in shape.split("x")),
                          device=device)
    distributed.initialize_distributed(
        coordinator=f"localhost:{port}", num_processes=2, process_id=rank,
        device=device, backend="gloo")
    res = {}
    for layout in ((2, 1), (1, 2)):
        got = sharded_run(inp, parallel.make_mesh(*layout), device)
        for mode in SHARD_MODES:
            for k, x in zip(("C", "dC", "chi2", "rp"), got[mode]):
                res[f"{layout[0]}x{layout[1]}_{mode}_{k}"] = x
        res[f"{layout[0]}x{layout[1]}_grid"] = got["grid"]
    np.savez(f"{out}.{rank}.npz", **res)
    torch.distributed.destroy_process_group()


def phase_parallel(workdir, device="cuda", shape=(512, 512, 128)):
    """Phase 8: a 1-rank nccl world here, then a 2-rank gloo world of two
    child processes on this card.  Each layout is held to SHARD_TOL (every
    record) against split_fit of its layout, and against the whole-batch
    single-process fit fast to SHARD_TOL, exact to the day bars, with the
    roots that moved printed; the grids must be equal."""
    inp = parallel_inputs(shape=shape, device=device)
    t0 = time.perf_counter()
    ref = {mode: [x.cpu().numpy() for x in ops_fit.fit_records(
        inp["v"], inp["e"], inp["A"], inp["R"], regparam_mode=mode,
        device=device)] for mode in SHARD_MODES}
    ref["grid"] = inp["ev"](inp["Cg"], *inp["grid"]).cpu().numpy()
    split = {}
    for layout in ((2, 1), (1, 2)):
        split[layout] = {mode: split_fit(inp, mode, layout, device)
                         for mode in SHARD_MODES}
        split[layout]["grid"] = ref["grid"]
    single_s = time.perf_counter() - t0
    split_lines = [f"{r}x{p} split vs whole: " + held_to_shard_bars(
        f"one process, the {r}x{p} split", split[(r, p)], ref, inp,
        ("fast",)) for r, p in split]

    t0 = time.perf_counter()
    distributed.initialize_distributed(
        coordinator=f"localhost:{_free_port()}", num_processes=1,
        process_id=0, device=device)
    backend = torch.distributed.get_backend()
    try:
        mesh = parallel.make_mesh(1, 1)
        check(mesh.group is not None, "the 1-rank world has no points group")
        one = sharded_run(inp, mesh, device)
    finally:
        torch.distributed.destroy_process_group()
    one_s = time.perf_counter() - t0
    one_line = held_to_shard_bars(f"1-rank {backend}", one, ref, inp)

    out = str(workdir / "parallel")
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--parallel-child", str(i), str(port), out,
                               device, "x".join(map(str, shape))],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=600)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    two_s = time.perf_counter() - t0
    for i, (pr, log) in enumerate(zip(procs, logs)):
        check(pr.returncode == 0, f"gloo rank {i} failed:\n{log[-3000:]}")
    ranks = [np.load(f"{out}.{i}.npz") for i in range(2)]
    for k in ranks[0].files:
        check(np.array_equal(ranks[0][k], ranks[1][k], equal_nan=True),
              f"gloo world: ranks 0 and 1 return different {k}")
    lines = []
    for r, p in split:
        tag = f"{r}x{p}"
        got = {mode: [ranks[0][f"{tag}_{mode}_{k}"]
                      for k in ("C", "dC", "chi2", "rp")]
               for mode in SHARD_MODES}
        got["grid"] = ranks[0][f"{tag}_grid"]
        lines.append(f"{tag} vs its split in one process: "
                     + held_to_shard_bars(f"2-rank gloo {tag}", got,
                                          split[(r, p)], inp))
        lines.append(f"{tag} vs whole: " + held_to_shard_bars(
            f"2-rank gloo {tag} vs the whole batch", got, ref, inp,
            ("fast",)))
    print(f"phase 8 parallel: {len(inp['v'])}-record window (exact, fast) and "
          f"config-4 x 1 grid; single process {single_s:.3f} s (whole batch, "
          f"and each layout's split: {' | '.join(split_lines)}); 1-rank "
          f"{backend} world {one_s:.3f} s: {one_line}, grid equal; 2-rank "
          f"gloo world on one card (2 child processes, layouts 2x1 and 1x2) "
          f"{two_s:.3f} s: {' | '.join(lines)}, grids equal; a multi-card "
          f"layout is not run (one card)", flush=True)


def phase_busy(device="cuda", day=DAY, nrec=128):
    """Phase 9: one nrec-record chunk of the exact fit (phase 4b's setting)
    under utils/profiling.trace; the device's busy share of the window is
    the union of its CUDA activity intervals (device_activity) over the
    window's wall time (the profiler's own cost is inside the window)."""
    _, lat, lon, alt, v, e = qc(day_data(day))
    model = Model(Config.from_text(MODEL_CFG))
    A = torch.as_tensor(model.basis(lat, lon, alt), device=device)
    R = torch.as_tensor(model.eval_psi()[None], device=device)
    ops_fit.fit_records(v[:nrec], e[:nrec], A, R, device=device)  # warm
    with tempfile.TemporaryDirectory(prefix=".smoke-trace-", dir=ROOT) as tmp:
        with trace(tmp) as prof:
            _sync(device)
            t0 = time.perf_counter()
            ops_fit.fit_records(v[nrec:2 * nrec], e[nrec:2 * nrec], A, R,
                                device=device)
            _sync(device)
            wall = time.perf_counter() - t0
        trace_mb = (Path(tmp) / "trace.json").stat().st_size / 2**20
    act = device_activity(prof)
    if act is None:
        print(f"phase 9 busy: the profiler recorded no device activity in "
              f"the {wall:.3f} s window; busy share not measured", flush=True)
        return
    busy, _, _, n = act
    print(f"phase 9 busy: fit_records({nrec} records, exact) under "
          f"torch.profiler: window {wall:.3f} s, device busy "
          f"{busy:.3f} s over {n} activities, busy share "
          f"{busy / wall:.4f} (idle {1 - busy / wall:.4f}); "
          f"Chrome trace {trace_mb:.1f} MiB", flush=True)


def oracle_module():
    """tests/oracle/ref_impl.py (NumPy/SciPy), loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "ref_impl", ROOT / "tests" / "oracle" / "ref_impl.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def api_problem(nb=144):
    """Phase 10 (c)'s record: (A [580, nb], b, W, R) from API_SEED."""
    rng = np.random.default_rng(API_SEED)
    A = rng.normal(size=(API_NPTS, nb))
    b = A @ (API_TAU * rng.normal(size=nb)) + API_NOISE * rng.normal(
        size=API_NPTS)
    W = np.full(API_NPTS, 100.0)
    R = API_SCALE * (np.eye(nb) + 0.1 * np.ones((nb, nb)))
    return A, b, W, R


def api_digest(*arrays):
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a, np.float64).tobytes())
    return h.hexdigest()


def _col_err(dev, host):
    """max over columns of max_i |dev - host| / max_i |host| (columns: every
    axis but the first), computed on dev's device."""
    host = torch.as_tensor(host, device=dev.device)
    sup = host.abs().amax(0)
    err = (dev - host).abs().amax(0) / torch.where(sup > 0, sup,
                                                   torch.ones_like(sup))
    return float(err.max())


def _host_route(fn, pts, threads=8):
    """fn (a model's host float64 route) over chunks of at most
    HOST_ROUTE_CHUNK points on ``threads`` threads, concatenated: numpy's
    elementwise loops release the GIL.  Each point's row is the same in
    any chunk, and small chunks keep numpy's temporaries small: one chunk
    a thread took several times longer a point (PERF.md §6)."""
    nchunk = -(-pts[0].size // HOST_ROUTE_CHUNK)
    with ThreadPoolExecutor(threads) as pool:
        return np.concatenate(list(pool.map(
            fn, *(np.array_split(a, nchunk) for a in pts))))


def phase_api_design(inside, device="cuda", npts=API_POINTS,
                     shape=(512, 512, 128)):
    """Phase 10 (a): the models' device design path against their host
    float64 route (8 threads over point chunks) on npts points drawn from
    the FoV of the grid.  The device route runs first: it sets the
    Legendre tables' domain for both."""
    glat, glon, galt = grid(*shape)
    idx = np.random.default_rng(5).choice(np.flatnonzero(inside.ravel()),
                                          npts, replace=False)
    pts = [a.ravel()[idx] for a in (glat, glon, galt)]
    pts_d = [torch.as_tensor(a, device=device) for a in pts]
    sph = Model(Config.from_text(model_cfg()))
    rbf = make_model("radbasfun", Config.from_text(RBF_CFG.format(raw="")))
    for what, model, fn in (("sphharmlag basis", sph, "basis"),
                            ("sphharmlag grad_basis", sph, "grad_basis"),
                            ("radbasfun basis", rbf, "basis")):
        secs = []
        for _ in range(2):  # cold, warm
            _sync(device)
            t0 = time.perf_counter()
            dev = getattr(model, fn)(*pts_d)
            _sync(device)
            secs.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        host = _host_route(getattr(model, fn), pts)
        host_s = time.perf_counter() - t0
        check(dev.dtype == torch.float64 and dev.device.type == device
              and tuple(dev.shape) == host.shape,
              f"{what}: {dev.dtype} {dev.device} {tuple(dev.shape)}")
        err = _col_err(dev, host)
        check(err <= DESIGN_TOL,
              f"{what}: device route {err:.3e} of a column's sup from the "
              f"host route (bar {DESIGN_TOL})")
        print(f"phase 10 api (a) {what} on {npts} FoV points of the config-4 "
              f"grid, shape {tuple(dev.shape)}: device route ({device} "
              f"float64) cold {secs[0]:.3f} s warm {secs[1]:.3f} s, host "
              f"float64 route {host_s:.3f} s on 8 threads in chunks of "
              f"{HOST_ROUTE_CHUNK} points; max |device - host| "
              f"{err:.3e} of the column's sup (bar {DESIGN_TOL})", flush=True)
        del host, dev


def phase_api_hull(est, prod, device="cuda", shape=(512, 512, 128)):
    """Phase 10 (b): Estimate.check_hull on phase 5's grid against phase
    5's host mask; differences only in the band about the threshold."""
    glat, glon, galt = grid(*shape)
    _reset_peak(device)
    secs, masks = [], []
    for _ in range(2):  # cold, warm
        t0 = time.perf_counter()
        masks.append(est.check_hull(glat, glon, galt))
        secs.append(time.perf_counter() - t0)
    peak = _peak_gib(device)
    mask, host = masks[0], prod["inside"]
    check(isinstance(mask, np.ndarray) and mask.dtype == bool
          and mask.shape == glat.shape, "check_hull: mask type or shape")
    check(np.array_equal(mask, masks[1]), "check_hull: repeat call differs")
    diff = np.flatnonzero(mask.ravel() != host.ravel())
    # the host's max_f d at the points that differ, against the threshold
    eqs = hull_equations(est.hull_vert)
    scale = float(np.max(np.abs(eqs[:, 3])))
    P = np.stack(np_geodetic2ecef(*(a.ravel()[diff] for a in
                                    (glat, glon, galt))), axis=-1)
    dmax = np.max(P @ eqs[:, :3].T + eqs[:, 3], axis=-1, initial=-np.inf)
    n_band = int(np.sum(np.abs(dmax - 1e-8 * scale) <= HULL_BAND * scale))
    check(n_band == diff.size,
          f"check_hull: {diff.size - n_band} points differ from the host "
          f"mask outside {HULL_BAND} x scale of the threshold")
    print(f"phase 10 api (b) Estimate.check_hull({device}) on the config-4 "
          f"grid ({glat.size} points, {eqs.shape[0]} facets, "
          f"{int(mask.sum())} inside): cold {secs[0]:.3f} s, warm "
          f"{secs[1]:.3f} s, against phase 5's host np_check_hull "
          f"(grid_hull) {prod['grid_hull_s']:.3f} s; peak device memory "
          f"{peak:.3f} GiB; {diff.size} points differ from the host mask, "
          f"{n_band} of them within {HULL_BAND} x scale of the threshold",
          flush=True)


def phase_api_interpolate(device="cuda"):
    """Phase 10 (c): Interpolate's reference-API methods on the card
    against the NumPy/SciPy oracle, at the CPU test's tolerances
    (tests/test_torch_api_surface.py)."""
    ref = oracle_module()
    A, b, W, R = api_problem()
    stored = np.load(ROOT / "tests" / "oracle" / "api_surface_oracle.npz")
    check(str(stored["digest"]) == api_digest(A, b, W, R),
          "the API problem differs from the one the GCV oracle was run on")
    interp = Interpolate(Config.from_text(API_CFG), device=device)
    regs = {"0thorder": R}
    head = f"phase 10 api (c) Interpolate(device={device!r})."

    t0 = time.perf_counter()
    C, dC = interp.eval_C(A, b, W, regs, {"0thorder": API_EVAL_ALPHA},
                          calccov=True)
    _sync(device)
    secs = time.perf_counter() - t0
    check(C.device.type == device and dC.device.type == device,
          "eval_C: results not on the device")
    C, dC = C.cpu().numpy(), dC.cpu().numpy()
    C_o, dC_o = ref.oracle_eval_C(A, b, W, [R], [API_EVAL_ALPHA],
                                  calccov=True)
    check(np.allclose(C, C_o, rtol=1e-9, atol=1e-12 * np.abs(C_o).max())
          and np.allclose(dC, dC_o, rtol=1e-8,
                          atol=1e-11 * np.abs(dC_o).max()),
          "eval_C: beyond rtol 1e-9 (C) / 1e-8 (dC) of oracle_eval_C")
    print(f"{head}eval_C(calccov=True) at alpha {API_EVAL_ALPHA:g}, "
          f"{API_NPTS} points x {A.shape[1]}: {secs:.3f} s; vs oracle_eval_C "
          f"max |dC| {np.abs(C - C_o).max() / np.abs(C_o).max():.3e} of "
          f"max |C|, max |d dC| {np.abs(dC - dC_o).max() / np.abs(dC_o).max():.3e}"
          f" of max |dC|", flush=True)

    t0 = time.perf_counter()
    out = interp.find_reg_param(A, b, W, regs, method="chi2")["0thorder"]
    secs = time.perf_counter() - t0
    want = ref.oracle_chi2_param(A, b, W, [R], 0)
    nu = ref._chi2_of(np.log10(want), A, b, W, [R], 0)  # the root's rung
    c2 = ref._chi2_of(np.log10(out), A, b, W, [R], 0)
    check(isinstance(out, float) and abs(c2 / nu - 1.0) <= 1e-5
          and abs(out / want - 1.0) <= 2e-5,
          f"find_reg_param chi2: {out!r} vs the oracle's {want!r}")
    print(f"{head}find_reg_param('chi2'): {out:.10e} in {secs:.3f} s; "
          f"oracle_chi2_param {want:.10e}: alpha rel {out / want - 1.0:.3e} "
          f"(bar 2e-5), chi2(alpha) / nu - 1 {c2 / nu - 1.0:.3e} (bar 1e-5)",
          flush=True)

    t0 = time.perf_counter()
    out = interp.find_reg_param(A, b, W, regs, method="gcv")["0thorder"]
    secs = time.perf_counter() - t0
    want = float(stored["gcv"])
    dlog = abs(np.log10(out) - np.log10(want))
    check(isinstance(out, float) and dlog < 5e-4,
          f"find_reg_param gcv: {out!r} vs the oracle's {want!r}")
    print(f"{head}find_reg_param('gcv'): log10 alpha {np.log10(out):.6f} in "
          f"{secs:.3f} s; oracle_gcv_param (scripts/api_oracle.py) "
          f"{np.log10(want):.6f}: |dlog10 alpha| {dlog:.3e} (bar 5e-4)",
          flush=True)

    out = interp.find_reg_param(A, b, W, regs, method="manual")
    check(out == {"0thorder": 1.0e-23}, f"find_reg_param manual: {out}")
    print(f"{head}find_reg_param('manual'): {out}", flush=True)

    rels = []
    for a in API_ALPHAS:
        ours = interp.chi2objfunct(a, A, b, W, regs, nu=float(API_NPTS),
                                   reg="0thorder")
        want = ref._chi2_of(a, A, b, W, [R], 0) - API_NPTS
        rels.append(abs(ours / want - 1.0))
        check(isinstance(ours, float) and rels[-1] <= 1e-7,
              f"chi2objfunct at {a}: {ours!r} vs the oracle's {want!r}")
    print(f"{head}chi2objfunct at log10 alpha {API_ALPHAS}: rel to the "
          f"oracle's chi2 - nu {', '.join(f'{r:.3e}' for r in rels)} "
          f"(bar 1e-7)", flush=True)


def phase_api(est, prod, device="cuda", npts=API_POINTS,
              shape=(512, 512, 128)):
    """Phase 10: the reference-API surface (a), (b), (c)."""
    phase_api_design(prod["inside"], device, npts, shape)
    phase_api_hull(est, prod, device, shape)
    phase_api_interpolate(device)


def hi_model():
    """A fresh model of the high order: its Legendre tables' domain widens
    with the points it has seen (tables.py), so every check takes its own,
    as tests/test_highorder.py does."""
    return Model(Config.from_text(model_cfg(HI_ORDER)))


def hi_fit(mode, device, day=DAY, nrec=HI_NREC, method="chi2"):
    """The first nrec records of the seed-1 day (the oracles' own QC'd
    bytes, as phase 6) fitted at HI_ORDER in ``method`` and ``mode``
    through Interpolate.calc_coeffs, in memory.  Returns the interp, its
    seconds, (card eighs, host eighs, host_eigh seconds) and peak device
    memory."""
    data = day_data(day)
    value, error = oracle_day(day["nrec"])

    class HiInterpolate(Interpolate):
        def read_datafile(self, filename):
            ut, lat, lon, alt, _, _ = qc(data)
            return ut, lat, lon, alt, value, error

    text = FIT_CFG.format(raw="day1.h5", out="", method=method, mode=mode,
                          extra="").replace(MODEL_CFG, model_cfg(HI_ORDER))
    start = EPOCH + dt.timedelta(seconds=day["t0"])
    end = start + dt.timedelta(seconds=day["cadence"] * nrec)
    interp = HiInterpolate(text, device=device)
    _reset_peak(device)
    c0 = eigh_counts()
    t0 = time.perf_counter()
    interp.calc_coeffs(start, end)
    _sync(device)
    secs = time.perf_counter() - t0
    return interp, secs, eighs_since(c0), _peak_gib(device)


def held_to_hi_oracle(what, interp, tag, start=0, nrec=None):
    """The fit's records from ``start`` against the JAX oracle
    tests/oracle/day1000_seed1_highorder_<tag>.npz (its rows begin at
    ``start``; its first nrec, all when None): the NaN set and no negative
    chi2, the W-weighted field to the fit bars; returns (chi2 rel, field,
    |dlog10 alpha|) and a line of them."""
    o = np.load(ROOT / "tests" / "oracle"
                / f"day1000_seed1_highorder_{tag}.npz")
    check(int(o["start"] if "start" in o else 0) == start,
          f"{tag}: the oracle's rows begin elsewhere")
    n = len(o["chi2"]) if nrec is None else nrec
    rows = slice(start, start + n)
    C, chi2 = interp.Coeffs[rows], interp.chi_sq[rows]
    reg = interp.reg_params[rows, 0]
    C_o, chi2_o, reg_o = o["C"][:n], o["chi2"][:n], o["reg"][:n, 0]
    nan = np.isnan(chi2)
    check(np.array_equal(nan, np.isnan(chi2_o)),
          f"{what}: NaN set differs from its oracle")
    check(np.isfinite(C[~nan]).all() and (chi2[~nan] >= 0).all(),
          f"{what}: non-finite coefficients or negative chi2")
    rel = np.abs(chi2 - chi2_o) / chi2_o
    wf = wfield(dict(interp=interp, C=interp.Coeffs), C_o, n, start)
    dla = dlog10(reg, reg_o)
    wf_med, wf_max = held_to_bars(f"{what}: W-weighted field vs its oracle",
                                  wf, WFIELD_MEDIAN_TOL, WFIELD_MAX_TOL)
    line = (f"records {start}..{start + n - 1} vs {tag} oracle: "
            f"{int(nan.sum())} NaN as the oracle; chi2 rel median "
            f"{np.nanmedian(rel):.4e} max {np.nanmax(rel):.4e}, W-weighted "
            f"field median {wf_med:.4e} max {wf_max:.4e}, |dlog10 alpha| "
            f"median {np.median(dla):.4e} max {dla.max():.4e} (printed, not "
            f"held)")
    return rel, wf, dla, line


def phase_highorder_basis():
    """Phase 11 (a), first: the basis against the NumPy oracle."""
    model = hi_model()
    ref = oracle_module()
    rng = np.random.default_rng(5)  # test_highorder.py's points
    pts = (rng.uniform(74, 82, 50), rng.uniform(252, 272, 50),
           rng.uniform(1e5, 6e5, 50))
    A = model.basis(*pts)
    Aref = ref.oracle_basis(HI_ORDER[1], HI_ORDER[0], 10.0, 78.0, 262.0, *pts)
    sup = np.abs(Aref).max(0)
    live = sup > 0  # scipy's lpmv underflows to 0 at nu ~ 166
    err = float((np.abs(A - Aref).max(0)[live] / sup[live]).max())
    check(model.nbasis == 1200 and err <= HI_ORACLE_TOL,
          f"order {HI_ORDER}: nbasis {model.nbasis}, basis {err:.3e} of a "
          f"column's sup from the oracle (bar {HI_ORACLE_TOL})")
    print(f"phase 11 highorder (a): (maxl, maxk) = {HI_ORDER}, nbasis "
          f"{model.nbasis}; basis vs the NumPy oracle at 50 points: max "
          f"{err:.3e} of a column's sup over {int(live.sum())} columns "
          f"({int((~live).sum())} where scipy underflows; bar "
          f"{HI_ORACLE_TOL})", flush=True)


def rss_gib():
    """(peak, current) resident host memory of this process, GiB: the peak
    from getrusage, the current from /proc/self/status (VmRSS)."""
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return peak, int(line.split()[1]) / 2**20
    raise RuntimeError("chip_smoke: /proc/self/status has no VmRSS")


def phase_highorder_day(device="cuda", day=DAY, method="chi2", windows=None,
                        label="(a)"):
    """Phase 11 (a) (chi2) and (g) (gcv): the day's nrec records in exact
    mode with REGULARIZATION_METHOD = ``method`` through
    Interpolate.calc_coeffs: no NaN beyond the QC'd empty records, no
    negative chi2, 0 card and DAY_EIGHS[method] host eighs a record (each
    chunk padded to 128 on the card) and R's once; ``windows`` (oracle
    tag, first record, records or None for the oracle's; HI_DAY_WINDOWS'
    by default) held to their JAX oracles: the NaN set and the W-weighted
    field bars, chi2 to the fit bars in chi2 and printed in gcv (phase
    4c's), with GCV's alphas against the oracle's.  Returns the fit's
    Interpolate."""
    nrec = day["nrec"]
    if windows is None:
        windows = HI_DAY_WINDOWS[method]
    head = f"phase 11 highorder {label} day, {method}"
    interp, secs, (card, host, host_s), peak = hi_fit("exact", device, day,
                                                      nrec, method)
    rss_peak, rss = rss_gib()
    C, chi2 = interp.Coeffs, interp.chi_sq
    prof = interp.timer.report()
    fit_s, copy_s = prof["fit_records"], prof["copy_to_host"]
    value, _ = oracle_day(nrec)
    empty = ~np.isfinite(value).any(1)
    nan = np.isnan(chi2)
    per = DAY_EIGHS[method]
    want = per * fitted(nrec, device) + 1
    print(f"{head}: Interpolate.calc_coeffs of {nrec} records (the "
          f"oracle's QC'd bytes, chunks {chunk_sizes(nrec)}) {secs:.3f} s, "
          f"of which fit_records {fit_s:.3f} s = {nrec / fit_s:.3f} "
          f"records/s [{CARD}]", flush=True)
    print(f"{head}: the copies of C, dC, chi2 and alpha to the host "
          f"{copy_s:.3f} s [{CARD}]", flush=True)
    print(f"{head} eighs: card {card / nrec:.3f}, host {host / nrec:.3f} a "
          f"record ({host} = {per} x {fitted(nrec, device)} records with the "
          f"card's padding + R's once) [{CARD}]", flush=True)
    print(f"{head}: host_eigh {host_s:.3f} s = "
          f"{host_s / max(host, 1) * 1e3:.2f} ms a matrix of 1200 x 1200 "
          f"[{CARD}]", flush=True)
    print(f"{head}: peak device memory {peak:.3f} GiB"
          + (f" (the unsliced 32-record window's {GCV_WINDOW_PEAK_GIB} GiB)"
             if method == "gcv" else "") + f" [{CARD}]", flush=True)
    if device == "cuda":
        print_pinned(f"after phase 11's {method} day [{CARD}]")
    print(f"{head}: host RSS peak {rss_peak:.3f} GiB, now {rss:.3f} GiB (the "
          f"day's covariance {interp.Covariance.nbytes / 2**30:.3f} GiB) "
          f"[{CARD}]", flush=True)
    check(C.shape == (nrec, 1200) and chi2.shape == (nrec,),
          f"day: C {C.shape}, chi2 {chi2.shape}")
    check(not (nan & ~empty).any(),
          f"day: NaN records {np.flatnonzero(nan & ~empty).tolist()} have "
          "data")
    check(np.isfinite(C[~nan]).all() and (chi2[~nan] >= 0).all(),
          f"day: non-finite coefficients or {int((chi2[~nan] < 0).sum())} "
          "negative chi2")
    check(card == 0 and host == want,
          f"day: {card} eighs on the card, {host} on the host; 0 and {want} "
          "expected")
    if method == "gcv" and device == "cuda":
        check(peak < GCV_WINDOW_PEAK_GIB,
              f"day: peak device memory {peak:.3f} GiB, not under the "
              f"32-record window's {GCV_WINDOW_PEAK_GIB} GiB")
    for tag, start, n in windows:
        what = f"order {HI_ORDER} {method} day, {tag}"
        rel, _, _, line = held_to_hi_oracle(what, interp, tag, start, n)
        if method == "chi2":
            held_to_bars(f"{what}: chi2 vs its oracle", rel, CHI2_MEDIAN_TOL,
                         CHI2_MAX_TOL)
        print(f"{head} {line}", flush=True)
    print(f"{head}: {int(nan.sum())} NaN records, all QC'd empty "
          f"({int(empty.sum())} empty), 0 negative chi2", flush=True)
    return interp


def phase_highorder_windows(device="cuda", windows=HI_WINDOWS):
    """Phase 11 (b): the windows of HI_WINDOWS through calc_coeffs, each
    against its JAX oracle: NaN set, no negative chi2, the W-weighted field
    bars; chi2 to the fit bars in fast and manual and to their max in
    exact_grid (phase 4's); manual's alpha the config's for every record;
    host eighs a record (the card's padding to 128 records included) and
    none on the card."""
    for tag, method, mode, nrec in windows:
        interp, secs, (card, host, host_s), peak = hi_fit(mode, device,
                                                          nrec=nrec,
                                                          method=method)
        what = f"order {HI_ORDER} {tag}"
        rel, _, _, line = held_to_hi_oracle(what, interp, tag, 0, nrec)
        reg = interp.reg_params[:, 0]
        if mode == "exact_grid":
            want = grid_eighs(interp, nrec, device, reg)
            check(np.nanmax(rel) <= CHI2_MAX_TOL, f"{what}: chi2 vs its "
                  f"oracle max {np.nanmax(rel):.3e} (bar {CHI2_MAX_TOL})")
        else:
            # fast: AtWA's, the whitened pencil's and the final solve's a
            # record; manual: the final solve's
            want = {"fast": 3, "manual": 1}[tag] * fitted(nrec, device)
            held_to_bars(f"{what}: chi2 vs its oracle", rel, CHI2_MEDIAN_TOL,
                         CHI2_MAX_TOL)
        if method == "manual":
            alpha = regparam.manual_reg_param("0thorder")
            check(np.allclose(reg, alpha, rtol=1e-12, atol=0.0),
                  f"{what}: alpha is not the config's {alpha:g}")
            line += f"; alpha {alpha:g} for every record"
        fit_s = interp.timer.report()["fit_records"]
        print(f"phase 11 highorder (b) fit, {tag} (REGULARIZATION_METHOD = "
              f"{method}, REGPARAM_MODE = {mode}): calc_coeffs of {nrec} "
              f"records {secs:.3f} s, of which fit_records {fit_s:.3f} s = "
              f"{nrec / fit_s:.3f} records/s; eighs a record: card "
              f"{card / nrec:.3f}, host {host / nrec:.3f} ({host} matrices "
              f"of 1200 x 1200, the card's padding to "
              f"{fitted(nrec, device)} records included; {host_s:.3f} s in "
              f"host_eigh); peak device memory {peak:.3f} GiB [{CARD}]; "
              f"{line}", flush=True)
        check(card == 0 and host == want, f"{what}: {card} eighs on the "
              f"card, {host} on the host; 0 and {want} expected")
        del interp


def phase_highorder_lambda(device="cuda"):
    """Phase 11 (b), last: tests/test_highorder.py's lambda sweep,
    monotone to its slack (tests/test_torch_highorder.py holds the CPU's
    values against the JAX package's)."""
    model = hi_model()
    rng = np.random.default_rng(7)  # test_highorder.py's problem
    npts = 800
    lat, lon = rng.uniform(74, 82, npts), rng.uniform(252, 272, npts)
    alt = rng.uniform(1e5, 6e5, npts)
    A = torch.as_tensor(model.basis(lat, lon, alt), device=device)
    v = torch.as_tensor(4e11 * np.exp(-(((alt - 3e5) / 1.2e5) ** 2)),
                        device=device)
    err = torch.full_like(v, 1e-21 ** -0.5)
    AtWA, AtWb, btWb, _ = (x[0] for x in solve.suff_stats(A, v[None],
                                                          err[None]))
    R = torch.as_tensor(model.eval_psi(), device=device)
    a = torch.as_tensor(10.0 ** HI_SWEEP, device=device)[:, None, None]
    c0 = eigh_counts()
    _sync(device)
    t0 = time.perf_counter()
    vals = solve.cutoff_chi2(a, AtWA, AtWb, btWb, R).cpu().numpy()
    sweep_s = time.perf_counter() - t0
    card, host, host_s = eighs_since(c0)
    floor = 1e-6 * vals.max()
    steps = vals[1:] - (vals[:-1] - np.abs(vals[:-1]) * HI_SWEEP_SLACK - floor)
    print(f"phase 11 highorder (b) lambda sweep: cutoff_chi2 at "
          f"{len(HI_SWEEP)} log10 alphas {HI_SWEEP[0]:g}..{HI_SWEEP[-1]:g} "
          f"({npts} points) {sweep_s:.3f} s, eighs card {card} host {host} "
          f"({host_s:.3f} s); chi2 {np.array2string(vals, precision=6)}; "
          f"least step over the slack {steps.min():.4e}", flush=True)
    check(np.isfinite(vals).all() and (steps >= 0).all(),
          "lambda sweep: chi2(alpha) not monotone to the slack")
    check(card == 0 and host == len(HI_SWEEP), "lambda sweep: eighs")


def phase_highorder_keogram(interp, device="cuda", axes=HI_KEOGRAM,
                            label="(c)"):
    """Phase 11 (c) and (g): the day's product, every fitted record at the
    meridian keogram's points through Estimate.evaluate_records of a
    mem_estimate (no file, no copy of the covariance) with the FoV mask:
    one launch of the tiled kernel (evaluate_records' chunk holds 2^27
    point-records) and none of grid_eval.cu, against the float64 twin
    (the Estimate's evaluator and mask, float64 points and records): the
    same NaN set, each point within GRID_TOL of its record's sup plus
    GROSS_TOL of its gross sum (phase 5's bar for fitted records; the
    fraction of the record's sup printed).  Returns the launches it
    made."""
    est = mem_estimate(interp, device, "day1.h5")
    times = [EPOCH + dt.timedelta(seconds=float(t))
             for t in np.mean(est.time, axis=1)]
    nrec = len(times)
    glat, glon, galt = grid(*axes)
    tiled0, plain0 = grid_eval_cuda.tiled_launches, grid_eval_cuda.launches
    _reset_peak(device)
    t0 = time.perf_counter()
    vol = est.evaluate_records(times, glat, glon, galt, check_hull=True)
    secs = time.perf_counter() - t0
    launched = grid_eval_cuda.tiled_launches - tiled0
    peak = _peak_gib(device)
    check(vol.shape == (nrec,) + glat.shape and vol.dtype == np.float32,
          f"keogram shape {vol.shape} {vol.dtype}")
    want = int(device == "cuda")  # the CPU runs the plain twin
    check(launched == want and grid_eval_cuda.launches == plain0,
          f"keogram: {launched} launches of the tiled kernel, "
          f"{grid_eval_cuda.launches - plain0} of grid_eval.cu; {want} and 0"
          " expected")
    g, ev = est._prepared_grid, est._grid_ev
    Cs = np.stack([np.asarray(est.get_C(t)[0], np.float64) for t in times])
    pts = [torch.as_tensor(a.ravel(), dtype=torch.float64, device=device)
           for a in (glat, glon, galt)]
    ref = grid_eval_cuda.eval_records_plain(
        *pts, ev.fold_coeffs(Cs, torch.float64), ev, g["inside"])
    out = torch.as_tensor(vol.reshape(nrec, -1), device=device)
    nan = torch.isnan(ref)
    check(torch.equal(torch.isnan(out), nan),
          "keogram: kernel and twin NaN sets differ")
    zero = torch.zeros((), dtype=ref.dtype, device=device)
    diff = torch.where(nan, zero, (out.double() - ref).abs())
    sup = torch.where(nan, zero, ref.abs()).amax(1)
    err = diff.amax(1)
    worst = int(torch.argmax(err / torch.where(sup > 0, sup, 1.0)))
    # fitted coefficients cancel ~3e3-fold, so float32 holds each point to
    # phase 5's bar: GRID_TOL of the record's sup plus GROSS_TOL of the
    # point's gross sum |A||C| (the design path, float64 on the device)
    gross = (est.model.basis(*pts).abs()
             @ torch.as_tensor(np.abs(Cs), device=device).T).T
    over = diff - (GRID_TOL * sup[:, None] + GROSS_TOL * gross)
    over = torch.where(nan, -1.0, over)
    r, i = divmod(int(torch.argmax(over)), over.shape[1])
    check(float(over[r, i]) <= 0.0,
          f"keogram: record {r} point {i}: kernel error "
          f"{float(diff[r, i]):.3e} > {GRID_TOL} x the record's sup "
          f"{float(sup[r]):.3e} + {GROSS_TOL} x the point's gross sum "
          f"{float(gross[r, i]):.3e}")
    live = int((~nan).any(1).sum())
    print(f"phase 11 highorder {label} keogram: evaluate_records({nrec} fitted "
          f"records x {glat.size} meridian points, FoV mask) {secs:.3f} s "
          f"({nrec * glat.size / secs:.4e} points/s: "
          f"{_phases(est.timer.report())}), peak device memory "
          f"{peak:.3f} GiB [{CARD}]; {launched} launch of grid_eval_tiled.cu "
          f"for {nrec} records ({len(grid_eval_cuda.record_groups(nrec))} "
          f"groups of {grid_eval_cuda.GROUP}), none of grid_eval.cu; "
          f"{int((~nan[0]).sum())} points in the FoV, {live} records with a "
          f"finite value; max|kernel - f64 twin| "
          f"{float(err[worst] / sup[worst]):.3e} of the record's sup (record "
          f"{worst}; records within {KERNEL_TOL} of it: "
          f"{int((err <= KERNEL_TOL * sup).sum())}), "
          f"{float((diff / torch.where(nan, 1.0, gross)).max()):.3e} of the "
          f"point's gross sum, within {GRID_TOL} x sup + {GROSS_TOL} x gross "
          f"at every point; NaN sets equal", flush=True)
    return launched


def phase_highorder_lobo(device="cuda", day=DAY):
    """Phase 11 (d): lobo_cv of the first HI_LOBO_NREC records against
    the highorder_lobo oracle's rows for them (its argmin and summed
    scores taken over those rows)."""
    o = np.load(ROOT / "tests" / "oracle" / "day1000_seed1_highorder_lobo.npz")
    per_o = o["per"][:HI_LOBO_NREC]
    scores_o = per_o.sum(axis=(0, 1))
    data = day_data(day)
    _, lat, lon, alt, _, _ = qc(data)
    value, error = oracle_day(HI_LOBO_NREC)
    la = [float(x) for x in o["alphas"]]
    model = hi_model()
    A, R = model.basis(lat, lon, alt), model.eval_psi()
    c0 = eigh_counts()
    _sync(device)
    t0 = time.perf_counter()
    scores, per = sweep.lobo_cv(value, error, A, beam_indices(data), R, la,
                                device=device)
    _sync(device)
    lobo_s = time.perf_counter() - t0
    card, host, host_s = eighs_since(c0)
    rel = np.abs(per - per_o) / np.abs(per_o)
    best, best_o = la[int(np.argmin(scores))], la[int(np.argmin(scores_o))]
    n = per.size
    print(f"phase 11 highorder (d) sweep: lobo_cv({HI_LOBO_NREC} records x "
          f"20 beams x {len(la)} log10 alphas {la[0]:g}..{la[-1]:g}) "
          f"{lobo_s:.3f} s, eighs card {card} host {host} "
          f"(lobo_scores_per_s {n / lobo_s:.1f}, host_eigh_seconds "
          f"{host_s:.3f}); argmin {best:g} (oracle {best_o:g}); per-entry "
          f"rel median "
          f"{np.median(rel):.4e} (bar {HI_LOBO_ENTRY_MEDIAN_TOL}), by alpha "
          f"{np.round(np.median(rel, axis=(0, 1)), 5).tolist()}; summed "
          f"scores rel {float(np.max(np.abs(scores - scores_o) / scores_o)):.3e}",
          flush=True)
    check(per.shape == per_o.shape, f"lobo_cv per {per.shape}")
    check(card == 0 and host == n, f"lobo_cv: {card} eighs on the card, "
          f"{host} on the host; 0 and {n} expected")
    check(best == best_o, "lobo_cv argmin")
    check(np.median(rel) <= HI_LOBO_ENTRY_MEDIAN_TOL,
          f"lobo_cv per-entry median {np.median(rel):.3e}")


def phase_highorder_product(interp, device="cuda", shape=(512, 512, 128),
                            nrec=HI_PRODUCT_NREC, finite_frac=FINITE_FRAC):
    """Phase 11 (e): the day's first nrec records on the grid
    with the FoV mask through Estimate.evaluate_records (the kernel's
    HI_ORDER instantiation), against the float64 design path x C at 10^4
    points.  Returns the tiled kernel's launches it made."""
    est = mem_estimate(interp, device, "day1.h5")
    times = [EPOCH + dt.timedelta(seconds=float(t))
             for t in np.mean(est.time, axis=1)[:nrec]]
    glat, glon, galt = grid(*shape)
    before = grid_eval_cuda.tiled_launches
    _reset_peak(device)
    t0 = time.perf_counter()
    vol = est.evaluate_records(times, glat, glon, galt, check_hull=True)
    cold_s = time.perf_counter() - t0
    cold = est.timer.report()
    t0 = time.perf_counter()
    vol2 = est.evaluate_records(times, glat, glon, galt, check_hull=True)
    warm_s = time.perf_counter() - t0
    launched = grid_eval_cuda.tiled_launches - before
    peak = _peak_gib(device)
    warm = {k: v - cold.get(k, 0.0) for k, v in est.timer.report().items()}
    check(vol.shape == (nrec,) + glat.shape and vol.dtype == np.float32,
          f"product shape {vol.shape} {vol.dtype}")
    check(np.array_equal(vol, vol2, equal_nan=True), "repeat call differs")
    ff = float(np.isfinite(vol).mean())
    if finite_frac is not None:
        check(abs(ff - finite_frac) <= 1e-3, f"finite fraction {ff:.4f}")
    idx = np.random.default_rng(3).choice(glat.size, 10_000, replace=False)
    pts = [a.ravel()[idx] for a in (glat, glon, galt)]
    fast = vol[0].ravel()[idx]
    exact = est(times[0], *pts)
    check(np.array_equal(np.isnan(fast), np.isnan(exact)),
          "product and the float64 design path: NaN sets differ")
    C0 = np.asarray(est.get_C(times[0])[0], np.float64)
    gross = np.abs(est.model.basis(*pts) * C0).sum(-1)
    fin = np.isfinite(exact)
    sup = np.max(np.abs(exact[fin]))
    diff = np.abs(fast - exact)[fin]
    check((diff <= GRID_TOL * sup + GROSS_TOL * gross[fin]).all(),
          f"product error {diff.max():.3e} beyond {GRID_TOL} x sup "
          f"{sup:.3e} + {GROSS_TOL} x gross")
    npts = glat.size * nrec
    print(f"phase 11 highorder (e) product: evaluate_records({nrec} fitted "
          f"records x {glat.size} points, FoV mask) cold {cold_s:.3f} s "
          f"({npts / cold_s:.4e} points/s: {_phases(cold)}), warm "
          f"{warm_s:.3f} s ({npts / warm_s:.4e} points/s: {_phases(warm)}), "
          f"peak device memory {peak:.3f} GiB; finite fraction {ff:.4f}; "
          f"vs the float64 design path x C at 10^4 points ({int(fin.sum())} "
          f"in the FoV): max {diff.max() / sup:.3e} of sup, "
          f"{np.max(diff / gross[fin]):.3e} of the gross sum, gross / sup "
          f"up to {gross[fin].max() / sup:.3e}; kernel launches {launched}",
          flush=True)
    return launched


# phase 11 (f): (label, grid axes, records, mask), as KERNEL_SHAPES: the
# product's shape with 8 records, the first port's timing row, a day's
# meridian keogram at 512 records and at the 1000 of phase 11 (c)'s
# launch, and Estimate.grid_eval's one record
HI_KERNEL_SHAPES = (
    ("config-4 x 8 FoV", (512, 512, 128), 8, "fov"),
    ("8.4M x 8", (512, 512, 32), 8, None),
    ("keogram 65536 x 512", HI_KEOGRAM, 512, None),
    ("keogram 65536 x 1000", HI_KEOGRAM, 1000, None),  # phase 11 (c)'s day
    ("config-4 x 1", (512, 512, 128), 1, None),
)


def same_bits(got, want, what):
    """got and want have the same NaN set and bit-equal values elsewhere."""
    nan = torch.isnan(want)
    check(torch.equal(torch.isnan(got), nan), f"{what}: NaN sets differ")
    check(torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32)),
          f"{what}: values differ from the whole launch's bits")


def highorder_subsets(ev, pts32, ceff32, inside, out):
    """The subset property on the card: half the grid (each half), the
    grid under a mask cut down to two thirds of its points, and the first
    record alone give the bits of the whole launch ``out``."""
    npts = pts32[0].numel()
    half = npts // 2
    for sl in (slice(0, half), slice(half, npts)):
        same_bits(grid_eval_cuda.eval_records(
            *[p[sl] for p in pts32], ceff32, ev, inside[sl]), out[:, sl],
            f"points {sl.start}..{sl.stop}")
    cut = inside & (torch.arange(npts, device=inside.device) % 3 != 0)
    same_bits(grid_eval_cuda.eval_records(*pts32, ceff32, ev, cut),
              torch.where(cut, out, float("nan")), "the cut-down mask")
    same_bits(grid_eval_cuda.eval_records(*pts32, ceff32[:1], ev, inside),
              out[:1], "record 0 alone")
    print(f"phase 11 highorder (f) subsets: points 0..{half} and {half}.."
          f"{npts}, the mask cut to {int(cut.sum())} of {int(inside.sum())} "
          f"points, record 0 alone (contraction TM "
          f"{grid_eval_cuda.contraction_tm(grid_eval_cuda.kernel_config(*HI_ORDER), 1)}"
          f" against {grid_eval_cuda.contraction_tm(grid_eval_cuda.kernel_config(*HI_ORDER), out.shape[0])}):"
          " the bits of the whole launch", flush=True)


def phase_highorder_kernel(C_fit, device="cuda", shapes=HI_KERNEL_SHAPES,
                           reps=10):
    """Phase 11 (f): the HI_ORDER kernel against its float64 twin at each
    of ``shapes``, random records, within KERNEL_TOL of the sup, same NaN
    set; its time, bound and share, beside a float32 matmul of the
    contraction's shape ([live points, maxl^2] x [maxl^2, records x maxk]:
    a yardstick for the contraction alone, no call of the port); the subset
    property at the first shape (on the card); then the day's
    fitted records at the first shape (unless C_fit is None), printed.
    Returns the kernel's JSON entry (the first shape's numbers, every
    shape's under "shapes")."""
    cuda = device == "cuda"
    entry = None
    rows = []
    cases = [s + (None,) for s in shapes]
    if C_fit is not None:
        label, axes, _, mask = shapes[0]
        cases.append((label + ", fitted records", axes, HI_PRODUCT_NREC,
                      mask, C_fit[:HI_PRODUCT_NREC]))
    cfg = grid_eval_cuda.kernel_config(*HI_ORDER)
    for label, axes, nrec, mask, Cs in cases:
        ev, pts32, pts64, ceff32, ceff64, inside = kernel_inputs(
            axes, nrec, mask, device, order=HI_ORDER, Cs=Cs)
        npts = pts32[0].numel()
        out = grid_eval_cuda.eval_records(*pts32, ceff32, ev, inside)
        ref = grid_eval_cuda.eval_records_plain(*pts64, ceff64, ev, inside)
        if Cs is None:
            err, sup = held_against_twin(out, ref, f"{HI_ORDER} {label}")
        else:
            nan = torch.isnan(ref)
            check(torch.equal(torch.isnan(out), nan), f"{label}: NaN sets")
            sup = float(ref[~nan].abs().max())
            err = float((out.double() - ref)[~nan].abs().max())
        n_live = int((~torch.isnan(ref[0])).sum())
        del ref
        flop, nbytes = kernel_work(ev, npts, nrec, n_live, inside is not None)
        b_ms, b_by = bound_ms(flop, nbytes)
        ms = cuda_ms(lambda: grid_eval_cuda.eval_records(
            *pts32, ceff32, ev, inside), reps) if cuda else float("nan")
        line = (f"phase 11 highorder (f) kernel {HI_ORDER}, {label}: {npts} "
                f"points x {nrec} records, degree {ev.degree}, {ev.npairs} "
                f"pairs, {n_live} live points, "
                f"{len(grid_eval_cuda.record_chunks(cfg, ev.degree, nrec))} "
                f"launch, contraction TM "
                f"{grid_eval_cuda.contraction_tm(cfg, nrec)}: kernel "
                f"{ms:.4f} ms; work {flop:.4e} flop, {nbytes:.4e} bytes, "
                f"bound {b_ms:.4f} ms ({b_by}), share {b_ms / ms:.3f}; "
                f"max|kernel - f64 twin| = {err / sup:.3e} of sup"
                + (f" (bar {KERNEL_TOL})" if Cs is None else
                   " (fitted records: printed, held by (e))"))
        if Cs is None:
            mm_ms = float("nan")
            if cuda:
                A = torch.randn(n_live, cfg.nrows, device=device)
                B = torch.randn(cfg.nrows, nrec * ev.maxk, device=device)
                mm_ms = cuda_ms(lambda: torch.matmul(A, B), reps)
                del A, B
            line += f"; float32 matmul [{n_live}, {cfg.nrows}] x " \
                    f"[{cfg.nrows}, {nrec * ev.maxk}] {mm_ms:.4f} ms"
            rows.append({"shape": label, "ms": ms, "bound_ms": b_ms,
                         "bound_by": b_by, "share": b_ms / ms,
                         "max_abs_err": err, "matmul_ms": mm_ms})
        if entry is None:
            plain_ms = cuda_ms(lambda: grid_eval_cuda.eval_records_plain(
                *pts32, ceff32, ev, inside), 1) if cuda else float("nan")
            line += f"; f32 twin {plain_ms:.4f} ms"
            entry = {"name": "grid_eval_tiled", "route": "cuda",
                     "source": "volumetricinterp_tpu_torch/csrc/grid_eval_tiled.cu",
                     "replaces": "volumetricinterp_tpu/ops/grid_eval_pallas.py:94",
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "share": b_ms / ms, "library_ms": None, "shapes": rows}
        print(line, flush=True)
        if cuda and Cs is None and inside is not None:
            highorder_subsets(ev, pts32, ceff32, inside, out)
        del ev, pts32, pts64, ceff32, ceff64, inside, out
        if cuda:
            torch.cuda.empty_cache()
    return entry


def phase_highorder(device="cuda", shape=(512, 512, 128),
                    finite_frac=FINITE_FRAC):
    """Phase 11: BASELINE config 3 through the port's main path; returns
    the HI_ORDER kernel's JSON entry with its launches on this path (all
    of them grid_eval_tiled.cu's: none of grid_eval.cu), counted from 0
    over (a)-(e) and again over (g), not over (f)'s comparisons."""
    grid_eval_cuda.launches = grid_eval_cuda.tiled_launches = 0
    phase_highorder_basis()
    interp = phase_highorder_day(device)
    phase_highorder_windows(device)
    phase_highorder_lambda(device)
    keogram = phase_highorder_keogram(interp, device)
    phase_highorder_lobo(device)
    launched = phase_highorder_product(interp, device, shape,
                                       finite_frac=finite_frac)
    launches = grid_eval_cuda.tiled_launches
    check(launched > 0 and launches == keogram + launched
          and grid_eval_cuda.launches == 0,
          f"phase 11: the keogram and the product launched the tiled kernel "
          f"{keogram} and {launched} times of {launches}, grid_eval.cu "
          f"{grid_eval_cuda.launches} times")
    entry = phase_highorder_kernel(interp.Coeffs, device)
    # (g): one day in host memory at a time
    del interp
    gc.collect()
    print(f"phase 11 highorder (g): the exact day dropped, host RSS now "
          f"{rss_gib()[1]:.3f} GiB [{CARD}]", flush=True)
    grid_eval_cuda.launches = grid_eval_cuda.tiled_launches = 0
    interp = phase_highorder_day(device, method="gcv", label="(g)")
    gcv_keogram = phase_highorder_keogram(interp, device, label="(g)")
    check(grid_eval_cuda.tiled_launches == gcv_keogram
          and gcv_keogram == int(device == "cuda")
          and grid_eval_cuda.launches == 0,
          f"phase 11 (g): the keogram launched the tiled kernel "
          f"{gcv_keogram} times of {grid_eval_cuda.tiled_launches}, "
          f"grid_eval.cu {grid_eval_cuda.launches} times")
    entry["launches"] = launches + grid_eval_cuda.tiled_launches
    return entry


def _phases(times):
    return ", ".join(f"{k} {v:.3f} s" for k, v in times.items() if v > 0)


def print_pinned(when):
    """The peak bytes that PyTorch's page-locked host allocator has held so
    far, its cached blocks included and each rounded up to a power of two
    (torch.cuda.host_memory_stats): solve.host_eigh's copies draw on it,
    and it keeps what they freed."""
    held = torch.cuda.host_memory_stats().get("allocated_bytes.peak")
    print(f"page-locked host memory {when}: peak held "
          + ("not reported" if held is None else f"{held / 2**30:.3f} GiB"),
          flush=True)
    return held


def main():
    if sys.argv[1:2] == ["--parallel-child"]:
        return parallel_child(int(sys.argv[2]), *sys.argv[3:7])
    phase_device()
    for what, nrec, uncut in TIME_CUTS:
        print(f"cut for the run's time limit: {what} on {nrec} records "
              f"(from {uncut})", flush=True)
    phase_build()
    kernel = phase_kernel()
    # the main path: launch counts from here on
    grid_eval_cuda.launches = 0
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=ROOT) as tmp:
        phase_fit(Path(tmp))
        print_pinned("after phase 4 (exact_grid, batches of "
                     f"{regparam.EIGH_BATCH} matrices)")
        est = phase_fit_default(Path(tmp))
        phase_fit_fault(Path(tmp))
        phase_time_axis(Path(tmp))
        phase_fit_windows(Path(tmp))
        prod = phase_product(est)
        # phase 10 needs the Estimate's hull, not the grid it holds on the
        # card
        est._prepared_grid = est._grid_ev = None
        phase_radbasfun()
        phase_sweep()
        phase_parallel(Path(tmp))
        phase_busy()
        phase_api(est, prod)
    kernel["launches"] = grid_eval_cuda.launches
    check(kernel["launches"] > 0, "the main path never launched the kernel")
    # BASELINE config 3's path, its launches counted from 0 again
    before = print_pinned("before phase 11")
    hi_kernel = phase_highorder()
    held = print_pinned(f"over the run [{CARD}]")
    if held is not None:
        bound = before + PINNED_SLICES * solve.HOST_EIGH_SLICE_BYTES
        check(held <= bound, f"page-locked memory {held / 2**30:.3f} GiB "
              f"held, over {bound / 2**30:.3f} GiB: what phases 1-10 held and "
              f"{PINNED_SLICES} of host_eigh's slices")
        print(f"page-locked host memory over the run {held / 2**30:.3f} GiB, "
              f"bound {bound / 2**30:.3f} GiB (phases 1-10 "
              f"{before / 2**30:.3f} GiB and {PINNED_SLICES} slices of "
              f"{solve.HOST_EIGH_SLICE_BYTES / 2**30:g} GiB)", flush=True)
    print(json.dumps({"kernels": [kernel, hi_kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
