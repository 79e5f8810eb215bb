"""Sharded batched fit and grid evaluation over a Mesh.

Two stages, as in the JAX package's parallel/fit.py (fit_records_sharded,
_stats_then_solve, _gcv_stage):

1. **Statistics.**  Every rank forms its row's statistics over all the
   row's points, which it holds: the whole batch's bits.  The JAX package
   sums point-shard partials instead (a psum); on the card a fit follows
   the last bits of its statistics, and that sum in the order a
   collective picks moved every exact root of the 64-record window and
   the fast ones by up to 4e-4 (PERF.md).  The points axis shares
   out the solve.
2. **Solve.**  chi2 and manual: the row's records are split over the
   row's ranks, and each fits its share through ops/fit.fit_records from
   ops/fit.prepare_stats of the row's statistics: the decompositions of
   the single-process fit, by the same host route.  GCV: every rank of a
   row fits all the row's records, each objective evaluation computed on
   its point shard and summed over the points group (a [nrec] vector an
   evaluation, the JAX package's psum'd scalar).

The results are gathered over the world, so every rank returns the full
arrays (process 0 writes the file).  Grid evaluation is a pure map: the
points are split over every rank and the shards gathered.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fit import fit_records, prepare_stats
from ..ops.solve import suff_stats
from ..utils.device import check_device

GRID_ALIGN = 1024  # points: shards of a grid start on this multiple


def fit_records_sharded(values, errors, A, reg_mats, mesh, method="chi2",
                        manual_params=None, regparam_mode="exact",
                        reg_taus=None, device="cuda", reg_eig=None):
    """fit_records over the mesh.  Every rank passes the full values and
    errors [nrec, npoints] and A [npoints, nb] (arrays or tensors).  Returns
    the full (C, dC, chi2, reg_params) tensors on ``device`` on every rank,
    as fit_records does on one process."""
    device = check_device(device)
    f64 = lambda x: torch.as_tensor(x, dtype=torch.float64,  # noqa: E731
                                    device=device)
    values, errors, A, reg_mats = map(f64, (values, errors, A, reg_mats))
    nrec, npts = values.shape
    r, p = mesh.records, mesh.points
    # records padded with NaN (fully masked) to a multiple of the mesh size,
    # so that every rank's share has one length
    nrec_p = -(-nrec // mesh.size) * mesh.size
    if nrec_p > nrec:
        pad = torch.full((nrec_p - nrec, npts), float("nan"), device=device,
                         dtype=torch.float64)
        values, errors = torch.cat([values, pad]), torch.cat([errors, pad])
    per_row = nrec_p // r
    rows = slice(mesh.row * per_row, (mesh.row + 1) * per_row)
    cut = np.linspace(0, npts, p + 1).round().astype(int)
    pts = slice(int(cut[mesh.col]), int(cut[mesh.col + 1]))

    # stage 1: the row's statistics, over all its points on every rank
    v, e = values[rows, pts], errors[rows, pts]
    stats = suff_stats(A, values[rows], errors[rows])

    kw = dict(method=method, manual_params=manual_params,
              regparam_mode=regparam_mode, device=device, reg_eig=reg_eig,
              reg_taus=reg_taus)
    if method == "gcv":
        # stage 2, GCV: the row's records on this point shard
        prepared = prepare_stats(v, e, stats, reg_mats, method,
                                 regparam_mode, reg_eig)
        res = fit_records(v, e, A[pts], reg_mats, prepared=prepared,
                          point_sum=mesh.all_reduce, **kw)
        # one copy of the row's results enters the gather
        res = [x if mesh.col == 0 else torch.zeros_like(x) for x in res]
        offset = mesh.row * per_row
    else:
        # stage 2, chi2 and manual: this rank's share of the row's records
        per = per_row // p
        mine = slice(mesh.col * per, (mesh.col + 1) * per)
        prepared = prepare_stats(values[rows][mine], errors[rows][mine],
                                 tuple(x[mine] for x in stats), reg_mats,
                                 method, regparam_mode, reg_eig, reg_taus)
        res = fit_records(None, None, A, reg_mats, prepared=prepared, **kw)
        offset = mesh.row * per_row + mesh.col * per
    return tuple(mesh.gather(x, offset, nrec_p)[:nrec] for x in res)


def grid_eval_sharded(evaluator, C, gdlat, gdlon, gdalt, mesh, inside=None):
    """One coefficient vector on a grid, the points split over every rank
    of the mesh (shards start on multiples of GRID_ALIGN points) and
    gathered: every rank returns the whole field, shaped like gdlat, as
    ``evaluator(C, gdlat, gdlon, gdalt, inside)`` does on one process."""
    shape = np.shape(gdlat)
    lat, lon, alt = evaluator._points(gdlat, gdlon, gdalt)
    n = lat.numel()
    per = -(-n // (mesh.size * GRID_ALIGN)) * GRID_ALIGN
    sl = slice(min(mesh.rank * per, n), min((mesh.rank + 1) * per, n))
    ins = None if inside is None else inside.reshape(-1)[sl]
    Cs = np.asarray(C, np.float64).reshape(1, -1)
    part = lat[sl]  # an empty shard (more ranks than aligned blocks)
    if sl.stop > sl.start:
        part = evaluator.eval_records_flat(evaluator.fold_coeffs(Cs),
                                           lat[sl], lon[sl], alt[sl], ins)[0]
    return mesh.gather(part, sl.start, n).reshape(shape)
