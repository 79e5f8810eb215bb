"""Jointly time-regularized fits: a time penalty coupling records inside
the solve, in float64 torch on the device.

The float64 path of ``volumetricinterp_tpu/ops/timejoint.py``: instead of
smoothing per-record coefficient trajectories after independent fits
(ops/timesmooth.py), the records are solved together,

    min_C  sum_r ||W_r^1/2 (A C_r - b_r)||^2
         + sum_r sum_i alpha_ri C_r' R_i C_r
         + beta  sum_r ||C_{r+1} - C_r||^2 ,

whose normal equations are block-tridiagonal in the record index:

    (X_r + c_r beta I) C_r - beta C_{r-1} - beta C_{r+1} = AtWb_r ,

with X_r = AtWA_r + sum_i alpha_ri R_i and c_r the neighbour count (1 at
the ends, 2 inside).  The alphas come from the standard search; beta is
relative to the mean data-term scale, beta = beta_rel mean_r
trace(AtWA_r) / nbasis.  Records whose search failed (NaN alpha) are
solved at alpha ~ 0 and carried by their neighbours.

The block Thomas algorithm is a Python loop of nrec dependent steps, each
one nbasis x nbasis float64 inverse on the device; the statistics come
from solve.suff_stats a record chunk at a time, so no [nrec, npoints,
nbasis] array is formed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .solve import masked_points, suff_stats

STATS_CHUNK = 128  # records a sufficient-statistics batch


def joint_time_solve(AtWA, AtWb, reg_mats, log_alphas, beta_rel,
                     jitter_rel=1e-7):
    """Block-tridiagonal solve of the jointly time-regularized system.

    AtWA [nrec, nb, nb], AtWb [nrec, nb], reg_mats [nreg, nb, nb],
    log_alphas [nrec, nreg] (log10; -inf and NaN -> alpha ~ 0), float64
    tensors on one device; beta_rel the coupling relative to the mean
    data-term scale.  Returns C [nrec, nb].  The normalization (one global
    scale s, alphas as exp(clip(ln alpha - ln s, +-80)), the jitter) is the
    JAX package's verbatim: it changes the answer."""
    nrec, nb, _ = AtWA.shape
    s = torch.diagonal(AtWA, dim1=-2, dim2=-1).sum(-1).mean() / nb
    s = torch.where(s > 0, s, torch.ones_like(s))
    Xn = AtWA / s
    rhs = AtWb / s
    if reg_mats.shape[0]:
        la = torch.nan_to_num(log_alphas, nan=-math.inf)  # failed -> alpha 0
        # alpha / s in normalized units; alphas span 1e-100..1, so work in
        # logs and flush what underflows (it is sub-coupling anyway)
        a_n = torch.exp(torch.clamp(la * math.log(10.0) - torch.log(s),
                                    -80.0, 80.0))
        Xn = Xn + torch.einsum("ri,ijk->rjk", a_n, reg_mats)
    beta = float(beta_rel)
    eye = torch.eye(nb, dtype=AtWA.dtype, device=AtWA.device)
    c_r = torch.full((nrec,), 2.0, dtype=AtWA.dtype, device=AtWA.device)
    c_r[0] = c_r[-1] = 1.0
    diag = Xn + (c_r[:, None, None] * beta + jitter_rel) * eye

    # forward elimination: S_r = D_r - beta^2 S_{r-1}^-1,
    # y_r = rhs_r + beta S_{r-1}^-1 y_{r-1}
    Sinv = torch.empty_like(diag)
    y = torch.empty_like(rhs)
    for r in range(nrec):
        if r == 0:
            S, y[0] = diag[0], rhs[0]
        else:
            S = diag[r] - (beta * beta) * Sinv[r - 1]
            y[r] = rhs[r] + beta * (Sinv[r - 1] @ y[r - 1])
        Sinv[r] = torch.linalg.inv_ex(S)[0]

    # back substitution: C_n = Sinv_n y_n; C_r = Sinv_r (y_r + beta C_{r+1})
    C = torch.empty_like(rhs)
    C[-1] = Sinv[-1] @ y[-1]
    for r in range(nrec - 2, -1, -1):
        C[r] = Sinv[r] @ (y[r] + beta * C[r + 1])
    return C


def time_stats(values, errors, A):
    """(AtWA, AtWb) of every record, solve.suff_stats a STATS_CHUNK of
    records at a time; values/errors [nrec, npoints], A [npoints, nb]
    tensors."""
    parts = [suff_stats(A, values[s:s + STATS_CHUNK], errors[s:s + STATS_CHUNK])
             for s in range(0, values.shape[0], STATS_CHUNK)]
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))


def fit_time_coupled(values, errors, A, reg_mats, log_alphas, beta_rel,
                     device="cuda"):
    """Jointly re-solve a day's records at the alphas the standard search
    selected.

    values/errors [nrec, npoints] (NaN = no data); A [npoints, nb];
    reg_mats [nreg, nb, nb]; log_alphas [nrec, nreg] log10 alphas (NaN =
    failed search -> alpha ~ 0, carried by the neighbours): host arrays,
    moved to ``device`` in float64.  Returns host (C [nrec, nb],
    chi2 [nrec]), chi2 the data chi-square of the joint solution."""
    values, errors, A, reg_mats, log_alphas = (
        torch.as_tensor(np.asarray(x, np.float64), device=device)
        for x in (values, errors, A, reg_mats, log_alphas))
    AtWA, AtWb = time_stats(values, errors, A)
    C = joint_time_solve(AtWA, AtWb, reg_mats, log_alphas, beta_rel)
    b, W, mask = masked_points(values, errors)
    r = torch.where(mask, b - C @ A.T, torch.zeros_like(b))
    chi2 = (W * r * r).sum(-1)
    return C.cpu().numpy(), chi2.cpu().numpy()
