"""Time-dependent coefficient smoothing (penalized B-splines), host float64.

A copy of ``volumetricinterp_tpu/ops/timesmooth.py`` (numpy only): after
the per-record fits, the coefficient trajectories C[nrec, nbasis] are
smoothed over record time with cubic P-splines (penalized B-splines,
Eilers & Marx 1996), giving a continuous C(t) that
Estimate(timeinterp='spline') evaluates at any time inside the fitted
window.  The reference leaves time handling as a TODO ("Adapt model to fit
for time", reference models/sphharmlag.py:17).

* One shared clamped-uniform cubic B-spline basis B[nrec, K] over the
  record mid-times; the penalized solve (B'B + lam D2'D2) S = B'C is one
  K-by-K factorization with nbasis right-hand sides.
* The smoothing parameter is fixed or chosen by GCV over a log grid
  through the Demmler-Reinsch diagonalization (one generalized
  eigendecomposition shared by every lambda).
* It runs on the host: K ~ tens and nrec ~ thousands make it microseconds
  of work.

The spline (knots, coefficients, lambda) is stored in the coefficient file
under /TimeFit (io/coeffs.py).
"""

from __future__ import annotations

import numpy as np

DEGREE = 3  # cubic


def make_knots(t_lo, t_hi, nseg):
    """Clamped-uniform cubic knot vector with ``nseg`` segments on
    [t_lo, t_hi]: end knots repeated DEGREE+1 times, interior knots
    equally spaced.  Basis size K = nseg + DEGREE."""
    if nseg < 1:
        raise ValueError("nseg must be >= 1")
    if not (t_hi > t_lo):
        raise ValueError("need t_hi > t_lo for a time spline")
    interior = np.linspace(t_lo, t_hi, nseg + 1)
    return np.concatenate([
        np.full(DEGREE, t_lo), interior, np.full(DEGREE, t_hi),
    ])


def nbasis_of(knots):
    return len(knots) - DEGREE - 1


def bspline_design(tq, knots):
    """Cox–de Boor cubic B-spline design matrix [len(tq), K].

    Vectorized over evaluation points; right-continuous except at the
    final knot, where the last basis function is closed (so the clamped
    end time evaluates to the last coefficient, not zero)."""
    tq = np.atleast_1d(np.asarray(tq, dtype=np.float64))
    knots = np.asarray(knots, dtype=np.float64)
    K = nbasis_of(knots)
    t_hi = knots[-1]
    # degree-0: indicator of [knots[i], knots[i+1]), closed at the top end
    n0 = len(knots) - 1
    B = ((tq[:, None] >= knots[None, :-1])
         & (tq[:, None] < knots[None, 1:])).astype(np.float64)
    at_end = tq >= t_hi
    if np.any(at_end):
        # the last nonempty interval's indicator closes at t_hi
        last = np.nonzero(knots[:-1] < knots[1:])[0][-1]
        B[at_end, :] = 0.0
        B[at_end, last] = 1.0
    for d in range(1, DEGREE + 1):
        nb = n0 - d
        left_den = knots[d:d + nb] - knots[:nb]
        right_den = knots[d + 1:d + 1 + nb] - knots[1:1 + nb]
        left = np.where(
            left_den > 0,
            (tq[:, None] - knots[None, :nb]) / np.where(left_den > 0,
                                                        left_den, 1.0),
            0.0,
        ) * B[:, :nb]
        right = np.where(
            right_den > 0,
            (knots[None, d + 1:d + 1 + nb] - tq[:, None])
            / np.where(right_den > 0, right_den, 1.0),
            0.0,
        ) * B[:, 1:1 + nb]
        B = left + right
    return B[:, :K]


def _second_diff(K):
    """Second-order difference penalty matrix D2 [(K-2), K]."""
    D = np.zeros((K - 2, K))
    for i in range(K - 2):
        D[i, i:i + 3] = (1.0, -2.0, 1.0)
    return D


def fit_time_spline(t, C, lam="gcv", nseg=None, w=None,
                    lam_grid=np.logspace(-6, 8, 57)):
    """Penalized B-spline fit of coefficient trajectories.

    t: [nrec] record mid-times (seconds); C: [nrec, nbasis]; lam: fixed
    smoothing parameter or 'gcv'; nseg: spline segments (default
    ~nrec/4, capped); w: optional per-record weights [nrec] (records
    with NaN coefficients are dropped automatically).

    Returns dict(knots, S[K, nbasis], lam) — the /TimeFit payload."""
    t = np.asarray(t, dtype=np.float64)
    C = np.asarray(C, dtype=np.float64)
    good = np.isfinite(C).all(axis=1) & np.isfinite(t)
    if w is not None:
        good &= np.isfinite(np.asarray(w)) & (np.asarray(w) > 0)
    tg, Cg = t[good], C[good]
    n = len(tg)
    if n < DEGREE + 2:
        raise ValueError(
            f"time spline needs >= {DEGREE + 2} finite records, got {n}")
    if nseg is None:
        nseg = int(np.clip(n // 4, 1, 100))
    nseg = min(nseg, max(1, n - DEGREE))  # keep B'B full-rank-ish
    knots = make_knots(tg.min(), tg.max(), nseg)
    B = bspline_design(tg, knots)
    if w is not None:
        sw = np.sqrt(np.asarray(w, dtype=np.float64)[good])
        B = B * sw[:, None]
        Cg = Cg * sw[:, None]
    K = B.shape[1]
    D = _second_diff(K)
    BtB = B.T @ B
    BtC = B.T @ Cg
    DtD = D.T @ D

    if isinstance(lam, str):
        if lam != "gcv":
            raise ValueError(f"unknown lam {lam!r} (number or 'gcv')")
        lam = _gcv_select(B, Cg, BtB, BtC, DtD, lam_grid)
    lam = float(lam)
    # both BtB and DtD are unitless in the spline-coefficient index (the
    # design is a partition of unity; D2 differences adjacent spline
    # coefficients), so lam transfers across days/parameters; epoch-second
    # magnitudes only ever enter through knot DIFFERENCES (f64-exact here)
    S = np.linalg.solve(BtB + lam * DtD, BtC)
    return {"knots": knots, "S": S, "lam": lam}


def _gcv_select(B, Cg, BtB, BtC, DtD, lam_grid):
    """Generalized cross-validation over a lambda grid, shared across all
    coefficient columns (one smoothness for the whole trajectory set).

    Demmler–Reinsch: with BtB = R'R and R^-T DtD R^-1 = U diag(s) U',
    the hat-matrix trace is sum_i 1/(1 + lam s_i) and the residual sum
    follows from the rotated coordinates — every lambda on the grid is
    then O(K * nbasis) with no further factorizations."""
    n = B.shape[0]
    # per-column normalization so large-magnitude coefficients don't
    # dominate the pooled GCV score
    scale = np.sqrt(np.mean(Cg ** 2, axis=0))
    scale = np.where(scale > 0, scale, 1.0)
    Y = Cg / scale
    jitter = 1e-10 * np.trace(BtB) / BtB.shape[0]
    R = np.linalg.cholesky(BtB + jitter * np.eye(BtB.shape[0])).T
    Rinv = np.linalg.inv(R)
    M = Rinv.T @ DtD @ Rinv
    s, U = np.linalg.eigh(0.5 * (M + M.T))
    s = np.maximum(s, 0.0)
    # rotated data: theta = U' R^-T B' Y;  fitted energy per mode is
    # theta_i^2 / (1 + lam s_i)^2 terms
    theta = U.T @ (Rinv.T @ (B.T @ Y))
    yy = np.sum(Y ** 2)
    best_lam, best_g = float(lam_grid[0]), np.inf
    for lam in lam_grid:
        shrink = 1.0 / (1.0 + lam * s)
        # rss = ||Y||^2 - 2 sum shrink theta^2 + sum shrink^2 theta^2
        th2 = np.sum(theta ** 2, axis=1)
        rss = yy - np.sum((2.0 * shrink - shrink ** 2) * th2)
        tr_h = np.sum(shrink)
        denom = max(n - tr_h, 1e-9)
        g = n * max(rss, 0.0) / denom ** 2
        if g < best_g:
            best_g, best_lam = g, float(lam)
    return best_lam


def eval_time_spline(timefit, tq):
    """C(t) from a /TimeFit payload: [len(tq), nbasis] (or [nbasis] for a
    scalar tq).  Raises ValueError outside the knot domain — callers map
    this to the reference's 'Requested time out of range' error."""
    knots = np.asarray(timefit["knots"], dtype=np.float64)
    S = np.asarray(timefit["S"], dtype=np.float64)
    scalar = np.isscalar(tq) or np.ndim(tq) == 0
    tq_arr = np.atleast_1d(np.asarray(tq, dtype=np.float64))
    if np.any(tq_arr < knots[0]) or np.any(tq_arr > knots[-1]):
        raise ValueError("Requested time out of range of data file.")
    out = bspline_design(tq_arr, knots) @ S
    return out[0] if scalar else out
