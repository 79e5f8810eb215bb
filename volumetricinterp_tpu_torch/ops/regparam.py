"""Regularization-parameter selection, batched over records.

The float64 semantics of ``volumetricinterp_tpu/ops/regparam.py``, with
every per-record ``jnp.where`` a ``torch.where`` on the batch and every
``lax.fori_loop`` a Python loop of the same fixed count:

* chi2, the reference's scale-factor ladder (0.6..1.0 of N) and downward
  bracket scan over log10 alpha = 0, -1, ..., -100 (interpolate.py:152-218):
    - 'exact' (``chi2_reg_param``, the shipped default): ladder decisions
      from exact-cutoff chi^2 at the grid endpoints, then a defect-corrected
      root iteration on M-shift anchors (solve.anchor_chi2) steered by the
      whitened O(nbasis) objective; four eigendecompositions a record;
    - 'exact_grid' (``chi2_reg_param_grid``): the full 101-point grid, every
      chi^2 a fresh cutoff eigendecomposition, then 40 bisection rounds;
    - 'fast' (``chi2_reg_param_fast``): the whitened objective only (jitter
      instead of the cutoff).
* gcv: the exact leave-one-out identity minimized by scipy's 1-D
  Nelder-Mead (``nelder_mead_1d``, maxfev accounting included), over the
  anchored objective ('exact', ``gcv_reg_param_x``; its records in slices
  of at most GCV_SLICE_BYTES a tensor) or the whitened one ('fast',
  ``gcv_reg_param_fast``).
* manual: the reference's hardcoded constants (interpolate.py:353-381).

The chi2 searches take an optional TAU vector (data-informed
regularization, a pull toward a target profile; ops/solve.py): the rhs
becomes AtWb + alpha tau and chi^2 stays the data chi^2.  GCV searches
without one, as in the JAX package (ops/fit.py:180-220).

Searches return LOG10(alpha): -inf encodes the too-smooth alpha = 0 early
exit (interpolate.py:189-191) and NaN the no-bracket failure
(interpolate.py:142-147, 557-563).  Nothing between a record batch's first
eigendecomposition and its root reads a value back to the host, except the
one test a Nelder-Mead iteration makes of whether any record is still
running.
"""

from __future__ import annotations

import torch

from .solve import (EPS64, HOST_EIGH_SLICE_BYTES, TINY64, _keep_mask, _mv,
                    alpha_of_log, anchor_chi2, batched_inv, chi2_from_eig_x,
                    cutoff_chi2_x, deflated_diag, even_slices, make_anchor,
                    norm_scale, normalized_eigh, project, select_anchor,
                    sym_pinv_apply, whiten_pencil, whitened_chi2)

# reference constants (interpolate.py:173, 199-202)
SCALE_FACTORS = (0.6, 0.7, 0.8, 0.9, 1.0)
ALPHA_MIN = -100.0
N_GRID = int(-ALPHA_MIN) + 1  # 101
N_BISECT = 40
# matrices per batched eigendecomposition: bounds the [batch, nb, nb]
# working set (~0.4 GB of X, V and temporaries at nb = 144); at large nb a
# batch is at most one of host_eigh's slices (186 matrices at nb = 1200,
# where 1024 would hold ~12 GB a tensor of the working set)
EIGH_BATCH = 1024

# 'exact' mode (regparam.py:76-126, at the JAX package's shipped values)
N_DEFECT = 9  # defect-loop rounds, each one anchored exact chi^2
REANCHOR_ROUNDS = (0,)  # defect rounds that first re-anchor at the iterate
N_POLISH = 2  # rounds on the root-centred endgame anchor
BRACKET_PAD_PER_DEC = 0.08  # bracket slack per decade from the anchor ...
PAD_FREE_RADIUS = 0.25  # ... beyond this many decades
ANCHOR_TRUST = 6.0  # decades: anchored evaluations are clipped to it
INNER_K = 64  # interior points per whitened k-section round
N_INNER_ROUNDS = 5
DEFECT_MODEL_RANGE = 0.5  # decades: linear defect-model trust region
# 'fast' mode k-section (regparam.py:632-648)
FAST_K = 31
FAST_ROUNDS = 9


def _ex(t, extra):
    """t [B] -> [B, 1, ...] with ``extra`` trailing unit axes."""
    return t.reshape(t.shape + (1,) * extra)


def _clip(x, lo, hi):
    """jnp.clip: min(max(x, lo), hi), NaN-propagating, hi wins if lo > hi."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _full(like, value):
    return torch.full(like.shape[:1], value, dtype=like.dtype,
                      device=like.device)


# ---------------------------------------------------------------------------
# chi2, 'exact_grid' and 'fast': the 101-point bracket grid
# ---------------------------------------------------------------------------

def _chi2_at(log_alpha, AtWA, AtWb, btWb, R, rec, tau=None):
    """chi^2(10**log_alpha[i]) of record rec[i] with X = AtWA + alpha R
    (and the rhs AtWb + alpha tau), in batches of EIGH_BATCH matrices (of
    HOST_EIGH_SLICE_BYTES at most)."""
    out = torch.empty_like(log_alpha)
    nb = AtWA.shape[-1]
    batch = min(EIGH_BATCH, max(1, HOST_EIGH_SLICE_BYTES
                                // (nb * nb * AtWA.element_size())))
    for s in range(0, log_alpha.shape[0], batch):
        sl = slice(s, s + batch)
        r = rec[sl]
        a = alpha_of_log(log_alpha[sl])
        atau = None if tau is None else a[:, None] * tau
        out[sl] = cutoff_chi2_x(AtWA[r], AtWb[r], btWb[r],
                                a[:, None, None] * R, atau)
    return out


def _grid_bracket(chi2_grid, N):
    """The reference's ladder over the bracket grid (interpolate.py:
    180-211): chi2_grid [B, 101] at log10 alpha = 0, -1, ..., -100.
    Returns (nu, is_smooth, any_event, lo, hi) with f(lo) < 0 <= f(hi)."""
    dev, dt = chi2_grid.device, chi2_grid.dtype
    alphas = -torch.arange(N_GRID, dtype=dt, device=dev)
    sf = torch.tensor(SCALE_FACTORS, dtype=dt, device=dev)
    nus = N[:, None] * sf  # [B, 5]
    f_grid = chi2_grid[:, None, :] - nus[:, :, None]  # [B, 5, 101]
    too_smooth = f_grid[:, :, 0] < 0.0  # per sf: chi2(alpha=1) - nu < 0
    neg = f_grid < 0.0
    has_bracket = neg[:, :, 1:].any(-1) & ~too_smooth
    event = too_smooth | has_bracket
    # first scale factor with an event (argmax returns the first maximum)
    s = event.to(torch.uint8).argmax(-1, keepdim=True)
    nu = nus.gather(-1, s)[:, 0]
    is_smooth = too_smooth.gather(-1, s)[:, 0]
    neg_s = neg.gather(1, s[:, :, None].expand(-1, 1, N_GRID))[:, 0]
    j = neg_s.to(torch.uint8).argmax(-1)
    return nu, is_smooth, event.any(-1), alphas[j], alphas[(j - 1) % N_GRID]


def _outcome(root, is_smooth, any_event):
    root = torch.where(is_smooth, torch.full_like(root, -float("inf")), root)
    return torch.where(any_event, root, torch.full_like(root, float("nan")))


def chi2_reg_param_grid(AtWA, AtWb, btWb, N, R, tau=None):
    """chi2 = nu regularization parameter by the full exact grid scan.

    AtWA [nrec, nb, nb], AtWb [nrec, nb], btWb [nrec], N [nrec]; R [nb, nb];
    tau [nb] or None.
    Returns log10(alpha) [nrec]: -inf for too-smooth, NaN for no bracket.
    A record with no points (N = 0: an empty record, or the card's padding,
    ops/fit.prepare_stats) has chi^2 = 0 at every alpha (AtWb and btWb are
    0), so no bracket and a NaN outcome: its grid is not decomposed (one
    host read of the records with points).  Bisection runs only on the
    records that return a root (one host read of that set)."""
    nrec = AtWA.shape[0]
    dev, dt = AtWA.device, AtWA.dtype
    alphas = -torch.arange(N_GRID, dtype=dt, device=dev)
    live = torch.nonzero(N > 0).flatten()
    chi2_grid = torch.zeros((nrec, N_GRID), dtype=dt, device=dev)
    chi2_grid[live] = _chi2_at(alphas.repeat(live.shape[0]), AtWA, AtWb,
                               btWb, R, live.repeat_interleave(N_GRID),
                               tau).reshape(-1, N_GRID)
    nu, is_smooth, any_event, lo, hi = _grid_bracket(chi2_grid, N)

    # bisection only where a root is returned
    act = torch.nonzero(any_event & ~is_smooth).flatten()
    lo_a, hi_a, nu_a = lo[act], hi[act], nu[act]
    for _ in range(N_BISECT):
        mid = 0.5 * (lo_a + hi_a)
        below = _chi2_at(mid, AtWA, AtWb, btWb, R, act, tau) - nu_a < 0.0
        lo_a = torch.where(below, mid, lo_a)
        hi_a = torch.where(below, hi_a, mid)
    root = torch.full((nrec,), float("nan"), dtype=dt, device=dev)
    root[act] = 0.5 * (lo_a + hi_a)
    return _outcome(root, is_smooth, any_event)


def pencil(R, eigA):
    """The whitened pencil (lam, Q, Binv) of (AtWA, R) (solve.whiten_pencil)
    from AtWA's normalized eigendecomposition eigA = (w, V, s).  It depends
    on the statistics only: ops/fit.prepare_stats computes it a chunk
    ahead for the 'fast' searches and in chi2_search_start."""
    w, V, s = eigA
    return whiten_pencil(R, (w * s[:, None], V))


def _whiten(pen, AtWb, tau):
    """(lam, u, utau) of the whitened pencil pen = (lam, Q, Binv): u =
    Q'B^-1 AtWb, utau = Q'B^-1 tau (None without a tau)."""
    lam, Q, Binv = pen
    Qt = Q.transpose(-1, -2)
    u = _mv(Qt, _mv(Binv, AtWb))
    utau = None if tau is None else _mv(Qt, _mv(Binv, tau))
    return lam, u, utau


def chi2_reg_param_fast(AtWb, btWb, N, pen, tau=None):
    """'fast' chi2 search (regparam.py:586-653): one pencil whitening a
    record, then the 101-point grid and 9 rounds of 31-point k-section on
    the O(nbasis) whitened objective.  ``pen``: the record batch's
    ``pencil`` of the regularization matrix; tau [nb] or None.
    Returns LOG10(alpha) [B]; -inf for too-smooth, NaN for no bracket."""
    lam, u, utau = _whiten(pen, AtWb, tau)
    dev, dt = AtWb.device, AtWb.dtype
    alphas = -torch.arange(N_GRID, dtype=dt, device=dev)
    chi2_grid = whitened_chi2(alphas.expand(AtWb.shape[0], -1), lam, u, btWb,
                              utau)
    nu, is_smooth, any_event, lo, hi = _grid_bracket(chi2_grid, N)
    frac = torch.arange(1.0, FAST_K + 1.0, dtype=dt, device=dev) / (FAST_K + 1.0)
    for _ in range(FAST_ROUNDS):
        pts = hi[:, None] + (lo - hi)[:, None] * frac
        below = whitened_chi2(pts, lam, u, btWb, utau) - nu[:, None] < 0.0
        any_below = below.any(-1)
        i0 = below.to(torch.uint8).argmax(-1, keepdim=True)
        prev = pts.gather(-1, (i0 - 1).clamp(min=0))[:, 0]
        new_lo = torch.where(any_below, pts.gather(-1, i0)[:, 0], lo)
        new_hi = torch.where(any_below, torch.where(i0[:, 0] > 0, prev, hi),
                             pts[:, -1])
        lo, hi = new_lo, new_hi
    return _outcome(0.5 * (lo + hi), is_smooth, any_event)


# ---------------------------------------------------------------------------
# chi2, 'exact': the defect-corrected search (regparam.py:163-516)
# ---------------------------------------------------------------------------

def whitened_root_offset(lam, u, btWb, nu, d, r0=None, slope=None,
                         utau=None):
    """First crossing on [1e-100, 1] of the whitened objective plus a local
    linear model of the cutoff defect,
        chi2_fast(alpha) + d + slope clip(log alpha - r0, +-RANGE) = nu,
    by 64-point k-section, 5 rounds (regparam.py:163-206).  slope=None
    means the constant defect d.  Returns log10(alpha) [B], NaN where the
    modelled objective has no crossing."""

    def f_of(a_log):
        extra = a_log.dim() - 1
        f = (whitened_chi2(a_log, lam, u, btWb, utau) + _ex(d, extra)
             - _ex(nu, extra))
        if slope is not None:
            f = f + _ex(slope, extra) * torch.clamp(
                a_log - _ex(r0, extra), -DEFECT_MODEL_RANGE, DEFECT_MODEL_RANGE)
        return f

    lo = _full(lam, ALPHA_MIN)
    hi = _full(lam, 0.0)
    has = (f_of(hi) >= 0.0) & (f_of(lo) < 0.0)
    frac = torch.arange(1.0, INNER_K + 1.0, dtype=lam.dtype,
                        device=lam.device) / (INNER_K + 1.0)
    for _ in range(N_INNER_ROUNDS):
        pts = lo[:, None] + (hi - lo)[:, None] * frac  # ascending
        below = f_of(pts) < 0.0
        all_below = below.all(-1)
        j = (~below).to(torch.uint8).argmax(-1)  # first non-below index
        j = torch.where(all_below, INNER_K, j)
        new_lo = torch.where(
            j > 0, pts.gather(-1, (j - 1).clamp(min=0)[:, None])[:, 0], lo)
        new_hi = torch.where(
            all_below, hi, pts.gather(-1, j.clamp(max=INNER_K - 1)[:, None])[:, 0])
        lo, hi = new_lo, new_hi
    return torch.where(has, 0.5 * (lo + hi), torch.full_like(lo, float("nan")))


def ladder_outcome(chi2_floor, chi2_one, N):
    """Reference scale-factor ladder decisions (interpolate.py:180-207)
    from the exact endpoint evaluations (regparam.py:209-220).  Returns
    (nu, is_smooth, any_event), each [B]."""
    sf = torch.tensor(SCALE_FACTORS, dtype=chi2_floor.dtype,
                      device=chi2_floor.device)
    nus = N[:, None] * sf
    too_smooth = chi2_one[:, None] - nus < 0.0
    has_bracket = (chi2_floor[:, None] - nus < 0.0) & ~too_smooth
    event = too_smooth | has_bracket
    s = event.to(torch.uint8).argmax(-1, keepdim=True)
    return (nus.gather(-1, s)[:, 0], too_smooth.gather(-1, s)[:, 0],
            event.any(-1))


def _root_of(state):
    """The converged bracket's root: the last model prediction on a narrow
    bracket, its midpoint on a wide one (regparam.py:437-447)."""
    lo, hi, r_last, _, _ = state
    return torch.where(hi - lo < 0.2, _clip(r_last, lo, hi), 0.5 * (lo + hi))


def _defect_round(state, anchor, clip, nu, lam, u, utau, btWb):
    """One round of the defect-corrected iteration (round_body,
    regparam.py:364-407): an anchored exact chi^2 at the iterate (clipped
    to the anchor's trust region unless the anchor was just taken there),
    the padded monotone bracket update, the defect d = chi2_exact -
    chi2_fast and its secant slope, and the safeguarded next iterate."""
    lo, hi, r, r_prev, d_prev = state
    a0 = anchor["a_log"]
    r_eval = _clip(r, a0 - ANCHOR_TRUST, a0 + ANCHOR_TRUST) if clip else r
    c_r = anchor_chi2(anchor, r_eval, btWb)
    below = c_r - nu < 0.0
    pad = BRACKET_PAD_PER_DEC * torch.clamp(
        (r_eval - a0).abs() - PAD_FREE_RADIUS, min=0.0)
    lo = torch.where(below, torch.maximum(lo, r_eval - pad), lo)
    hi = torch.where(below, hi, torch.minimum(hi, r_eval + pad))
    d = c_r - whitened_chi2(r_eval, lam, u, btWb, utau)
    dr = r_eval - r_prev
    big = dr.abs() > 1e-6
    slope = torch.where(torch.isfinite(d_prev) & big,
                        (d - d_prev) / torch.where(big, dr, torch.ones_like(dr)),
                        torch.zeros_like(d))
    r_new = whitened_root_offset(lam, u, btWb, nu, d, r0=r_eval, slope=slope,
                                 utau=utau)
    width = hi - lo
    r_clip = _clip(r_new, lo + 0.25 * width, hi - 0.25 * width)
    r_next = torch.where(torch.isnan(r_new), 0.5 * (lo + hi), r_clip)
    return lo, hi, r_next, r_eval, d


def _anchor_at(a_log, AtWA, AtWb, R, tau):
    """One eigendecomposition of X(10^a_log), as an M-shift anchor."""
    w, V, s = normalized_eigh(AtWA + alpha_of_log(a_log)[:, None, None] * R)
    return make_anchor(a_log, w, V, s, R, AtWb, tau)


def chi2_search_start(AtWA, AtWb, btWb, N, R, eigA, eigR, tau=None):
    """The part of the exact search that depends on the statistics only,
    which ops/fit.prepare_stats runs a chunk ahead: the exact floor, the
    whitened pencil, the alpha = 1 endpoint and the ladder's rung, the
    seed and its M-shift anchor (defect round 0 re-anchors at the seed,
    REANCHOR_ROUNDS).  Arguments as chi2_reg_param's.  Returns the dict
    chi2_reg_param takes as ``start``."""
    wA, VA, sA = eigA
    chi2_floor = chi2_from_eig_x(wA, VA, None, AtWb, btWb, sA)
    lam, u, utau = _whiten(pencil(R, eigA), AtWb, tau)

    # alpha = 1 endpoint on the dominant side's basis (regparam.py:305-323)
    VR, sR = eigR
    pickR = sR >= sA
    Vboot = torch.where(pickR[:, None, None], VR, VA)
    X1 = AtWA + R
    s1 = norm_scale(X1)
    M1 = project(X1 * (1.0 / s1)[:, None, None], Vboot)
    w1 = torch.diagonal(M1, dim1=-2, dim2=-1)
    # alpha = 1 is m = 1, k = 0 exactly: aR = R, atau = tau
    chi2_one = chi2_from_eig_x(w1, Vboot, M1, AtWb, btWb, s1, aR=R, atau=tau,
                               AtWA=AtWA)
    nu, is_smooth, any_event = ladder_outcome(chi2_floor, chi2_one, N)

    # floor-failure rescue: where the exact floor finds no event, the rung
    # comes from the whitened floor (regparam.py:348-356)
    fast_floor = whitened_chi2(_full(btWb, ALPHA_MIN), lam, u, btWb, utau)
    nu_fb, smooth_fb, event_fb = ladder_outcome(fast_floor, chi2_one, N)
    use_fb = ~any_event & event_fb
    nu = torch.where(use_fb, nu_fb, nu)
    is_smooth = torch.where(use_fb, smooth_fb, is_smooth)
    any_event = any_event | event_fb

    # seed: the root of chi2_fast + D0 = nu, D0 the plateau defect
    d0 = torch.where(use_fb, torch.zeros_like(fast_floor),
                     chi2_floor - fast_floor)
    r = whitened_root_offset(lam, u, btWb, nu, d0, utau=utau)
    r = torch.clamp(torch.where(torch.isnan(r), torch.full_like(r, -50.0), r),
                    ALPHA_MIN + 0.1, -0.1)
    return {"lam": lam, "u": u, "utau": utau, "nu": nu,
            "is_smooth": is_smooth, "any_event": any_event, "seed": r,
            "anchor": _anchor_at(r, AtWA, AtWb, R, tau)}


def chi2_reg_param(AtWA, AtWb, btWb, N, R, eigA, eigR, want_anchor=False,
                   tau=None, start=None):
    """chi2 = nu regularization parameter, the defect-corrected exact
    search ('exact' mode; the float64 path of regparam.py:223-516).

    AtWA [B, n, n], AtWb [B, n], btWb [B], N [B]; R [n, n]; tau [n] or
    None.  eigA: (w, V, s), AtWA's normalized eigendecomposition, shared with the
    other regularization matrices and the final solve; eigR: (V, s) of R's,
    computed once a run.  start: ``chi2_search_start`` of these arguments,
    computed here when not given.

    Eigendecompositions a record: AtWA's (eigA), the whitened pencil G, the
    seed anchor (those three before the search's loop) and the root-centred
    endgame anchor.  The alpha = 1 endpoint X(1) = AtWA + R is projected on
    R's basis or AtWA's, whichever scale dominates, and solved coupled: no
    eigh.  Every defect and polish round is an anchored M-shift
    evaluation: no eigh.

    want_anchor: also return the final solve's anchor (the endgame anchor,
    or AtWA's own for too-smooth records) and the whitened chi^2 at the
    root, the negative-chi^2 report.

    Returns LOG10(alpha) [B]: -inf for too-smooth, NaN for no bracket."""
    if start is None:
        start = chi2_search_start(AtWA, AtWb, btWb, N, R, eigA, eigR, tau)
    lam, u, utau, nu = (start[k] for k in ("lam", "u", "utau", "nu"))
    r = start["seed"]
    state = (_full(r, ALPHA_MIN), _full(r, 0.0), r, _full(r, float("nan")),
             _full(r, float("nan")))
    anchor = start["anchor"]  # round 0 re-anchors at the seed
    for i in range(N_DEFECT):
        fresh = i in REANCHOR_ROUNDS
        if fresh and i > 0:
            anchor = _anchor_at(state[2], AtWA, AtWb, R, tau)
        state = _defect_round(state, anchor, not fresh, nu, lam, u, utau,
                              btWb)

    # root-centred endgame: re-anchor at the candidate, then polish rounds
    # (the first unclipped, at the fresh anchor)
    r_cand = torch.clamp(_root_of(state), ALPHA_MIN, 0.0)
    anchor = _anchor_at(r_cand, AtWA, AtWb, R, tau)
    state = (state[0], state[1], r_cand, state[3], state[4])
    for i in range(N_POLISH):
        state = _defect_round(state, anchor, i > 0, nu, lam, u, utau, btWb)
    is_smooth = start["is_smooth"]
    root = _outcome(_root_of(state), is_smooth, start["any_event"])
    if not want_anchor:
        return root
    chi2_fb = whitened_chi2(
        torch.where(torch.isfinite(root), root, torch.full_like(root, ALPHA_MIN)),
        lam, u, btWb, utau)
    fresh = make_anchor(_full(root, -float("inf")), *eigA, R, AtWb, tau)
    return root, select_anchor(is_smooth, fresh, anchor), chi2_fb


# ---------------------------------------------------------------------------
# GCV: the exact leave-one-out identity + scipy's 1-D Nelder-Mead
# ---------------------------------------------------------------------------

GCV_ALPHA0 = -20.0  # interpolate.py:288
NM_XATOL = 1e-4
NM_FATOL = 1e-4
NM_MAXITER = 200  # scipy default N * 200 for N = 1
NM_MAXFEV = 200  # scipy default N * 200 function evaluations for N = 1
_LOG10_2 = 0.30102999566398
# the most bytes of one float64 [records, candidates, n, n] or [records,
# candidates, points, n] tensor of the anchored GCV objective, which takes
# its record batch in slices that keep each within it (``gcv_slices``): at
# nbasis 1200 a 128-record batch of five candidates is 7.4 GB a tensor,
# and the objective holds several
GCV_SLICE_BYTES = 2 << 30


def nelder_mead_1d(f, x0):
    """scipy.optimize.minimize(method='Nelder-Mead') in one dimension, at
    scipy's default tolerances and budgets (NM_*), for a batch of records
    (regparam.py:965-1049): f maps candidates [B, K] to objective values
    [B, K]; x0 [B].  Every iteration evaluates its five
    candidates (reflection, expansion, outside and inside contraction,
    shrink) in one call; the evaluation budget follows the trajectory
    scipy would take (2 per iteration, 3 when it shrinks).  A record that
    has stopped keeps its state, as a batched while loop does; the loop
    runs while any record is active (one host read an iteration).
    Returns (x_best [B], converged [B])."""
    x1 = torch.where(x0 != 0.0, (1.0 + 0.05) * x0,
                     torch.full_like(x0, 0.00025))
    f01 = f(torch.stack([x0, x1], -1))
    first = f01[:, 0] <= f01[:, 1]
    xs0, xs1 = torch.where(first, x0, x1), torch.where(first, x1, x0)
    fs0 = torch.where(first, f01[:, 0], f01[:, 1])
    fs1 = torch.where(first, f01[:, 1], f01[:, 0])
    it = torch.zeros_like(x0, dtype=torch.int64)
    fev = torch.full_like(it, 2)

    def converged():
        return (((xs1 - xs0).abs() <= NM_XATOL)
                & ((fs1 - fs0).abs() <= NM_FATOL))

    active = ~converged() & (it < NM_MAXITER) & (fev < NM_MAXFEV)
    while bool(active.any()):
        xbar, xw, f0, f1 = xs0, xs1, fs0, fs1
        xr = 2.0 * xbar - xw
        xe = 3.0 * xbar - 2.0 * xw
        xc_out = 1.5 * xbar - 0.5 * xw
        xc_in = 0.5 * xbar + 0.5 * xw
        x_shr = xbar + 0.5 * (xw - xbar)
        fr, fe, fc_out, fc_in, f_shr = f(
            torch.stack([xr, xe, xc_out, xc_in, x_shr], -1)).unbind(-1)
        new_x_exp = torch.where(fe < fr, xe, xr)
        new_f_exp = torch.where(fe < fr, fe, fr)
        use_out = fr < f1
        xc = torch.where(use_out, xc_out, xc_in)
        fc = torch.where(use_out, fc_out, fc_in)
        accept_c = torch.where(use_out, fc_out <= fr, fc_in < f1)
        expand = fr < f0
        new_x = torch.where(expand, new_x_exp, torch.where(accept_c, xc, x_shr))
        new_f = torch.where(expand, new_f_exp, torch.where(accept_c, fc, f_shr))
        better = new_f < f0
        upd = lambda new, old: torch.where(active, new, old)  # noqa: E731
        xs0 = upd(torch.where(better, new_x, xbar), xs0)
        xs1 = upd(torch.where(better, xbar, new_x), xs1)
        fs0 = upd(torch.where(better, new_f, f0), fs0)
        fs1 = upd(torch.where(better, f0, new_f), fs1)
        fev = upd(fev + torch.where(expand | accept_c, 2, 3), fev)
        it = upd(it + 1, it)
        active = ~converged() & (it < NM_MAXITER) & (fev < NM_MAXFEV)
    return xs0, converged()


def gcv_basis_bundle(V, AtWA, R, AtWb, A):
    """Per-basis precomputation of the anchored GCV objective
    (regparam.py:675-686): the projections of both pencil sides, the
    projected rhs and the design rows in the basis, T = A V.  V is one
    record's basis [B, n, n] or a shared one [n, n].  Every field has the
    record axis first: B for a per-record term, 1 for a shared one, which
    broadcasts (``gcv_bundle_records``)."""
    bundle = {"PA": project(AtWA, V), "PR": project(R, V),
              "u": _mv(V.transpose(-1, -2), AtWb), "T": A @ V}
    return {k: v if k == "u" or v.dim() == 3 else v[None]
            for k, v in bundle.items()}


def gcv_bundle_records(bundle, sl):
    """The records ``sl`` of a gcv_basis_bundle: its per-record fields
    sliced, its shared ones (record axis 1) as they are."""
    return {k: v if v.shape[0] == 1 else v[sl] for k, v in bundle.items()}


def _loo_sum(yhat, h, b, W, mask):
    """sum of W-weighted squared leave-one-out residuals
    (yhat - b) / (1 - h) over the valid points; yhat, h [B, K, P]."""
    b, W, mask = b[:, None], W[:, None], mask[:, None]
    r = (yhat - b) / (1.0 - h)
    r = torch.where(mask, r, torch.zeros_like(r))
    return (r * r * W).sum(-1)


def _summed(obj, point_sum):
    """The objective summed over point shards (point_sum), or as it is."""
    return obj if point_sum is None else point_sum(obj)


def gcv_slices(nrec, ncand, n, npts):
    """The record slices gcv_objective_anchored takes a batch of nrec
    records and ncand candidates in: as few as keep each of its float64
    [b, ncand, n, n] and [b, ncand, npts, n] tensors within GCV_SLICE_BYTES
    (one record at least), of equal size but the last."""
    return even_slices(nrec,
                       GCV_SLICE_BYTES // (ncand * max(n, npts) * n * 8))


def gcv_objective_anchored(a_log, bundle, b, W, mask):
    """GCV objective at 10^a_log [B, K] from a basis bundle (the float64
    path of gcv_objective_anchored, regparam.py:689-767, keep_resolve
    off): M = PA + alpha PR, trace-normalized; keep from its deflated
    diagonal; one ridged inverse of the unit-diagonal kept block gives both
    yhat_i = t_i'M^-1 u / s and h_i = W_i t_i'M^-1 t_i / s.
    b, W [B, P] (masked), mask [B, P] bool.  Returns [B, K].

    The records go in ``gcv_slices``, each float64 [b, K, n, n] and
    [b, K, P, n] tensor at most GCV_SLICE_BYTES: records are independent
    in every step, so the slicing changes the schedule, not the
    arithmetic (at the production order a batch is one slice)."""
    parts = gcv_slices(a_log.shape[0], a_log.shape[1], bundle["u"].shape[-1],
                       b.shape[-1])
    out = [_gcv_objective_slice(a_log[sl], gcv_bundle_records(bundle, sl),
                                b[sl], W[sl], mask[sl])
           for sl in parts]
    return out[0] if len(out) == 1 else torch.cat(out)


def _gcv_objective_slice(a_log, bundle, b, W, mask):
    """gcv_objective_anchored of one record slice."""
    al = alpha_of_log(a_log)
    # the candidate axis after the record axis (1 for a shared term, as R
    # projected on R's basis, which broadcasts)
    PA, PR, T = (bundle[k][:, None] for k in ("PA", "PR", "T"))
    M = PA + PR * al[..., None, None]
    s = norm_scale(M)
    Mn = M * (1.0 / s)[..., None, None]
    w = deflated_diag(Mn)
    keep = _keep_mask(w)
    sd = torch.sqrt(torch.clamp(
        torch.where(keep, w, torch.ones_like(w)).abs(), min=TINY64))
    km = keep[..., None, :] & keep[..., :, None]
    n = w.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    Msc = torch.where(km, Mn / (sd[..., None, :] * sd[..., :, None]), eye)
    Minv = batched_inv(Msc + 1e-4 * eye)
    Minv = torch.where(km, Minv, torch.zeros_like(Minv))
    Tk = torch.where(keep[..., None, :], T / sd[..., None, :],
                     torch.zeros_like(T))
    uk = torch.where(keep, bundle["u"][:, None] / sd, torch.zeros_like(sd))
    yhat = _mv(Tk, _mv(Minv, uk))
    h = ((Tk @ Minv) * Tk).sum(-1)
    s = s[..., None]
    return _loo_sum(yhat / s, W[:, None] * h / s, b, W, mask)


def gcv_reg_param_x(AtWA, AtWb, R, A, b, W, mask, eigA, eigR,
                    point_sum=None):
    """GCV regularization parameter, 'exact' mode (the float64 path of
    gcv_reg_param_x, regparam.py:770-875): Nelder-Mead from log10 alpha =
    -20 over the anchored objective, each evaluation on AtWA's basis
    (data-dominant alphas) or R's (alpha sR >= sA), plain scipy tolerances.
    eigA: (w, V, s) of AtWA; eigR: (V, s) of R.  point_sum: None, or the
    sum over point shards of an objective computed on this process's
    points (A, b, W, mask hold one shard; parallel/fit.py).  Returns
    LOG10(alpha) [B], NaN where Nelder-Mead does not converge
    (interpolate.py:292-293)."""
    _, VA, sA = eigA
    VR, sR = eigR
    bun_A = gcv_basis_bundle(VA, AtWA, R, AtWb, A)
    bun_R = gcv_basis_bundle(VR, AtWA, R, AtWb, A)
    thresh = ((torch.log2(sA) - torch.log2(sR)) * _LOG10_2)[:, None]

    def obj(x):
        oA = gcv_objective_anchored(x, bun_A, b, W, mask)
        oR = gcv_objective_anchored(x, bun_R, b, W, mask)
        return _summed(torch.where(x >= thresh, oR, oA), point_sum)

    x, ok = nelder_mead_1d(obj, _full(AtWb, GCV_ALPHA0))
    return torch.where(ok, x, torch.full_like(x, float("nan")))


def gcv_reg_param_fast(AtWb, A, b, W, mask, pen, point_sum=None):
    """GCV regularization parameter, 'fast' mode (gcv_reg_param with
    gcv_objective_fast, regparam.py:941-962, 1052-1070): the whitened
    objective, O(npoints nbasis) an evaluation, at the exact float64
    10**a_log.  ``pen``: the record batch's ``pencil`` of the
    regularization matrix; point_sum as in gcv_reg_param_x.  Returns
    LOG10(alpha) [B], NaN where Nelder-Mead does not converge."""
    lam, Q, Binv = pen
    u = _mv(Q.transpose(-1, -2), _mv(Binv, AtWb))
    T = A @ (Binv.transpose(-1, -2) @ Q)  # [B, P, n]
    T2 = T * T

    def obj(x):
        return _summed(gcv_objective_fast(x, lam, u, T, T2, b, W, mask),
                       point_sum)

    x, ok = nelder_mead_1d(obj, _full(AtWb, GCV_ALPHA0))
    return torch.where(ok, x, torch.full_like(x, float("nan")))


def gcv_objective_fast(a_log, lam, u, T, T2, b, W, mask):
    """Whitened O(npoints nbasis)-an-alpha GCV objective at 10^a_log
    [B, K] (regparam.py:941-962): with the pencil whitened
    (solve.whiten_pencil) and T = A Binv' Q [B, P, n] the design rows in
    the whitened eigenbasis, T2 = T * T, d = 1 / (1 + alpha lam) gives
    yhat = T (d u) and h = W T2 d.  lam, u [B, n]; b, W [B, P] (masked),
    mask [B, P] bool.  Returns [B, K]."""
    d = 1.0 / (1.0 + torch.pow(10.0, a_log)[..., None] * lam[:, None])
    yhat = (d * u[:, None]) @ T.transpose(-1, -2)
    h = W[:, None] * (d @ T2.transpose(-1, -2))
    return _loo_sum(yhat, h, b, W, mask)


def gcv_objective(a_log, AtWA, AtWb, R, A, b, W, mask):
    """Sum of W-weighted squared leave-one-out residuals of one record at
    reg param 10^a_log (regparam.py:907-938), by the exact rank-one
    downdate  r_i = (yhat_i - b_i) / (1 - h_ii),  h_ii = W_i a_i' pinv(X)
    a_i,  X = AtWA + alpha R,  with sym_pinv_apply's cutoffs (gelsd's for
    C, eps * max for pinv(X)).  AtWA [n, n], AtWb [n], R [n, n]; A [P, n];
    b, W, mask [P] (mask bool or 0/1; masked points count nothing).
    a_log: a number or a tensor of any shape; returns its shape."""
    a = torch.pow(10.0, torch.as_tensor(a_log, dtype=AtWA.dtype,
                                        device=AtWA.device))
    C, H = sym_pinv_apply(AtWA + a[..., None, None] * R, AtWb,
                          rcond_factor_H=EPS64)
    yhat = C @ A.T  # [..., P]
    h = W * ((A @ H) * A).sum(-1)
    keep = mask > 0
    r = torch.where(keep, (yhat - b) / (1.0 - h), torch.zeros_like(yhat))
    return (r * r * torch.where(keep, W, torch.zeros_like(W))).sum(-1)


def gcv_reg_param(AtWA, AtWb, R, A, b, W, mask, regparam_mode="exact"):
    """GCV regularization parameter of one record and one matrix
    (regparam.py:1052-1073): scipy's Nelder-Mead from log10 alpha = -20
    over gcv_objective ('exact') or the whitened objective ('fast',
    gcv_reg_param_fast on a batch of one).  Arguments as gcv_objective's;
    W is zero at masked points.  Returns LOG10(alpha), a 0-d tensor; NaN
    where Nelder-Mead does not converge (interpolate.py:292-293)."""
    if regparam_mode == "fast":
        pen = pencil(R, normalized_eigh(AtWA[None]))
        return gcv_reg_param_fast(AtWb[None], A, b[None], W[None],
                                  mask[None] > 0, pen)[0]

    def obj(x):  # x [1, K]: the K candidates of an iteration at once
        return gcv_objective(x, AtWA, AtWb, R, A, b, W, mask)

    x, ok = nelder_mead_1d(obj, _full(AtWb[:1], GCV_ALPHA0))
    return torch.where(ok, x, torch.full_like(x, float("nan")))[0]


MANUAL_PARAMS = {"curvature": 1.0e-28, "0thorder": 1.0e-23}


def manual_reg_param(reg_name: str) -> float:
    if reg_name not in MANUAL_PARAMS:
        raise ValueError(
            f"manual regularization has no hardcoded value for {reg_name!r} "
            "(reference interpolate.py:376-379 covers only 'curvature' and "
            "'0thorder')"
        )
    return MANUAL_PARAMS[reg_name]
