"""Regularization-parameter selection, batched over records.

* chi2, mode 'exact_grid' (``chi2_reg_param_grid``): the reference's
  scale-factor ladder (0.6..1.0 of N) and downward bracket scan over
  log10 alpha = 0, -1, ..., -100 (interpolate.py:152-218), every chi^2
  evaluation a fresh cutoff eigendecomposition, then 40 bisection rounds in
  log10 alpha in place of Brent (the same root of the monotone objective to
  ~1e-10 decades).  The float64 semantics of
  ``volumetricinterp_tpu/ops/regparam.py::chi2_reg_param_grid``.
* manual: the reference's hardcoded constants (interpolate.py:353-381).

Searches return LOG10(alpha): -inf encodes the too-smooth alpha = 0 early
exit (interpolate.py:189-191) and NaN the no-bracket failure
(interpolate.py:142-147, 557-563).
"""

from __future__ import annotations

import torch

from .solve import alpha_of_log, cutoff_chi2_x

# reference constants (interpolate.py:173, 199-202)
SCALE_FACTORS = (0.6, 0.7, 0.8, 0.9, 1.0)
ALPHA_MIN = -100.0
N_BISECT = 40
# matrices per batched eigendecomposition: bounds the [batch, nb, nb]
# working set (~0.4 GB of X, V and temporaries at nb = 144)
EIGH_BATCH = 1024


def _chi2_at(log_alpha, AtWA, AtWb, btWb, R, rec):
    """chi^2(10**log_alpha[i]) of record rec[i] with X = AtWA + alpha R,
    in batches of EIGH_BATCH matrices."""
    out = torch.empty_like(log_alpha)
    for s in range(0, log_alpha.shape[0], EIGH_BATCH):
        sl = slice(s, s + EIGH_BATCH)
        r = rec[sl]
        a = alpha_of_log(log_alpha[sl])
        out[sl] = cutoff_chi2_x(AtWA[r], AtWb[r], btWb[r], a[:, None, None] * R)
    return out


def chi2_reg_param_grid(AtWA, AtWb, btWb, N, R):
    """chi2 = nu regularization parameter by the full exact grid scan.

    AtWA [nrec, nb, nb], AtWb [nrec, nb], btWb [nrec], N [nrec]; R [nb, nb].
    Returns log10(alpha) [nrec]: -inf for too-smooth, NaN for no bracket."""
    nrec = AtWA.shape[0]
    dev, dt = AtWA.device, AtWA.dtype
    n_grid = int(-ALPHA_MIN) + 1  # 101
    alphas = -torch.arange(n_grid, dtype=dt, device=dev)
    rec = torch.arange(nrec, device=dev)
    chi2_grid = _chi2_at(alphas.repeat(nrec), AtWA, AtWb, btWb, R,
                         rec.repeat_interleave(n_grid)).reshape(nrec, n_grid)

    sf = torch.tensor(SCALE_FACTORS, dtype=dt, device=dev)
    nus = N[:, None] * sf  # [nrec, 5]
    f_grid = chi2_grid[:, None, :] - nus[:, :, None]  # [nrec, 5, 101]
    too_smooth = f_grid[:, :, 0] < 0.0  # per sf: chi2(alpha=1) - nu < 0
    neg = f_grid < 0.0
    has_bracket = neg[:, :, 1:].any(-1) & ~too_smooth
    event = too_smooth | has_bracket
    # first scale factor with an event (argmax returns the first maximum)
    s = event.to(torch.uint8).argmax(-1)
    any_event = event.any(-1)
    is_smooth = too_smooth[rec, s]
    nu = nus[rec, s]
    j = neg[rec, s].to(torch.uint8).argmax(-1)
    lo = alphas[j]                  # f(lo) < 0
    hi = alphas[(j - 1) % n_grid]   # f(hi) >= 0

    # bisection only where a root is returned
    act = torch.nonzero(any_event & ~is_smooth).flatten()
    lo_a, hi_a, nu_a = lo[act], hi[act], nu[act]
    for _ in range(N_BISECT):
        mid = 0.5 * (lo_a + hi_a)
        below = _chi2_at(mid, AtWA, AtWb, btWb, R, act) - nu_a < 0.0
        lo_a = torch.where(below, mid, lo_a)
        hi_a = torch.where(below, hi_a, mid)
    root = torch.full((nrec,), float("nan"), dtype=dt, device=dev)
    root[act] = 0.5 * (lo_a + hi_a)
    root = torch.where(any_event & is_smooth,
                       torch.full_like(root, -float("inf")), root)
    return root


MANUAL_PARAMS = {"curvature": 1.0e-28, "0thorder": 1.0e-23}


def manual_reg_param(reg_name: str) -> float:
    if reg_name not in MANUAL_PARAMS:
        raise ValueError(
            f"manual regularization has no hardcoded value for {reg_name!r} "
            "(reference interpolate.py:376-379 covers only 'curvature' and "
            "'0thorder')"
        )
    return MANUAL_PARAMS[reg_name]
