"""Batched regularized weighted least squares in float64 torch.

The float64 semantics of ``volumetricinterp_tpu/ops/solve.py`` (its
``_is_x64`` branches, which are the plain f64 algorithm), batched over a
leading record axis:

* NaN points enter by WEIGHT-ZERO MASKING, so every record keeps the same
  shape; the data enters only through sufficient statistics (AtWA, AtWb,
  btWb, N).
* Solves reproduce the reference's scipy SOLVER PAIR through one symmetric
  eigendecomposition of the trace-normalized normal matrix: C with the
  gelsd cutoff |w| > eps * max|w|, the covariance with scipy.linalg.pinv's
  N * eps * max|w| (docs/PARITY_NOTES.md #8).
* chi^2 uses the cancellation-free identity chi2 = btWb - u'z/s - C'(aR)C
  (u = V'AtWb, z the kept-mode solve, s the normalization scale).

Regularization parameters travel as LOG10(alpha): raw alphas reach 1e-100;
-inf encodes alpha = 0 (the too-smooth outcome) and NaN a failed search.
"""

from __future__ import annotations

import torch

EPS64 = 2.220446049250313e-16  # the reference's f64 cutoff unit
_LOG2_10 = 3.321928094887362


def alpha_of_log(a_log):
    """10**a_log as the JAX package forms it (solve.pow10_split): the
    mantissa 2^(t - floor t), t = a log2(10), rounded to float32, times the
    exact power of two.  -inf gives 0, NaN stays NaN."""
    a = torch.clamp(a_log, min=-4000.0)
    t = a * _LOG2_10
    k = torch.floor(t)
    m = torch.exp2(t - k).to(torch.float32).to(a_log.dtype)
    return m * torch.exp2(k)


def suff_stats(A, values, errors):
    """Masked sufficient statistics of a record batch.

    A: [npoints, nbasis]; values, errors: [nrec, npoints] (NaN value = no
    data).  Returns (AtWA [nrec, nb, nb], AtWb [nrec, nb], btWb [nrec],
    N [nrec])."""
    mask = torch.isfinite(values)
    W = torch.where(mask, errors, torch.ones_like(errors)) ** -2.0
    W = torch.where(mask, W, torch.zeros_like(W))
    b = torch.where(mask, values, torch.zeros_like(values))
    Wb = W * b
    AtWA = A.T @ (A[None] * W[:, :, None])
    AtWb = Wb @ A
    btWb = (Wb * b).sum(-1)
    return AtWA, AtWb, btWb, mask.sum(-1).to(A.dtype)


def normalized_eigh(X):
    """(w, V, s): eigenpairs of X / s, s = |trace X| / n (1 where zero)."""
    n = X.shape[-1]
    t = torch.diagonal(X, dim1=-2, dim2=-1).sum(-1) / n
    s = torch.where(t.abs() > 0, t.abs(), torch.ones_like(t))
    w, V = torch.linalg.eigh(X / s[..., None, None])
    return w, V, s


def _kept_solve(w, u, rcond):
    """z = u / w on the kept modes |w| > rcond * max|w|, 0 elsewhere."""
    aw = w.abs()
    keep = aw > rcond * aw.amax(-1, keepdim=True)
    return torch.where(keep, u / torch.where(keep, w, torch.ones_like(w)),
                       torch.zeros_like(w))


def cutoff_chi2_x(AtWA, AtWb, btWb, aR):
    """chi^2 of the fit with X = AtWA + aR under reference gelsd-cutoff
    semantics (interpolate.py:220-261), batched: aR [B, nb, nb] is alpha R
    already formed.  The float64 branch of the JAX package's
    cutoff_chi2_x / chi2_from_eig_x (the cancellation-free identity)."""
    w, V, s = normalized_eigh(AtWA + aR)
    u = (V.transpose(-1, -2) @ AtWb[..., None])[..., 0]
    z = _kept_solve(w, u, EPS64)
    chi2 = btWb - (u * z).sum(-1) * (1.0 / s)
    C = (V @ z[..., None])[..., 0] / s[..., None]
    return chi2 - (C * (aR @ C[..., None])[..., 0]).sum(-1)


def sym_pinv_apply(X, y, rcond_factor=None, want_H=True, rcond_factor_H=None):
    """Min-norm solve C = pinv(X) @ y for symmetric X, plus pinv(X), with
    the reference's dual cutoffs (gelsd eps*max for C, pinv N*eps*max for
    H); batched over leading axes."""
    n = X.shape[-1]
    if rcond_factor is None:
        rcond_factor = EPS64
    if rcond_factor_H is None:
        rcond_factor_H = float(n) * EPS64
    w, V, s = normalized_eigh(X)
    w = w * s[..., None]
    Vty = (V.transpose(-1, -2) @ y[..., None])[..., 0]
    C = (V @ _kept_solve(w, Vty, rcond_factor)[..., None])[..., 0]
    if not want_H:
        return C, None
    inv_w_H = _kept_solve(w, torch.ones_like(w), rcond_factor_H)
    H = (V * inv_w_H[..., None, :]) @ V.transpose(-1, -2)
    return C, H


def chi2_from_eig(w, V, AtWA, AtWb, btWb):
    """Reference-cutoff chi^2 from eigenpairs (w, V) of X = AtWA + a R, in
    the direct form C'AtWA C - 2 C'AtWb + btWb."""
    u = (V.transpose(-1, -2) @ AtWb[..., None])[..., 0]
    C = (V @ _kept_solve(w, u, EPS64)[..., None])[..., 0]
    AC = (AtWA @ C[..., None])[..., 0]
    return (C * AC).sum(-1) - 2.0 * (C * AtWb).sum(-1) + btWb


def cutoff_chi2(a, AtWA, AtWb, btWb, R):
    """chi^2 of the fit with X = AtWA + a R under reference solve semantics
    (interpolate.py:220-261); a is the raw alpha."""
    C, _ = sym_pinv_apply(AtWA + a * R, AtWb, want_H=False)
    AC = (AtWA @ C[..., None])[..., 0]
    return (C * AC).sum(-1) - 2.0 * (C * AtWb).sum(-1) + btWb


def final_solve(AtWA, AtWb, btWb, reg_mats, log_alphas):
    """Coefficients, covariance and chi^2 of a record batch's regularized
    fit (interpolate.py:432-469 with calccov=True, and the chi^2 of
    interpolate.py:569): the float64 branch of final_solve_x.

    reg_mats: [nreg, nb, nb]; log_alphas: [nrec, nreg] LOG10 alphas (-inf
    is alpha = 0).  Records with a NaN alpha are solved at alpha = 0 here;
    the caller NaN-fills them.  Returns (C [nrec, nb], dC [nrec, nb, nb],
    chi2 [nrec])."""
    n = AtWA.shape[-1]
    aR = torch.zeros_like(AtWA)
    for i in range(reg_mats.shape[0]):
        a = alpha_of_log(log_alphas[:, i])
        a = torch.where(torch.isnan(a), torch.zeros_like(a), a)
        aR = aR + a[:, None, None] * reg_mats[i]
    w, V, s = normalized_eigh(AtWA + aR)
    Vt = V.transpose(-1, -2)
    u = (Vt @ AtWb[..., None])[..., 0]
    z = _kept_solve(w, u, EPS64)
    C = (V @ z[..., None])[..., 0] / s[..., None]
    # dC = H AtWA H, H = V diag(1/w)|keep_H V' / s, the pinv cutoff
    inv_w_H = _kept_solve(w, torch.ones_like(w), float(n) * EPS64)
    G = Vt @ AtWA @ V
    Hmid = inv_w_H[..., :, None] * G * inv_w_H[..., None, :]
    dC = V @ Hmid @ Vt / (s * s)[..., None, None]
    chi2 = btWb - (u * z).sum(-1) * (1.0 / s)
    chi2 = chi2 - (C * (aR @ C[..., None])[..., 0]).sum(-1)
    return C, dC, chi2
