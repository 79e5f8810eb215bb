"""The plain reference fit of one record, in NumPy and SciPy.

A frozen copy of the reference's semantics (the independent oracle the
port's tests hold it to): X = AtWA + alpha R, the coefficients by the
minimum-norm least-squares solve of scipy.linalg.lstsq (singular values
below eps times the largest count as zero; X is symmetric, so they are
|eigenvalues| and the solve goes through one LAPACK eigh, torch's on the
host), and the chi2 search:
for each scale factor 0.6 ... 1.0 of the valid points' count nu, a downward
scan of log10 alpha in steps of 1 from 0 to a sign change of chi2 - nu,
then scipy's brentq between the last two steps.

``dtype`` float64 is the reference; float32, the same arithmetic and the
same cutoff one precision lower (what a fit moved to float32 with its
float64 cutoff kept would compute), is the benchmark's control.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize
import torch

SCALE_FACTORS = (0.6, 0.7, 0.8, 0.9, 1.0)
LOWEST_LOG_ALPHA = -100.0


RCOND = np.finfo(np.float64).eps  # scipy's default cutoff of a float64 solve


def lstsq_sym(X, y):
    """scipy.linalg.lstsq(X, y)'s solution for symmetric float64 X, in X's
    precision: singular values under RCOND times the largest count as
    zero."""
    w, V = (t.numpy() for t in torch.linalg.eigh(torch.from_numpy(X)))
    keep = np.abs(w) > RCOND * np.abs(w).max()
    return V[:, keep] @ ((V[:, keep].T @ y) / w[keep])


def fit_record(value, error, A, R, dtype=np.float64):
    """(C [nbasis], chi2, alpha) of one record (value, error [points]; A
    [points, nbasis]; R [nbasis, nbasis]), NaN where the search finds no
    root.  Points with a NaN value count nothing."""
    ok = np.isfinite(value)
    A0 = A[ok].astype(dtype)
    b = value[ok].astype(dtype)
    W = (error[ok] ** -2.0).astype(dtype)
    R = R.astype(dtype)
    AtWA = A0.T @ (W[:, None] * A0)
    AtWb = A0.T @ (W * b)

    def solve(alpha):
        C = lstsq_sym(AtWA + dtype(alpha) * R, AtWb)
        r = A0 @ C - b
        return C, float(np.sum(r * r * W))

    seen = {}  # chi2 at each log10 alpha: every scale factor scans the same

    def chi2_of(a_log):
        if a_log not in seen:
            seen[a_log] = solve(10.0 ** a_log)[1]
        return seen[a_log]

    alpha = _chi2_root(chi2_of, len(b))
    if not np.isfinite(alpha):
        return np.full(A.shape[1], np.nan), np.nan, np.nan
    C, chi2 = solve(alpha)
    return C.astype(np.float64), chi2, alpha


def _chi2_root(chi2_of, npoints):
    """alpha of the reference's search (0.0 when chi2 at alpha = 1 is
    already under the target; NaN when no scale factor brackets a root)."""
    for sf in SCALE_FACTORS:
        nu = npoints * sf

        def f(a_log):
            return chi2_of(a_log) - nu

        alpha0, val0, alpha = 0.0, 1.0, 0.0
        val = f(alpha)
        if val < 0:
            return 0.0
        bracket = False
        while val0 * val > 0:
            bracket = True
            val0, alpha0 = val, alpha
            alpha -= 1.0
            val = f(alpha)
            if alpha < LOWEST_LOG_ALPHA:
                bracket = False
                break
        if bracket:
            return 10.0 ** scipy.optimize.brentq(f, alpha, alpha0, disp=True)
    return np.nan


def fixed_alpha_fit(value, error, A, R, alpha):
    """Coefficients [records, nbasis] of every record at one alpha, float64
    (the product cell's input coefficients)."""
    ok = np.isfinite(value)
    W = np.where(ok, error, 1.0) ** -2.0 * ok
    b = np.where(ok, value, 0.0)
    X = (A.T * W[:, None, :]) @ A + alpha * R
    y = (W * b) @ A
    w, V = (t.numpy() for t in torch.linalg.eigh(torch.from_numpy(X)))
    keep = np.abs(w) > RCOND * np.abs(w).max(-1, keepdims=True)
    z = np.einsum("rji,rj->ri", V, y) / w * keep
    return np.einsum("rij,rj->ri", V, z)
