"""Batched fit: records in, (C, dC, chi2, alphas) out, in float64 torch.

    per record batch:  QC mask -> sufficient statistics -> chi2 = nu
                       regularization search (or manual alphas) ->
                       cutoff solve -> covariance, chi^2

Records whose parameter search fails are NaN-filled (interpolate.py:
557-563).  The design matrix A is shared across records (the beam geometry
is file-level in AMISR data) and is built once on the host by the model.
"""

from __future__ import annotations

import numpy as np
import torch

from . import regparam
from .solve import final_solve, suff_stats


def fit_records(values, errors, A, reg_mats, method: str = "chi2",
                manual_params=None, regparam_mode: str = "exact_grid",
                device="cuda"):
    """Batched fit of a record block.

    values/errors: [nrec, npoints] (NaN value = no data); A: [npoints,
    nbasis]; reg_mats: [nreg, nbasis, nbasis]; manual_params: raw alphas
    [nreg] (reference convention) for method 'manual'.  Arrays or tensors;
    everything is moved to ``device`` in float64.

    Returns tensors on ``device``: C [nrec, nb], dC [nrec, nb, nb],
    chi2 [nrec], reg_params [nrec, nreg] in the reference's RAW alpha
    units (0 for too-smooth, NaN for a failed search)."""
    if method == "chi2" and regparam_mode != "exact_grid":
        raise NotImplementedError(
            f"REGPARAM_MODE = {regparam_mode!r} is not ported to the PyTorch "
            "package yet; use exact_grid (ROADMAP queue 1: exact and fast "
            "chi2 modes)")
    if method not in ("chi2", "manual"):
        raise NotImplementedError(
            f"regularization method {method!r} is not ported to the PyTorch "
            "package yet (ROADMAP queue 1: GCV)")
    device = torch.device(device)
    values, errors, A, reg_mats = (
        torch.as_tensor(x, dtype=torch.float64, device=device)
        for x in (values, errors, A, reg_mats))
    nrec, nreg = values.shape[0], reg_mats.shape[0]

    AtWA, AtWb, btWb, N = suff_stats(A, values, errors)
    if nreg == 0:
        log_alphas = torch.zeros((nrec, 0), dtype=torch.float64, device=device)
    elif method == "manual":
        with np.errstate(divide="ignore"):
            la = np.log10(np.asarray(manual_params, np.float64))
        log_alphas = torch.as_tensor(la, device=device).expand(nrec, nreg)
    else:
        # reference semantics: each parameter solved with all others at
        # zero (interpolate.py:120-124, 246-252)
        log_alphas = torch.stack(
            [regparam.chi2_reg_param_grid(AtWA, AtWb, btWb, N, reg_mats[i])
             for i in range(nreg)], dim=-1)

    C, dC, chi2 = final_solve(AtWA, AtWb, btWb, reg_mats, log_alphas)

    # NaN-fill failed records (interpolate.py:557-563)
    bad = torch.isnan(log_alphas).any(-1)
    C = torch.where(bad[:, None], float("nan"), C)
    dC = torch.where(bad[:, None, None], float("nan"), dC)
    chi2 = torch.where(bad, float("nan"), chi2)
    return C, dC, chi2, log_alphas_to_raw(log_alphas)


def log_alphas_to_raw(log_alphas):
    """log10 alphas -> the reference's RAW alphas (-inf -> 0, NaN -> NaN)."""
    return torch.pow(10.0, log_alphas)
