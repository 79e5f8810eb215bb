"""Batched fit: records in, (C, dC, chi2, alphas) out, in float64 torch.

    per record batch:  QC mask -> sufficient statistics ->
                       regularization search (chi2 = nu or GCV, or manual
                       alphas) -> cutoff solve -> covariance, chi^2

The dispatch of the JAX package's fit_from_stats_x / fit_one_record_x
(volumetricinterp_tpu/ops/fit.py:50-233), on a record batch:

* chi2 'exact' (the default): AtWA's eigendecomposition is shared by every
  regularization matrix's search; with one matrix the search's last anchor
  feeds the final solve (solve.final_solve_anchor) and a negative chi^2 is
  reported as the whitened chi^2 at the root; with several, each search
  runs alone (the others at zero, interpolate.py:120-124) and one cutoff
  solve follows.
* chi2 'exact_grid' and 'fast', gcv (both modes), manual: a search per
  matrix, then the cutoff solve.

Every eigendecomposition of a fit runs by the host LAPACK route
(solve.host_eigh).  Those that depend on a chunk's statistics alone,
AtWA's, the 'fast' searches' whitened pencils and the 'exact' search's
start with its seed anchor, are taken by ``prepare_chunk`` /
``prepare_stats``, which Interpolate runs a chunk ahead; the exact
search's endgame anchor and the final solve follow its rounds.

reg_taus (optional, one tau vector a matrix): data-informed regularization
toward a target profile, in every chi2 mode's search and final solve and in
manual fits; GCV searches and solves without it, as the JAX package does
(volumetricinterp_tpu/ops/fit.py:168-229).

Records whose parameter search fails are NaN-filled (interpolate.py:
557-563).  The design matrix A is shared across records (the beam geometry
is file-level in AMISR data) and is built once on the host by the model.
"""

from __future__ import annotations

import numpy as np
import torch

from . import regparam
from .solve import (CARD_BATCH, final_solve, final_solve_anchor,
                    masked_points, normalized_eigh, suff_stats)
from ..utils.device import check_device

METHODS = ("chi2", "gcv", "manual")
REGPARAM_MODES = ("exact", "exact_grid", "fast")
# records whose negative chi^2 was reported as the whitened chi^2, since
# import (chip_smoke.py reads it); one host read a record batch, after the
# search
negative_chi2_reports = 0


def record_stats(values, errors, A, device="cuda"):
    """Masked sufficient statistics (AtWA, AtWb, btWb, N) of one record
    (NaN value = zero weight), float64 on ``device``
    (ops/fit.py:41-47)."""
    device = check_device(device)
    values, errors, A = (torch.as_tensor(x, dtype=torch.float64,
                                         device=device)
                         for x in (values, errors, A))
    return tuple(q[0] for q in suff_stats(A, values[None], errors[None]))


def reg_mats_eig(reg_mats):
    """(V [nreg, nb, nb], s [nreg]): the normalized eigenbases of the
    regularization matrices, which the 'exact' chi2 search and the 'exact'
    GCV search take from R.  They depend on the model only, so a run
    computes them once (ops/fit.py:382-413)."""
    _, V, s = normalized_eigh(reg_mats)
    return V, s


def atwa_eig(AtWA):
    """AtWA's normalized eigendecomposition (w, V, s), by the fit's host
    route (solve.host_eigh): the exact searches' floor and basis, the fast
    searches' whitening, and, for a fit without regularization matrices
    (radbasfun), the cutoff solve itself."""
    return normalized_eigh(AtWA)


def takes_atwa_eig(method, regparam_mode, nreg):
    """Whether fit_records takes ``atwa_eig``: every search but the manual
    alphas and exact_grid's chi2 grid, and the final solve of a fit with no
    regularization matrix."""
    return nreg == 0 or (
        method != "manual"
        and not (regparam_mode == "exact_grid" and method == "chi2"))


def prepare_chunk(values, errors, A, reg_mats, method, regparam_mode, device,
                  reg_eig=None, reg_taus=None):
    """The first step of fit_records on a record chunk: values and errors
    on ``device`` in float64, their sufficient statistics, and
    ``prepare_stats`` of them.  A and reg_mats: tensors on ``device``.
    Interpolate runs it a chunk ahead, on a worker thread and a side
    stream, so that its host eigendecompositions overlap the search of the
    chunk before."""
    values, errors = (torch.as_tensor(x, dtype=torch.float64, device=device)
                      for x in (values, errors))
    return prepare_stats(values, errors, suff_stats(A, values, errors),
                         reg_mats, method, regparam_mode, reg_eig, reg_taus)


def prepare_stats(values, errors, stats, reg_mats, method, regparam_mode,
                  reg_eig=None, reg_taus=None):
    """The decompositions of a record chunk that depend on its statistics
    stats = (AtWA, AtWb, btWb, N) only: AtWA's (``eigA``, where
    ``takes_atwa_eig``); in 'fast' mode each regularization matrix's
    whitened pencil (``pencils``); for the 'exact' chi2 search each
    matrix's search start, its seed anchor included (``starts``,
    regparam.chi2_search_start).  values, errors: the chunk on the fit's
    device (the GCV objective reads them); reg_eig, reg_taus as in
    fit_records.  Returns fit_records' ``prepared``.

    On the card the chunk is padded with empty records (NaN values, zero
    statistics) to a multiple of solve.CARD_BATCH, which fit_records drops
    from its results: cuBLAS and cuSOLVER pick their reduction orders from
    the batch's shape, the cutoff staircase turns last-bit changes into
    moved roots, and so a record's fit is the same whatever batch or layout
    it comes in (PERF.md)."""
    nreg = reg_mats.shape[0]
    nrec = values.shape[0]
    pad = _padding(values)
    if pad:
        empty = values.new_full((pad, values.shape[1]), float("nan"))
        values, errors = torch.cat([values, empty]), torch.cat([errors, empty])
        stats = tuple(torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
                      for x in stats)
    AtWA, AtWb, btWb, N = stats
    eigA = (atwa_eig(AtWA) if takes_atwa_eig(method, regparam_mode, nreg)
            else None)
    pencils = starts = None
    if nreg and method != "manual" and regparam_mode == "fast":
        pencils = [regparam.pencil(R, eigA) for R in reg_mats]
    elif nreg and method == "chi2" and regparam_mode == "exact":
        VR, sR = reg_mats_eig(reg_mats) if reg_eig is None else reg_eig
        taus = ([None] * nreg if reg_taus is None else torch.as_tensor(
            reg_taus, dtype=torch.float64, device=AtWA.device))
        starts = [regparam.chi2_search_start(
            AtWA, AtWb, btWb, N, reg_mats[i], eigA, (VR[i], sR[i]), taus[i])
            for i in range(nreg)]
    return {"values": values, "errors": errors, "stats": stats,
            "eigA": eigA, "pencils": pencils, "starts": starts, "nrec": nrec}


def _padding(values):
    """The empty records prepare_stats appends to a chunk: on the card up
    to a multiple of CARD_BATCH, none on the CPU."""
    if values.device.type != "cuda":
        return 0
    return -values.shape[0] % CARD_BATCH


def fit_records(values, errors, A, reg_mats, method: str = "chi2",
                manual_params=None, regparam_mode: str = "exact",
                device="cuda", reg_eig=None, reg_taus=None, prepared=None,
                point_sum=None):
    """Batched fit of a record block.

    values/errors: [nrec, npoints] (NaN value = no data); A: [npoints,
    nbasis]; reg_mats: [nreg, nbasis, nbasis]; manual_params: raw alphas
    [nreg] (reference convention) for method 'manual'.  Arrays or tensors;
    everything is moved to ``device`` in float64.  reg_eig: ``reg_mats_eig``
    of reg_mats, computed here when not given.  reg_taus: [nreg, nbasis]
    tau vectors or None.  prepared: ``prepare_chunk`` (or
    ``prepare_stats``) of these records in this method and mode, with these
    reg_eig and reg_taus (values and errors are then not read), computed
    here when not given.
    point_sum: for a fit whose points are sharded over processes
    (parallel/fit.py), the sum over the shards of a GCV objective computed
    on this process's points; prepared then holds the whole statistics.

    Returns tensors on ``device``: C [nrec, nb], dC [nrec, nb, nb],
    chi2 [nrec], reg_params [nrec, nreg] in the reference's RAW alpha
    units (0 for too-smooth, NaN for a failed search)."""
    global negative_chi2_reports
    if method not in METHODS:
        raise ValueError(f"unknown regularization method {method!r}")
    if regparam_mode not in REGPARAM_MODES:
        raise ValueError(f"unknown REGPARAM_MODE {regparam_mode!r}")
    device = torch.device(device)
    A, reg_mats = (torch.as_tensor(x, dtype=torch.float64, device=device)
                   for x in (A, reg_mats))
    nreg = reg_mats.shape[0]
    if method == "gcv":
        reg_taus = None
    if reg_taus is not None:
        reg_taus = torch.as_tensor(reg_taus, dtype=torch.float64,
                                   device=device)
    taus = [None] * nreg if reg_taus is None else list(reg_taus)
    if prepared is None:
        prepared = prepare_chunk(values, errors, A, reg_mats, method,
                                 regparam_mode, device, reg_eig, reg_taus)
    values, errors = prepared["values"], prepared["errors"]
    nrec = values.shape[0]  # the chunk's records, and the card's padding

    AtWA, AtWb, btWb, N = prepared["stats"]
    anchored = None
    if nreg == 0:
        log_alphas = torch.zeros((nrec, 0), dtype=torch.float64, device=device)
    elif method == "manual":
        with np.errstate(divide="ignore"):
            la = np.log10(np.asarray(manual_params, np.float64))
        log_alphas = torch.as_tensor(la, device=device).expand(nrec, nreg)
    elif regparam_mode == "exact_grid" and method == "chi2":
        log_alphas = torch.stack(
            [regparam.chi2_reg_param_grid(AtWA, AtWb, btWb, N, reg_mats[i],
                                          taus[i])
             for i in range(nreg)], dim=-1)
    elif regparam_mode == "fast":
        # the whitened pencils prepare_stats took from AtWA's decomposition
        if method == "chi2":
            searches = [regparam.chi2_reg_param_fast(AtWb, btWb, N, pen, tau)
                        for pen, tau in zip(prepared["pencils"], taus)]
        else:
            b, W, mask = masked_points(values, errors)
            searches = [regparam.gcv_reg_param_fast(
                AtWb, A, b, W, mask, pen, point_sum)
                for pen in prepared["pencils"]]
        log_alphas = torch.stack(searches, dim=-1)
    else:
        eigA = prepared["eigA"]
        if method == "gcv":
            VR, sR = reg_mats_eig(reg_mats) if reg_eig is None else reg_eig
            b, W, mask = masked_points(values, errors)
            searches = [regparam.gcv_reg_param_x(
                AtWA, AtWb, reg_mats[i], A, b, W, mask, eigA, (VR[i], sR[i]),
                point_sum) for i in range(nreg)]
        elif nreg == 1:
            # the search's start (R's basis in it) is prepare_stats'
            root, anchor, chi2_fb = regparam.chi2_reg_param(
                AtWA, AtWb, btWb, N, reg_mats[0], eigA, None,
                want_anchor=True, tau=taus[0], start=prepared["starts"][0])
            searches = [root]
            anchored = (anchor, chi2_fb)
        else:
            searches = [regparam.chi2_reg_param(
                AtWA, AtWb, btWb, N, reg_mats[i], eigA, None, tau=taus[i],
                start=prepared["starts"][i])
                for i in range(nreg)]
        log_alphas = torch.stack(searches, dim=-1)

    bad = torch.isnan(log_alphas).any(-1)
    if anchored is not None:
        anchor, chi2_fb = anchored
        C, dC, chi2 = final_solve_anchor(anchor, log_alphas[:, 0], AtWA, btWb)
        # a weighted sum of squares is never negative: a negative one is
        # reported as the whitened chi^2 at the root (ops/fit.py:146-153)
        neg = chi2 < 0.0
        negative_chi2_reports += int((neg & ~bad).sum())
        chi2 = torch.where(neg, chi2_fb, chi2)
    else:
        C, dC, chi2 = final_solve(AtWA, AtWb, btWb, reg_mats, log_alphas,
                                  reg_taus,
                                  eig=prepared["eigA"] if nreg == 0 else None)

    # NaN-fill failed records (interpolate.py:557-563)
    n = prepared["nrec"]
    C = torch.where(bad[:n, None], float("nan"), C[:n])
    dC = torch.where(bad[:n, None, None], float("nan"), dC[:n])
    chi2 = torch.where(bad[:n], float("nan"), chi2[:n])
    return C, dC, chi2, log_alphas_to_raw(log_alphas[:n])


def log_alphas_to_raw(log_alphas):
    """log10 alphas -> the reference's RAW alphas (-inf -> 0, NaN -> NaN)."""
    return torch.pow(10.0, log_alphas)


def fit_one_record(values, errors, A, reg_mats, method: str,
                   manual_params=None, regparam_mode: str = "exact",
                   device="cuda"):
    """Fit a single record: fit_records of a batch of one, returning
    (C, dC, chi2, reg_params) of the record as tensors on ``device``."""
    C, dC, chi2, rp = fit_records(
        torch.as_tensor(values, dtype=torch.float64)[None],
        torch.as_tensor(errors, dtype=torch.float64)[None], A, reg_mats,
        method=method, manual_params=manual_params,
        regparam_mode=regparam_mode, device=check_device(device))
    return C[0], dC[0], chi2[0], rp[0]
