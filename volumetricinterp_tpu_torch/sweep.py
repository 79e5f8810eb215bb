"""Leave-one-beam-out cross-validation sweeps (BASELINE.json config 5).

Model-selection tooling the reference lacks (the JAX package's sweep.py):
score basis orders and regularization strengths by how well fits trained
WITHOUT a radar beam predict that beam's measurements.

Everything runs on per-beam sufficient statistics, in float64 on the
device.  For each record and beam b,

    AtWA_loo(b) = AtWA_total - AtWA_b   (the same for AtWb),

so a leave-one-beam-out fit is an [nbasis, nbasis] subtraction and a
cutoff solve (ops/solve.sym_pinv_apply, one eigendecomposition), and the
held-out score is chi2_b = C'AtWA_b C - 2 C'AtWb_b + btWb_b: no per-point
work in the sweep.  The (record x beam x alpha) grid runs as one batch
axis, in chunks of LOBO_CHUNK solves.

Every decomposition of the sweep takes the fit's route, ops/solve.host_eigh
(LAPACK float64 on the host, by sym_pinv_apply): LAPACK's syevd is the JAX
package's CPU eigh, and it keeps the held-out scores at the production
order where the CPU port lands against the JAX CPU float64 reference, which
the card's cuSOLVER did not (PERF.md).  The statistics, the leave-one-out
subtraction, the alpha R shift, the cutoff solve's products and the
held-out quadratic form stay on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.solve import masked_points, sym_pinv_apply
from .utils.device import check_device


def per_beam_stats(values, errors, A, beam_idx, nbeam):
    """Sufficient statistics per (record, beam), on A's device.

    values/errors: [nrec, npoints] tensors (NaN value = no data); A:
    [npoints, nb]; beam_idx: [npoints] ints.  Returns (AtWA [nrec, nbeam,
    nb, nb], AtWb [nrec, nbeam, nb], btWb [nrec, nbeam], N [nrec,
    nbeam])."""
    b, W, mask = masked_points(values, errors)
    beam_idx = torch.as_tensor(np.asarray(beam_idx), device=A.device)
    out = [[], [], [], []]
    for bi in range(nbeam):
        on = beam_idx == bi
        Ab, Wb, bb = A[on], W[:, on], b[:, on]
        out[0].append(Ab.T @ (Ab[None] * Wb[:, :, None]))
        out[1].append((Wb * bb) @ Ab)
        out[2].append((Wb * bb * bb).sum(-1))
        out[3].append(mask[:, on].sum(-1).to(A.dtype))
    return tuple(torch.stack(x, dim=1) for x in out)


LOBO_CHUNK = 1024  # solves a batch: ~0.2 GB of float64 144x144 matrices


def _lobo_scores(stats, R, log10_alphas):
    """Held-out chi2 per (record, beam, alpha) [nrec, nbeam, nalpha] from
    ``per_beam_stats``; R [nb, nb] on the statistics' device.  One
    eigendecomposition per entry, on the host (solve.host_eigh_matrices
    counts them)."""
    AtWA_b, AtWb_b, btWb_b, _ = stats
    nrec, nbeam = AtWA_b.shape[:2]
    alphas = torch.pow(10.0, torch.as_tensor(
        np.asarray(log10_alphas, np.float64), device=R.device))
    na = alphas.shape[0]
    AtWA, AtWb = AtWA_b.sum(1), AtWb_b.sum(1)
    total = nrec * nbeam * na
    out = torch.empty(total, dtype=R.dtype, device=R.device)
    for s in range(0, total, LOBO_CHUNK):
        i = torch.arange(s, min(s + LOBO_CHUNK, total), device=R.device)
        r, b, a = i // (nbeam * na), (i // na) % nbeam, i % na
        Ao, Bo = AtWA_b[r, b], AtWb_b[r, b]
        X = (AtWA[r] - Ao) + alphas[a, None, None] * R
        C, _ = sym_pinv_apply(X, AtWb[r] - Bo, want_H=False)
        out[s:s + len(i)] = ((C * (Ao @ C[..., None])[..., 0]).sum(-1)
                             - 2.0 * (C * Bo).sum(-1) + btWb_b[r, b])
    return out.reshape(nrec, nbeam, na)


def lobo_cv(values, errors, A, beam_idx, R, log10_alphas, device="cuda"):
    """Leave-one-beam-out CV scores summed over records and beams.

    values/errors [nrec, npoints], A [npoints, nb], beam_idx [npoints],
    R [nb, nb]: arrays, moved to ``device`` in float64.  Returns host
    (scores [nalpha], per_beam [nrec, nbeam, nalpha]).  Lower is better;
    the scores are weighted held-out chi2 (comparable to the number of
    held-out points when the model generalizes perfectly)."""
    device = check_device(device)
    f64 = lambda x: torch.as_tensor(np.asarray(x, np.float64),  # noqa: E731
                                    device=device)
    nbeam = int(np.max(np.asarray(beam_idx))) + 1
    stats = per_beam_stats(f64(values), f64(errors), f64(A), beam_idx, nbeam)
    per = _lobo_scores(stats, f64(R), log10_alphas).cpu().numpy()
    return per.sum(axis=(0, 1)), per


def order_sweep(config, values, errors, lat, lon, alt, beam_idx, orders,
                log10_alphas, reg_name="0thorder", device="cuda"):
    """Sweep basis order x regularization strength by LOBO CV.

    config: a sphharmlag Config (or its text); orders: list of (maxk,
    maxl).  Returns a dict with the score matrix [norders, nalpha] and the
    argmin selection (best_order, best_log10_alpha)."""
    from .config import Config
    from .models.sphharmlag import Model

    scores = np.zeros((len(orders), len(log10_alphas)))
    for i, (maxk, maxl) in enumerate(orders):
        cfg = Config.from_text(
            config.raw_text if isinstance(config, Config) else config)
        cfg.model.maxk = maxk
        cfg.model.maxl = maxl
        model = Model(cfg)
        A = model.basis(lat, lon, alt)
        R = model.eval_omega() if reg_name == "curvature" else model.eval_psi()
        scores[i], _ = lobo_cv(values, errors, A, beam_idx, R, log10_alphas,
                               device=device)
    best = np.unravel_index(np.argmin(scores), scores.shape)
    return {
        "scores": scores,
        "orders": list(orders),
        "log10_alphas": list(log10_alphas),
        "best_order": orders[best[0]],
        "best_log10_alpha": log10_alphas[best[1]],
    }
