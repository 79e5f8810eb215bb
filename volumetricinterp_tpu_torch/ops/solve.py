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
* Every eigendecomposition whose result becomes a fit's C, dC, chi^2 or
  alpha, in every mode and method, runs by ONE route, ``host_eigh``:
  LAPACK float64 on the host CPU, the results copied back to the fit's
  device (normalized_eigh, whiten_pencil and the solves built on them),
  and so does every one of the leave-one-beam-out sweep's (sweep.py, by
  sym_pinv_apply).  On the card that is a design choice, not a fallback:
  LAPACK resolves the modes at the gelsd cutoff as the JAX package's CPU
  float64 reference does, where cuSOLVER NaN-failed records and put the
  card's fits twice as far from that reference as a CPU's (PERF.md).  The
  statistics, products, kept-block solves and anchored rounds stay on the
  device.
* chi^2 uses the cancellation-free identity chi2 = btWb - u'z/s - C'(aR)C
  (u = V'AtWb, z the kept-mode solve, s the normalization scale).
* M-shift ANCHORS (``make_anchor`` / ``anchor_chi2`` /
  ``final_solve_anchor``): one eigendecomposition of X(alpha*) gives the
  exact projection at any other alpha, M(alpha) = M* + ((alpha - alpha*)/s)
  V'RV, solved on its kept block (no eigh per evaluation).
* The whitened pencil (``whiten_pencil``) turns chi^2(alpha) into an
  O(nbasis) closed form (jitter instead of the cutoff).
* An optional TAU vector per regularization matrix (data-informed
  regularization, a pull toward a target profile: penalty
  alpha (C'RC - 2 tau'C)) turns the rhs into AtWb + alpha tau; the chi^2
  reported and searched stays the data chi^2 (final_solve_x's reg_taus_x).

Regularization parameters travel as LOG10(alpha): raw alphas reach 1e-100;
-inf encodes alpha = 0 (the too-smooth outcome) and NaN a failed search.
Dense solves and inverses use the ``_ex`` forms: a singular kept block gives
inf/NaN, as in the JAX package, and never raises.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from ..utils.logging import span

EPS64 = 2.220446049250313e-16  # the reference's f64 cutoff unit
TINY64 = 2.2250738585072014e-308  # finfo(float64).tiny
_LOG2_10 = 3.321928094887362
# matrices ``host_eigh`` has taken since import, and the wall seconds of
# its calls: the copy to the host and LAPACK, not the copy back to the
# card, which is queued without a wait (chip_smoke.py and the benchmark's
# harness read them)
host_eigh_matrices = 0
eigh_matrices = 0  # always host_eigh_matrices; portbench/harness.py reads it
host_eigh_seconds = 0.0
# host threads of ``host_eigh``: each takes a slice of the batch
HOST_EIGH_THREADS = min(8, os.cpu_count() or 1)
# the most bytes of matrices ``host_eigh`` copies to the host at once (a
# power of two, the caching host allocator's block sizes)
HOST_EIGH_SLICE_BYTES = 2 << 30
_pools = threading.local()
_count_lock = threading.Lock()


def _one_thread(started):
    """A pool worker's initializer: one intra-op thread for this worker.
    torch.set_num_threads also sets the count that threads started later
    take up at their first parallel operation; _one_thread_pool puts its
    caller's count back once every worker is past this."""
    torch.get_num_threads()  # this worker takes up its count now, not later
    torch.set_num_threads(1)
    started.wait()


def _one_thread_pool(nworkers):
    """A pool of nworkers started threads, each with one intra-op thread;
    every other thread keeps the caller's count (a CPU product's bits
    follow the count)."""
    nthreads = torch.get_num_threads()
    started = threading.Barrier(nworkers + 1)
    pool = ThreadPoolExecutor(nworkers, initializer=_one_thread,
                              initargs=(started,))
    for _ in range(nworkers):  # start every worker now
        pool.submit(int)
    started.wait()
    torch.set_num_threads(nthreads)
    return pool


def _host_pool():
    """The calling thread's pool of HOST_EIGH_THREADS one-thread workers:
    Interpolate prepares the next chunk on a worker thread while its main
    thread searches this one, and with a pool each neither queues behind
    the other's decompositions."""
    pool = getattr(_pools, "pool", None)
    if pool is None:
        pool = _pools.pool = _one_thread_pool(HOST_EIGH_THREADS)
    return pool


def host_eigh(X):
    """torch.linalg.eigh of a (batch of) symmetric matrices X, computed in
    LAPACK float64 on the host CPU, the batch split over HOST_EIGH_THREADS
    threads; (w, V) come back on X's device.

    The fit engine's one decomposition: every eigendecomposition whose
    result becomes a fit's C, dC, chi^2 or alpha comes here, in every
    REGPARAM_MODE and method, on the card as on the CPU (normalized_eigh,
    whiten_pencil and the solves built on them), and every one of the
    leave-one-beam-out sweep's.  LAPACK resolves the
    near-null end of these matrices, the modes at the gelsd cutoff that set
    the exact search's floor and its staircase of roots, as the JAX
    package's CPU float64 reference does; the card's cuSOLVER resolved it
    otherwise, NaN-failed records, put the card's fits twice as far from
    the reference as a CPU's and made them follow the record batch's layout
    (PERF.md).  Each pool thread runs its slice with one intra-op thread:
    LAPACK's own threads on a 144x144 matrix only contend.

    The batch goes through in slices of at most HOST_EIGH_SLICE_BYTES of
    matrices (``eigh_slices``): PyTorch's caching host allocator keeps every
    page-locked buffer for the life of the process, and a whole batch's
    (720 matrices of 1200 x 1200 in the sweep at BASELINE config 3) held
    21 GiB.  LAPACK treats each matrix on its own, so the slicing moves
    no bit."""
    global eigh_matrices, host_eigh_matrices, host_eigh_seconds
    n = X[..., 0, 0].numel()
    with span("host_eigh"):
        t0 = time.perf_counter()
        Xf = X.detach().reshape((-1,) + X.shape[-2:])
        # to and from the card through page-locked buffers (PyTorch's
        # caching host allocator reuses them): pageable copies ran at ~3.5
        # GB/s, 0.54 s of a 1.83 s sweep call (PERF.md); the results go
        # back without a wait
        card = X.device.type == "cuda"
        w = torch.empty(Xf.shape[:-1], dtype=X.dtype, device=X.device)
        V = torch.empty(Xf.shape, dtype=X.dtype, device=X.device)
        for sl in eigh_slices(Xf):
            Xh = Xf[sl]
            if card:
                Xh = torch.empty(Xh.shape, dtype=X.dtype,
                                 pin_memory=True).copy_(Xh)
            parts = [p for p in torch.tensor_split(Xh, HOST_EIGH_THREADS)
                     if len(p)]
            res = list(_host_pool().map(torch.linalg.eigh, parts))
            wh, Vh = w[sl], V[sl]
            if card:
                wh = torch.empty(wh.shape, dtype=X.dtype, pin_memory=True)
                Vh = torch.empty(Vh.shape, dtype=X.dtype, pin_memory=True)
            torch.cat([r[0] for r in res], out=wh)
            torch.cat([r[1] for r in res], out=Vh)
            if card:
                w[sl].copy_(wh, non_blocking=True)
                V[sl].copy_(Vh, non_blocking=True)
        w, V = w.reshape(X.shape[:-1]), V.reshape(X.shape)
        dt = time.perf_counter() - t0
    with _count_lock:
        eigh_matrices += n
        host_eigh_matrices += n
        host_eigh_seconds += dt
    return w, V


def eigh_slices(X):
    """The slices host_eigh takes a batch X [B, n, n] in: as few as keep
    each at most HOST_EIGH_SLICE_BYTES (one matrix at least), of equal
    size but the last."""
    return even_slices(X.shape[0], HOST_EIGH_SLICE_BYTES
                       // (X.shape[-1] * X.shape[-2] * X.element_size()))


def even_slices(n, most):
    """range(n) in as few slices of at most ``most`` items (one at least)
    as will do, of equal size but the last."""
    most = max(1, most)
    per = -(-n // -(-n // most))  # <= most
    return [slice(s, s + per) for s in range(0, n, per)]


def _split_over_pool(fn, X, *rest):
    """fn(X, *rest) of a batch of matrices X [..., n, n] (rest batched
    alike): on the card one call; on the CPU the batch split over the host
    pool's one-thread workers, as host_eigh splits its batch.

    The CPU's batched LU (MKL's getrf over a batch, under torch.linalg's
    solve_ex and inv_ex) fails at n >= 256 once the calling thread's MKL
    count is set or MKL's dynamic threading is off, both of which
    torch.set_num_threads does (the latter for the whole process, and the
    pool's workers call it): MKL reports "Parameter 6 was incorrect on
    entry to DLASWP" and the call never returns (nbasis 1200, PERF.md).
    On one thread it runs, with the bits of the batched call in a process
    that never set a count."""
    if X.device.type == "cuda":
        return fn(X, *rest)
    lead = X.shape[:-2]
    flat = [x.reshape((-1,) + x.shape[len(lead):]) for x in (X,) + rest]
    parts = [p for p in zip(*(torch.tensor_split(x, HOST_EIGH_THREADS)
                              for x in flat)) if len(p[0])]
    out = torch.cat(list(_host_pool().map(lambda p: fn(*p), parts)))
    return out.reshape(lead + out.shape[1:])


def batched_solve(A, B):
    """torch.linalg.solve_ex(A, B)'s solution (inf/NaN for a singular
    system, never a raise) of a batch, by ``_split_over_pool``."""
    return _split_over_pool(lambda a, b: torch.linalg.solve_ex(a, b)[0], A, B)


def batched_inv(A):
    """torch.linalg.inv_ex(A)'s inverse of a batch, by
    ``_split_over_pool``."""
    return _split_over_pool(lambda a: torch.linalg.inv_ex(a)[0], A)


def pow10_split(a_log):
    """10**a_log as (mantissa, exponent), the JAX package's pow10_split
    (solve.py:57-67): m = 2^(t - floor t), t = a log2(10), rounded to
    float32 (returned as float64), and the exact power k = floor t (float64).
    -inf clamps to an exponent that flushes m * 2^k to 0; NaN stays NaN."""
    a = torch.clamp(a_log, min=-4000.0)
    t = a * _LOG2_10
    k = torch.floor(t)
    m = torch.exp2(t - k).to(torch.float32).to(a_log.dtype)
    return m, k


def alpha_of_log(a_log):
    """10**a_log as the JAX package forms it: m * 2^k of ``pow10_split``.
    -inf gives 0, NaN stays NaN."""
    m, k = pow10_split(a_log)
    return m * torch.exp2(k)


# records a batch of the card's statistics and fits (ops/fit.prepare_stats)
CARD_BATCH = 128


def suff_stats(A, values, errors):
    """Masked sufficient statistics of a record batch.

    A: [npoints, nbasis]; values, errors: [nrec, npoints] (NaN value = no
    data).  Returns (AtWA [nrec, nb, nb], AtWb [nrec, nb], btWb [nrec],
    N [nrec]).

    On the card the products run CARD_BATCH records at a time, a shorter
    batch padded with empty records: cuBLAS picks its reduction order from
    the shapes, the batch's size included, and the card's fits follow the
    last bits of their statistics, so a record's statistics must be the
    same bits in whatever batch it comes (a sharded layout's or the whole
    day's; PERF.md).  On the CPU one product over the batch, as the JAX
    package forms it."""
    if values.device.type != "cuda":
        return _batch_stats(A, values, errors)
    return padded_stats(A, values, errors)


def padded_stats(A, values, errors, batch=CARD_BATCH):
    """suff_stats as the card forms them: ``batch`` records a time, the
    last batch padded with empty records, each statistic a batched product
    of one record's own (AtWb and btWb too), so a record's bits depend on
    neither the batch's size nor its place in it."""
    nrec = values.shape[0]
    pad = -nrec % batch
    if pad:
        empty = values.new_full((pad, values.shape[1]), float("nan"))
        values, errors = torch.cat([values, empty]), torch.cat([errors, empty])
    parts = []
    for s in range(0, values.shape[0], batch):
        b, W, mask = masked_points(values[s:s + batch], errors[s:s + batch])
        Wb = W * b
        parts.append((A.T @ (A[None] * W[:, :, None]),
                      (A.T @ Wb[:, :, None])[..., 0],
                      (Wb[:, None, :] @ b[:, :, None])[:, 0, 0],
                      mask.sum(-1).to(A.dtype)))
    return tuple(torch.cat(x)[:nrec] for x in zip(*parts))


def _batch_stats(A, values, errors):
    """suff_stats of one batch of records, as one product each."""
    b, W, mask = masked_points(values, errors)
    Wb = W * b
    AtWA = A.T @ (A[None] * W[:, :, None])
    AtWb = Wb @ A
    btWb = (Wb * b).sum(-1)
    return AtWA, AtWb, btWb, mask.sum(-1).to(A.dtype)


def masked_points(values, errors):
    """Per-point (b, W, mask) of a record batch: NaN values get zero
    weight and value (interpolate.py:516-524)."""
    mask = torch.isfinite(values)
    W = torch.where(mask, errors, torch.ones_like(errors)) ** -2.0
    W = torch.where(mask, W, torch.zeros_like(W))
    b = torch.where(mask, values, torch.zeros_like(values))
    return b, W, mask


def norm_scale(X):
    """|trace X| / n, 1 where zero: the float64 normalization scale
    (_norm_scale_x, solve.py:655-664)."""
    n = X.shape[-1]
    t = torch.diagonal(X, dim1=-2, dim2=-1).sum(-1) / n
    return torch.where(t.abs() > 0, t.abs(), torch.ones_like(t))


def normalized_eigh(X):
    """(w, V, s): eigenpairs of X / s, s = norm_scale(X), by host_eigh."""
    s = norm_scale(X)
    w, V = host_eigh(X / s[..., None, None])
    return w, V, s


def _keep_mask(w, rcond=EPS64):
    """The kept modes |w| > rcond * max|w|."""
    aw = w.abs()
    return aw > rcond * aw.amax(-1, keepdim=True)


def _kept_solve(w, u, rcond):
    """z = u / w on the kept modes |w| > rcond * max|w|, 0 elsewhere."""
    keep = _keep_mask(w, rcond)
    return torch.where(keep, u / torch.where(keep, w, torch.ones_like(w)),
                       torch.zeros_like(w))


def cutoff_chi2_x(AtWA, AtWb, btWb, aR, atau=None):
    """chi^2 of the fit with X = AtWA + aR under reference gelsd-cutoff
    semantics (interpolate.py:220-261), batched: aR [B, nb, nb] is alpha R
    already formed, atau [B, nb] alpha tau or None.  The float64 branch of
    the JAX package's cutoff_chi2_x / chi2_from_eig_x (the
    cancellation-free identity)."""
    w, V, s = normalized_eigh(AtWA + aR)
    return chi2_from_eig_x(w, V, None, AtWb, btWb, s, aR=aR, atau=atau,
                           AtWA=AtWA)


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


def final_solve(AtWA, AtWb, btWb, reg_mats, log_alphas, reg_taus=None,
                eig=None):
    """Coefficients, covariance and chi^2 of a record batch's regularized
    fit (interpolate.py:432-469 with calccov=True, and the chi^2 of
    interpolate.py:569): the float64 branch of final_solve_x.

    reg_mats: [nreg, nb, nb]; log_alphas: [nrec, nreg] LOG10 alphas (-inf
    is alpha = 0); reg_taus: [nreg, nb] tau vectors or None (the rhs is then
    AtWb + sum alpha tau, and chi^2 gains sum alpha tau'C).  Records with a
    NaN alpha are solved at alpha = 0 here; the caller NaN-fills them.
    eig: with no regularization matrix (X = AtWA), AtWA's ``normalized_eigh``
    to use in place of decomposing X here.
    Returns (C [nrec, nb], dC [nrec, nb, nb], chi2 [nrec])."""
    n = AtWA.shape[-1]
    aR = torch.zeros_like(AtWA)
    rhs = AtWb
    alphas = []
    for i in range(reg_mats.shape[0]):
        a = alpha_of_log(log_alphas[:, i])
        a = torch.where(torch.isnan(a), torch.zeros_like(a), a)
        alphas.append(a)
        aR = aR + a[:, None, None] * reg_mats[i]
        if reg_taus is not None:
            rhs = rhs + a[:, None] * reg_taus[i]
    X = AtWA + aR
    # a root at alpha = inf (a search that ran off the line) has no
    # eigenpairs: solve the identity there; the outputs come out NaN
    bad = ~torch.isfinite(X).all(-1).all(-1)
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    if eig is not None and reg_mats.shape[0] == 0:
        w, V, s = eig
    else:
        w, V, s = normalized_eigh(torch.where(bad[:, None, None], eye, X))
    Vt = V.transpose(-1, -2)
    ub = (Vt @ AtWb[..., None])[..., 0]
    u = ub if reg_taus is None else (Vt @ rhs[..., None])[..., 0]
    z = _kept_solve(w, u, EPS64)
    C = (V @ z[..., None])[..., 0] / s[..., None]
    # dC = H AtWA H, H = V diag(1/w)|keep_H V' / s, the pinv cutoff
    inv_w_H = _kept_solve(w, torch.ones_like(w), float(n) * EPS64)
    G = Vt @ AtWA @ V
    Hmid = inv_w_H[..., :, None] * G * inv_w_H[..., None, :]
    dC = V @ Hmid @ Vt / (s * s)[..., None, None]
    chi2 = btWb - (ub * z).sum(-1) * (1.0 / s)
    if reg_taus is not None:
        for a, tau in zip(alphas, reg_taus):
            chi2 = chi2 + a * (C * tau).sum(-1)
    chi2 = chi2 - (C * (aR @ C[..., None])[..., 0]).sum(-1)
    nan = float("nan")
    return (torch.where(bad[:, None], nan, C),
            torch.where(bad[:, None, None], nan, dC),
            torch.where(bad, nan, chi2))


# ---------------------------------------------------------------------------
# kept-block solves and chi^2 from a (near-)eigenbasis
# ---------------------------------------------------------------------------

def _mv(M, x):
    """Batched matrix-vector product M @ x."""
    return (M @ x[..., None])[..., 0]


def _dot(a, b):
    return (a * b).sum(-1)


def project(X, V):
    """M = V'XV, symmetrized (the float64 branch of _project_x,
    solve.py:263-270).  X may be shared ([n, n]) or batched."""
    M = V.transpose(-1, -2) @ (X @ V)
    return 0.5 * (M + M.transpose(-1, -2))


def keep_solve(u, M, keep):
    """z solving M|keep z = u|keep on the kept modes, 0 elsewhere: the
    identity-padded kept block and one dense solve (the float64 branch of
    _keep_solve_x, solve.py:766-778).  Exact for any basis of the kept
    subspace, so anchored (off-diagonal) projections solve coupled."""
    n = M.shape[-1]
    km = keep[..., None, :] & keep[..., :, None]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    A = torch.where(km, M, eye)
    rhs = torch.where(keep, u, torch.zeros_like(u))
    z = batched_solve(A, rhs[..., None])[..., 0]
    return torch.where(keep, z, torch.zeros_like(z))


def chi2_from_eig_x(w, V, M, AtWb, btWb, s, aR=None, atau=None, AtWA=None):
    """Reference-cutoff chi^2 from eigenpairs (w, V) of X/s with the exact
    projection M = V'(X/s)V (the float64 branch of chi2_from_eig_x,
    solve.py:811-858): keep = |w| > eps max|w|, z the kept-block solve of
    u = V'(AtWb + atau), chi2 = btWb - ub'z/s + C'atau - C'(aR)C with
    ub = V'AtWb, C = Vz/s.  ``M=None`` means M = diag(w) exactly (a true
    eigenbasis): the kept solve is then the division it reduces to.
    ``aR``: alpha R inside X, [n, n] shared or batched, or None for
    alpha = 0; ``atau``: alpha tau [.., n] or None, with ``AtWA`` [B, n, n].

    Where the pull dominates (|C'atau| > |C'AtWb|, e.g. alpha = 1 with a
    density profile: C'atau ~ C'(aR)C ~ 1e22 cancel to chi2 ~ 1e4), the
    last two terms are taken as C'(AtWA C) - C'AtWb, which the kept-block
    normal equations make equal and which carries no such cancellation.
    The JAX package keeps the identity there, and its chi^2 at alpha = 1
    comes out as rounding noise of either sign (PERF.md)."""
    Vt = V.transpose(-1, -2)
    ub = _mv(Vt, AtWb)
    u = ub if atau is None else _mv(Vt, AtWb + atau)
    z = (_kept_solve(w, u, EPS64) if M is None
         else keep_solve(u, M, _keep_mask(w)))
    chi2 = btWb - _dot(ub, z) * (1.0 / s)
    if aR is None and atau is None:
        return chi2
    C = _mv(V, z) / s[..., None]
    if atau is None:
        return chi2 - _dot(C, _mv(aR, C))
    pull, data = _dot(C, atau), _dot(C, AtWb)
    ident = chi2 + pull
    if aR is not None:
        ident = ident - _dot(C, _mv(aR, C))
    return torch.where(pull.abs() > data.abs(),
                       chi2 + _dot(C, _mv(AtWA, C)) - data, ident)


# ---------------------------------------------------------------------------
# M-shift anchors (solve.py:870-992, 1437-1524; float64 branches)
# ---------------------------------------------------------------------------

def make_anchor(a_log, w, V, s, R, AtWb, tau=None):
    """An M-shift anchor from the eigendecomposition (w, V, s) of
    X(10^a_log)/s (a_log = -inf for AtWA alone): the float64 branch of
    make_anchor_x (solve.py:898-914).  M = diag(w) exactly, P = V'RV in raw
    R units, ub = V'AtWb, ut = V'tau (None without a tau)."""
    Vt = V.transpose(-1, -2)
    return {"a_log": a_log, "V": V, "s": s, "M": torch.diag_embed(w),
            "P": project(R, V), "ub": _mv(Vt, AtWb),
            "ut": None if tau is None else _mv(Vt, tau)}


def select_anchor(cond, a, b):
    """Per record: anchor a where cond, else b."""
    out = {}
    for key, x in a.items():
        if x is None:
            out[key] = None
            continue
        c = cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim()))
        out[key] = torch.where(c, x, b[key])
    return out


def anchor_shift_M(anchor, m, k):
    """M(alpha)/s* = M* + ((alpha - alpha*)/s*) P at alpha = m 2^k (the
    float64 branch of _anchor_shift_M, solve.py:920-925).  alpha* is the
    exact 10**a*, alpha the float32-mantissa split: the two forms differ by
    ~1e-8 relative at a* itself, as in the JAX package."""
    a_log = anchor["a_log"]
    a_star = torch.where(torch.isneginf(a_log), torch.zeros_like(a_log),
                         torch.pow(10.0, a_log))
    a = m * torch.exp2(k)
    return anchor["M"] + ((a - a_star) / anchor["s"])[:, None, None] * anchor["P"]


def _anchor_rhs(anchor, m, k):
    """V'(AtWb + alpha tau) at alpha = m 2^k: ub, plus alpha ut with a tau."""
    if anchor["ut"] is None:
        return anchor["ub"]
    return anchor["ub"] + (m * torch.exp2(k))[:, None] * anchor["ut"]


def _anchor_chi2(anchor, m, k, z, btWb):
    """chi2 = btWb - ub'z/s - alpha z'Pz/s^2 (+ alpha z'ut/s with a tau) at
    alpha = m 2^k."""
    s = anchor["s"]
    chi2 = btWb - _dot(anchor["ub"], z) * (1.0 / s)
    zPz = _dot(z, _mv(anchor["P"], z))
    a = m * torch.exp2(k)
    chi2 = chi2 - a * zPz / (s * s)
    if anchor["ut"] is not None:
        chi2 = chi2 + a * _dot(z, anchor["ut"]) / s
    return chi2


def anchor_chi2(anchor, a_log, btWb):
    """Exact-cutoff chi^2 at alpha = 10^a_log from the anchor, no eigh (the
    float64 branch of anchor_chi2_x, solve.py:944-986): keep from the
    diagonal of the shifted projection, the coupled kept-block solve, and
    chi2 = btWb - ub'z/s - alpha z'Pz/s^2."""
    m, k = pow10_split(a_log)
    M = anchor_shift_M(anchor, m, k)
    keep = _keep_mask(torch.diagonal(M, dim1=-2, dim2=-1))
    z = keep_solve(_anchor_rhs(anchor, m, k), M, keep)
    return _anchor_chi2(anchor, m, k, z, btWb)


def final_solve_anchor(anchor, a_log, AtWA, btWb):
    """Coefficients, covariance and chi^2 at alpha = 10^a_log from the
    anchor (the float64 branch of final_solve_anchor_x,
    solve.py:1437-1519): the gelsd cutoff for C, the pinv cutoff for the
    covariance, which inverts the identity-padded kept_H block of the
    shifted projection: dC = V Minv G Minv V' / s, G = V'(AtWA/s)V."""
    m, k = pow10_split(a_log)
    M = anchor_shift_M(anchor, m, k)
    w = torch.diagonal(M, dim1=-2, dim2=-1)
    n = w.shape[-1]
    keep_C = _keep_mask(w)
    keep_H = _keep_mask(w, float(n) * EPS64)
    z = keep_solve(_anchor_rhs(anchor, m, k), M, keep_C)
    V, s = anchor["V"], anchor["s"]
    Vt = V.transpose(-1, -2)
    C = _mv(V, z) / s[:, None]
    kmH = keep_H[..., None, :] & keep_H[..., :, None]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    Minv = batched_inv(torch.where(kmH, M, eye))
    Minv = torch.where(kmH, Minv, torch.zeros_like(Minv))
    G = (Vt @ (AtWA / s[:, None, None])) @ V
    dC = (V @ (Minv @ G @ Minv) @ Vt) / s[:, None, None]
    return C, dC, _anchor_chi2(anchor, m, k, z, btWb)


# ---------------------------------------------------------------------------
# the whitened pencil (solve.py:1734-1795, non-TPU branches)
# ---------------------------------------------------------------------------

WHITEN_JITTER = 1e-12  # AtWA's eigenvalues are clipped at this times the max


def whiten_pencil(R, eig_AtWA):
    """One-time whitening of the pencil (AtWA, R) for O(nbasis) alpha
    scans: with AtWA = V W V', B^-1 = W~^-1/2 V' (W~ clipped at
    WHITEN_JITTER max W), G = B^-1 R B^-T = Q Lam Q'.  R [n, n];
    ``eig_AtWA``: (w [B, n], V [B, n, n]) of AtWA on the RAW scale.
    Returns (lam [B, n], Q [B, n, n], Binv [B, n, n])."""
    w, V = eig_AtWA
    n = w.shape[-1]
    wmax = w.abs().amax(-1, keepdim=True)
    floor = WHITEN_JITTER * torch.where(wmax > 0, wmax, torch.ones_like(wmax))
    w_safe = torch.maximum(w, floor)
    Binv = (w_safe ** -0.5)[..., :, None] * V.transpose(-1, -2)
    sR = torch.trace(R) / n
    sR = torch.where(sR.abs() > 0, sR.abs(), torch.ones_like(sR))
    G = Binv @ (R / sR) @ Binv.transpose(-1, -2)
    G = 0.5 * (G + G.transpose(-1, -2))
    sG = torch.diagonal(G, dim1=-2, dim2=-1).abs().sum(-1) / n + 1e-300
    lam, Q = host_eigh(G / sG[:, None, None])
    return lam * (sG * sR)[:, None], Q, Binv


def whitened_chi2(a_log, lam, u, btWb, utau=None):
    """chi^2(10^a_log) from whitened quantities (u = Q'B^-1 AtWb):
    sum u^2 (d^2 - 2d) + btWb, d = 1/(1 + alpha lam), alpha the float32-
    mantissa split (whitened_chi2_split, solve.py:1789-1795).  With a tau
    (utau = Q'B^-1 tau, t = alpha utau) the rhs is u + t and chi^2 gains
    sum t (2u (d^2 - d) + d^2 t) (whitened_chi2_tau_split, :1798-1812, in
    a form whose tau term is exactly 0 for a zero tau).  a_log is [B] or
    [B, npts]; lam, u, utau [B, n]; btWb [B]."""
    m, k = pow10_split(a_log)
    extra = (1,) * (a_log.dim() - 1)
    lam = lam.reshape(lam.shape[:1] + extra + lam.shape[1:])
    u = u.reshape(lam.shape)
    al = m[..., None] * lam * torch.exp2(k)[..., None]
    d = 1.0 / (1.0 + al)
    chi2 = (u * u * (d * d - 2.0 * d)).sum(-1) + btWb.reshape(btWb.shape + extra)
    if utau is None:
        return chi2
    t = (m * torch.exp2(k))[..., None] * utau.reshape(lam.shape)
    return chi2 + (t * (2.0 * u * (d * d - d) + d * d * t)).sum(-1)


def deflated_diag(M):
    """Second-order-corrected eigenvalue estimates from a projection M,
    w_i ~ M_ii - sum_j M_ij^2 / (M_jj - M_ii) over reliably separated
    pairs, clamped into [min(d, 0), max(d, 0)] (the float64 branch of
    _deflated_diag_x, solve.py:1002-1049)."""
    d = torch.diagonal(M, dim1=-2, dim2=-1)
    n = d.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=M.device)
    den = d[..., None, :] - d[..., :, None]  # den[i, j] = d_j - d_i
    ad = d.abs()
    reliable = den.abs() > 0.5 * (ad[..., None, :] + ad[..., :, None])
    num = torch.where(reliable & ~eye, M * M, torch.zeros_like(M))
    corr = (num / torch.where(den.abs() > TINY64, den,
                              torch.ones_like(den))).sum(-1)
    h = d - corr
    zero = torch.zeros_like(d)
    h = torch.minimum(torch.maximum(h, torch.minimum(d, zero)),
                      torch.maximum(d, zero))
    return torch.where(h.abs() < TINY64, torch.sign(d) * TINY64, h)
