"""Estimate — coefficient-file evaluation engine (API parity with the
reference estimate.py:13-221 and the JAX package's Estimate).

* ``__call__`` (the point API) runs on the host in exact float64 numpy:
  design matrix, A @ C, the FoV hull mask, with calcgrad the gradient
  G @ C in cap components, with calcerr the field error sqrt(a' dC a)
  (and with both the gradient's error).
* ``check_hull`` is the FoV mask alone, in float64 on ``device``; the
  point API and the dense-grid path take the host mask, as the JAX
  package's do.
* ``get_C`` takes the nearest record, interpolates linearly between two
  records (timeinterp=True), or evaluates the file's /TimeFit spline
  (timeinterp='spline', covariance from the nearest record).
* ``grid_eval`` / ``evaluate_records`` (dense grids, keogram/volume
  products) run through the float32 grid evaluator on ``device``: for
  sphharmlag the Hopper kernel on the card, with the FoV mask applied
  inside the kernel, so one [chunk, npoints] output buffer exists per
  record chunk (two while the next chunk is launched ahead); for radbasfun
  ops/grid_eval.RBFGridEvaluator.  A CUDA chunk comes to the host through
  a ring of page-locked buffers that the Estimate keeps.
"""

from __future__ import annotations

import datetime as dt
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .config import Config
from . import coords, models
from .io.coeffs import load_coeff_file
from .ops.grid_eval import make_grid_evaluator
from .utils.device import check_device
from .utils.hull import check_hull as hull_mask
from .utils.hull import hull_equations
from .utils.hull import np_check_hull as np_hull_mask
from .utils.logging import PhaseTimer, span

# the most bytes of float32 output one launch of evaluate_records writes on
# the device (one record at least)
CHUNK_BYTES = 2 << 28
# evaluate_records' ring of page-locked host buffers, through which every
# CUDA chunk comes to the host: STAGE_SLOTS buffers of STAGE_SLOT_BYTES
# (PERF.md: the size read on the card)
STAGE_SLOT_BYTES = 64 << 20
STAGE_SLOTS = 3
# slices and bytes copied through the ring since import (chip_smoke.py and
# the tests read them; 0 off the card)
staged_slices = 0
staged_bytes = 0
# _prepare_grid's calls since import that found the cached grid the
# caller's (hits) or prepared it anew (misses)
grid_hits = 0
grid_misses = 0


def copy_plan(nrec, npts):
    """How evaluate_records walks its float32 [nrec, npts] output:
    [(rows, pieces)] with ``rows`` the slice of records of one launch (at
    most CHUNK_BYTES of output, one record at least) and ``pieces`` the
    slices of that chunk's flattened [rows, npts] block, in order, of at
    most STAGE_SLOT_BYTES each: the copies through the ring.  Empty for an
    empty output."""
    if nrec == 0 or npts == 0:
        return []
    chunk = max(1, CHUNK_BYTES // (4 * npts))
    step = STAGE_SLOT_BYTES // 4
    plan = []
    for s in range(0, nrec, chunk):
        rows = slice(s, min(s + chunk, nrec))
        n = (rows.stop - s) * npts
        plan.append((rows, [slice(a, min(a + step, n))
                            for a in range(0, n, step)]))
    return plan


def _words(a):
    """The bytes of the contiguous array ``a`` as one flat array of unsigned
    integers, of the widest word (at most 8 bytes) that divides its size:
    equal words are equal bytes, so a NaN matches itself and -0.0 does not
    match 0.0."""
    flat = a.reshape(-1).view(np.uint8)
    return flat.view(f"u{math.gcd(flat.size, 8)}")


def same_grid(kept, arrays):
    """Whether each contiguous array of ``arrays`` has the shape, the dtype
    and every byte of its counterpart in ``kept``.  Each array's words are
    cut into torch.get_num_threads() slices, compared on as many threads
    (numpy's comparison releases the GIL)."""
    if any(a.shape != k.shape or a.dtype != k.dtype
           for a, k in zip(arrays, kept)):
        return False
    n = torch.get_num_threads()
    pieces = [p for a, k in zip(arrays, kept)
              for p in zip(np.array_split(_words(a), n),
                           np.array_split(_words(k), n))]
    with ThreadPoolExecutor(n) as pool:
        return all(pool.map(lambda p: np.array_equal(*p), pieces))


class Estimate:
    def __init__(self, coeff_filename, timetol=60.0, timeinterp=False,
                 device="cuda"):
        """timeinterp: False (nearest record within timetol, reference
        default), True (linear between bracketing records) or 'spline' (the
        time-smoothed coefficients of the file's /TimeFit payload, written
        by a fit with TIME_SMOOTHING set).  device: where dense grids are
        evaluated ('cuda' or 'cpu'; no fallback)."""
        self.device = check_device(device)
        self.timetol = timetol
        self.timeinterp = timeinterp

        self.loadh5(filename=coeff_filename)
        if timeinterp == "spline" and self.timefit is None:
            raise ValueError(
                "timeinterp='spline' needs a /TimeFit payload; re-run the "
                "fit with [DEFAULT] TIME_SMOOTHING set (gcv or a number)")

        # reconstruct the identical Model from the embedded config text
        # (reference estimate.py:41-50)
        text = self.config_file_text
        if isinstance(text, bytes):
            text = text.decode("utf-8")
        self.config = Config.from_text(text)
        self.model_name = self.config.model.name
        self.model = models.make_model(self.model_name, self.config)

        self._hull_eqs = hull_equations(self.hull_vert)
        self._prepared_grid = None
        self._grid_ev = None
        self._ring = None  # [(page-locked buffer, event)]: _stage
        self.timer = PhaseTimer()

    def loadh5(self, filename=None):
        """Load the coefficient file (reference estimate.py:53-70)."""
        d = load_coeff_file(filename)
        self.Coeffs = d["Coeffs"]
        self.Covariance = d["Covariance"]
        self.time = d["UnixTime"]
        self.hull_vert = d["hull_vert"]
        self.config_file_text = d["config_file_text"]
        self.chi2 = d.get("chi2")
        self.raw_filename = d.get("raw_filename")
        self.timefit = d.get("timefit")

    def __call__(self, time, gdlat, gdlon, gdalt, calcgrad=False,
                 calcerr=False, check_hull=True):
        """Evaluate the reconstruction at geodetic points for one time, on
        the host in float64.  Returns
            P                    (calcgrad=False, calcerr=False)
            P, dP                (calcgrad: dP[..., 3] the gradient in cap
                                 components (z-hat, theta-hat, phi-hat))
            P, err               (calcerr)
            P, dP, err, graderr  (both)."""
        C, dC = self.get_C(time)
        C = np.asarray(C, np.float64)
        A = np.asarray(self.model.basis(gdlat, gdlon, gdalt), np.float64)
        parameter = A @ C
        inside = None
        if check_hull:
            inside = np_hull_mask(self._hull_eqs, gdlat, gdlon, gdalt)
            parameter = np.where(inside, parameter, np.nan)

        def masked(x, trailing=0):
            if not check_hull:
                return x
            return np.where(inside.reshape(inside.shape + (1,) * trailing),
                            x, np.nan)

        outs = [parameter]
        if calcgrad:
            G = np.asarray(self.model.grad_basis(gdlat, gdlon, gdalt),
                           np.float64)  # [..., 3, nbasis]
            outs.append(masked(G @ C, 1))
        if calcerr:
            dC = np.asarray(dC, np.float64)
            outs.append(masked(np.sqrt(np.einsum("...i,ij,...j->...", A, dC,
                                                 A))))
            if calcgrad:
                outs.append(masked(np.sqrt(
                    np.einsum("...ci,ij,...cj->...c", G, dC, G)), 1))
        return outs[0] if len(outs) == 1 else tuple(outs)

    def inverse_transform(self, gdlat, gdlon, gdalt, vec):
        """Cap-frame vectors (e.g. calcgrad's dP) at geodetic points rotated
        to ECEF components: Model.inverse_transform."""
        return self.model.inverse_transform(gdlat, gdlon, gdalt, vec)

    def check_hull(self, lat0, lon0, alt0):
        """Inside-FoV mask (reference estimate.py:153-178 semantics through
        the half-space test, utils/hull.py), computed on ``self.device``;
        a numpy bool array shaped like lat0."""
        return hull_mask(self._hull_eqs, lat0, lon0, alt0,
                         device=self.device).cpu().numpy()

    def get_C(self, t):
        """Coefficients for a requested time (reference estimate.py:180-221):
        nearest record within timetol, linear interpolation between the two
        bracketing record mid-times when timeinterp=True, or the time spline
        when timeinterp='spline' (covariance from the nearest record: the
        spline smooths the coefficient trajectory, the per-record error bars
        stay).  Naive datetimes are UTC; aware ones are converted to UTC."""
        if t.tzinfo is not None:
            t = t.astimezone(dt.timezone.utc).replace(tzinfo=None)
        t0 = (t - dt.datetime(1970, 1, 1)).total_seconds()
        mt = np.mean(self.time, axis=1)
        if self.timeinterp == "spline":
            from .ops.timesmooth import eval_time_spline

            C = eval_time_spline(self.timefit, t0)  # raises out of range
            return C, self.Covariance[np.argmin(np.abs(mt - t0))]
        try:
            if self.timeinterp:
                i = np.argwhere((t0 >= mt[:-1]) & (t0 < mt[1:])).flatten()[0]
                T = (t0 - mt[i]) / (mt[i + 1] - mt[i])
                C = (1 - T) * self.Coeffs[i, :] + T * self.Coeffs[i + 1, :]
                dC = (1 - T) * self.Covariance[i, :, :] + T * self.Covariance[
                    i + 1, :, :
                ]
            else:
                i = np.argmin(np.abs(mt - t0))
                if np.abs(mt[i] - t0) > self.timetol:
                    raise IndexError
                C = self.Coeffs[i]
                dC = self.Covariance[i]
        except IndexError:
            raise ValueError("Requested time out of range of data file.")
        return C, dC

    # ------------------------------------------------------------------
    # dense-grid path
    # ------------------------------------------------------------------

    def _prepare_grid(self, gdlat, gdlon, gdalt, need_hull):
        """Record-independent state of one evaluation grid, cached for the
        most recent grid: the float32 coordinates on the device, the
        colatitude band (host float64 cap transform; None for a model
        without Legendre tables), the FoV mask (host half-space test) on
        the device, and a contiguous copy of the three coordinate arrays.
        A later call reuses the state only if its arrays match that copy in
        shape, dtype and every byte (``same_grid``, the ``grid_hash``
        phase; ``grid_hits`` / ``grid_misses`` count the outcome).  The
        copy holds the grid's bytes in host memory, 805 MB for a
        512x512x128 float64 grid, until the cache is cleared
        (``_prepared_grid = None``) or holds another grid.  Called with a
        non-empty grid; each step is a ``self.timer`` phase."""
        global grid_hits, grid_misses
        g = self._prepared_grid
        with self.timer.phase("grid_hash"):
            arrays = [np.ascontiguousarray(a) for a in (gdlat, gdlon, gdalt)]
            hit = g is not None and same_grid(g["kept"], arrays)
        if hit:
            grid_hits += 1
        else:
            grid_misses += 1
            shape = np.shape(gdlat)
            band = None
            if hasattr(self.model, "tables"):  # band-limited (sphharmlag)
                with self.timer.phase("grid_band"):
                    _, t, _ = coords.np_geodetic_to_cap(
                        np.asarray(gdlat, np.float64).ravel(),
                        np.asarray(gdlon, np.float64).ravel(),
                        np.asarray(gdalt, np.float64).ravel(),
                        self.model.latcp, self.model.loncp)
                    band = (float(t.min()), float(t.max()))
            g = {"shape": shape, "band": band, "inside": None}
            with self.timer.phase("grid_upload"):
                g["lat"], g["lon"], g["alt"] = (
                    torch.as_tensor(np.asarray(a).ravel(), dtype=torch.float32,
                                    device=self.device)
                    for a in (gdlat, gdlon, gdalt))
                g["kept"] = [a.copy() for a in arrays]
            self._prepared_grid = g
        if need_hull and g["inside"] is None:
            with self.timer.phase("grid_hull"):
                inside = np_hull_mask(self._hull_eqs, gdlat, gdlon, gdalt)
                g["inside"] = torch.as_tensor(inside.ravel(),
                                              device=self.device)
        return g

    def _band_evaluator(self, band):
        """Evaluator covering the band (None for a model without one, such
        as radbasfun), reused while a new band fits inside the cached
        one."""
        lo, hi = band if band is not None else (0.0, float(np.pi))
        ev = self._grid_ev
        if ev is None or not (ev.theta_lo <= lo and hi <= ev.theta_hi):
            if band is not None:
                self.model.ensure_theta_domain(hi)
            ev = make_grid_evaluator(self.model, band, device=self.device)
            self._grid_ev = ev
        return ev

    def grid_eval(self, time, gdlat, gdlon, gdalt, check_hull=True):
        """Dense-grid evaluation of one time through the float32 fast path
        (~5e-5 of the sup from __call__'s float64).  Returns a float32 numpy
        array shaped like gdlat."""
        return self.evaluate_records([time], gdlat, gdlon, gdalt,
                                     check_hull=check_hull)[0]

    def evaluate_records(self, times, gdlat, gdlon, gdalt, check_hull=True):
        """Evaluate the same grid for many times (keogram/volume products).

        times: sequence of datetimes.  Returns float32 [ntimes, *grid.shape]
        (an empty array for no times or an empty grid), a fresh array each
        call.  Records run in chunks (``copy_plan``) whose [chunk, npoints]
        float32 output stays <= CHUNK_BYTES on the device; each chunk is one
        kernel launch with the FoV mask fused (sphharmlag) or one pass of
        the RBF evaluator (radbasfun), and the next chunk is launched before
        this one comes to the host.  A CUDA chunk comes through the ring
        (``_stage``), a CPU chunk is stored as it is.  The ``grid_eval``
        phase's spans: ``grid_launch`` (the fold and the enqueue, a chunk),
        ``grid_to_host`` (waits on the kernel and the copies to the host)
        and ``grid_store`` (stores into the result)."""
        times = list(times)
        shape = np.shape(gdlat)
        npts = int(np.prod(shape))
        out = np.empty((len(times),) + shape, dtype=np.float32)
        if not times or npts == 0:
            return out
        g = self._prepare_grid(gdlat, gdlon, gdalt, need_hull=check_hull)
        ev = self._band_evaluator(g["band"])
        Cs = np.stack([np.asarray(self.get_C(t)[0], np.float64)
                       for t in times])
        flat = out.reshape(len(times), npts)
        inside = g["inside"] if check_hull else None

        def launch(rows):
            with span("grid_launch"):
                return ev.eval_records_flat(ev.fold_coeffs(Cs[rows]), g["lat"],
                                            g["lon"], g["alt"], inside)

        plan = copy_plan(len(times), npts)
        with self.timer.phase("grid_eval"):
            ahead = launch(plan[0][0])
            for k, (rows, pieces) in enumerate(plan):
                blk = ahead
                if k + 1 < len(plan):
                    ahead = launch(plan[k + 1][0])
                if blk.is_cuda:
                    self._stage(blk, flat[rows], pieces)
                    continue
                with span("grid_to_host"):  # the identity on a CPU output
                    host = blk.cpu()
                with span("grid_store"):
                    flat[rows] = host.numpy()
        return out

    def _stage(self, blk, dst, pieces):
        """Copy the contiguous CUDA chunk ``blk`` into the host array
        ``dst`` (as many elements, contiguous), piece by piece through the
        ring, piece j in slot j % STAGE_SLOTS: each piece's copy is queued
        on blk's stream into its slot with the slot's event after it; the
        host queues a copy into every free slot and waits on the oldest
        piece's event (``grid_to_host``), then stores that piece into
        ``dst`` on torch's intra-op threads (``grid_store``; the result's
        first-touch page faults spread over them) while the later pieces'
        copies run.  A slot is queued again only after its store has
        returned.  The ring is allocated at the first call and kept: no
        request pays a cudaHostAlloc."""
        global staged_slices, staged_bytes
        if self._ring is None:
            self._ring = [(torch.empty(STAGE_SLOT_BYTES // 4,
                                       dtype=torch.float32, pin_memory=True),
                           torch.cuda.Event())
                          for _ in range(STAGE_SLOTS)]
        ring = self._ring
        src = blk.reshape(-1)
        host = torch.from_numpy(dst.reshape(-1))
        stream = torch.cuda.current_stream(blk.device)
        queued = 0
        for i, sl in enumerate(pieces):
            buf, done = ring[i % len(ring)]
            with span("grid_to_host"):
                while queued < min(i + len(ring), len(pieces)):
                    qbuf, qdone = ring[queued % len(ring)]
                    q = pieces[queued]
                    qbuf[:q.stop - q.start].copy_(src[q], non_blocking=True)
                    qdone.record(stream)
                    queued += 1
                done.synchronize()
            with span("grid_store"):
                host[sl].copy_(buf[:sl.stop - sl.start])
        staged_slices += len(pieces)
        staged_bytes += src.numel() * src.element_size()
