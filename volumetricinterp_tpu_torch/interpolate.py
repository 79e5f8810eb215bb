"""Interpolate — the batched fit engine (public API parity with the
reference class of the same name, interpolate.py:16-708, and the JAX
package's Interpolate).

The day runs as a plain loop over record chunks: each chunk is fitted in
float64 on ``device`` (ops/fit.py: masked sufficient statistics, the
regularization search, the cutoff solve), copied to the host and, when an
output file is configured, flushed to it (io.coeffs.IncrementalCoeffWriter)
so an interrupted run leaves a valid checkpoint; ``saveh5`` then finalizes
the file in place.  Options of the JAX package's fit, in the same places:
REGULARIZATION_PROFILE (a Chapman-profile tau pull, ``_reg_taus``),
TIME_COUPLING (a joint re-solve of the day, ops/timejoint.py) and
TIME_SMOOTHING (a time spline of the coefficients, ops/timesmooth.py,
stored under /TimeFit); ``calc_coeffs_multiparam`` fits several parameters
in one record stream.  In a torch.distributed world of several processes,
or when [TPU] MESH_RECORDS / MESH_POINTS ask for more than one, each chunk
is fitted by parallel/fit.fit_records_sharded instead (records over the
mesh's rows, points over a row's processes), every process holds the
results and process 0 writes the file.

Attribute parity: configfile, regularization_list, reg_method, filename,
outputfilename, param, errlim, chi2lim, goodfitcode, model_name, model,
hull_vert, time, Coeffs, Covariance, chi_sq, reg_params.
"""

from __future__ import annotations

import contextlib
import datetime as dt
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .config import Config
from .constants import RE
from . import models
from .io.amisr import read_datafile
from .io.coeffs import (IncrementalCoeffWriter, finalize_checkpoint,
                        save_coeff_file)
from .ops.fit import atwa_eig, fit_records, prepare_chunk, reg_mats_eig
from .ops import regparam as regparam_mod
from .ops.solve import cutoff_chi2, sym_pinv_apply
from .utils.device import check_device
from .utils.hull import compute_hull_vertices
from .utils.logging import (PhaseTimer, carry, fit_quality_report, logger,
                            span)


class Interpolate:
    def __init__(self, config_file, device="cuda"):
        """config_file: a Config, a path, an open file or INI text.
        device: where the fit runs ('cuda' or 'cpu'; no fallback)."""
        self.device = check_device(device)
        if isinstance(config_file, Config):
            self.config = config_file
            self.configfile = self.config.path or ""
        else:
            self.configfile = config_file if isinstance(config_file, str) else ""
            self.config = Config.from_file(config_file)
        self.read_config(self.config)
        self.model = models.make_model(self.model_name, self.config)
        self.timer = PhaseTimer()
        self.reg_params = None

    def read_config(self, config):
        """Populate reference-parity attributes (interpolate.py:64-88)."""
        if not isinstance(config, Config):
            config = Config.from_file(config)
            self.config = config
        f = config.fit
        self.regularization_list = list(f.regularization_list)
        self.reg_method = f.regularization_method
        self.filename = f.filename
        self.outputfilename = f.outputfilename
        self.param = f.param
        self.errlim = list(f.errlim)
        self.chi2lim = list(f.chi2lim)
        self.goodfitcode = list(f.goodfitcode)
        self.model_name = config.model.name

    # ------------------------------------------------------------------
    # reference-parity numerical methods (library surface), on self.device
    # ------------------------------------------------------------------

    def _record(self, A, b, W):
        """One record's (A, b, W, mask) as float64 tensors on self.device,
        b and W flat, mask = finite b, and its weighted statistics (AtWA,
        AtWb, btWb, N): masked points count nothing (solve.py:99-112)."""
        A, b, W = (torch.as_tensor(x, dtype=torch.float64,
                                   device=self.device) for x in (A, b, W))
        b, W = b.reshape(-1), W.reshape(-1)
        mask = torch.isfinite(b)
        Wm = torch.where(mask, W, torch.zeros_like(W))
        bm = torch.where(mask, b, torch.zeros_like(b))
        Aw = A * Wm[:, None]
        stats = (A.T @ Aw, Aw.T @ bm, (Wm * bm * bm).sum(),
                 mask.sum().to(A.dtype))
        return (A, b, Wm, mask), stats

    def _reg_matrix(self, reg_matrices, name):
        return torch.as_tensor(reg_matrices[name], dtype=torch.float64,
                               device=self.device)

    def eval_C(self, A, b, W, reg_matrices, reg_params, calccov=False):
        """Coefficients (and with calccov their covariance) of one record
        at the given alphas (reference interpolate.py:432-469, dict-style
        regularization arguments): X = AtWA + sum alpha R, C by the gelsd
        cutoff solve, dC = pinv(X) AtWA pinv(X).  Tensors on self.device."""
        _, (AtWA, AtWb, _, _) = self._record(A, b, W)
        X = AtWA
        for name in self.regularization_list:
            X = X + float(reg_params[name]) * self._reg_matrix(reg_matrices,
                                                               name)
        C, H = sym_pinv_apply(X, AtWb)
        if calccov:
            return C, H @ AtWA @ H
        return C

    def find_reg_param(self, A, b, W, reg_matrices, method=None):
        """Regularization parameter of one record for each regularization,
        the others at zero (reference interpolate.py:97-147): a dict of
        Python floats.  'chi2' is the exact chi2 = nu search (0.0 for the
        too-smooth outcome), 'gcv' the exact leave-one-out search, 'manual'
        the reference's constants, 'prompt' asks on stdin; NaN, with the
        reference's warning, where the search fails."""
        if method is None:
            method = "chi2"
        (A_t, b_t, Wm, mask), (AtWA, AtWb, btWb, N) = self._record(A, b, W)
        eigA = None
        out = {}
        for name in self.regularization_list:
            if method == "chi2":
                R = self._reg_matrix(reg_matrices, name)
                if eigA is None:
                    eigA = atwa_eig(AtWA[None])
                VR, sR = reg_mats_eig(R[None])
                root = float(regparam_mod.chi2_reg_param(
                    AtWA[None], AtWb[None], btWb[None], N[None], R, eigA,
                    (VR[0], sR[0]))[0])
                out[name] = 10.0 ** root if np.isfinite(root) else (
                    0.0 if root == -np.inf else np.nan)
            elif method == "gcv":
                root = float(regparam_mod.gcv_reg_param(
                    AtWA, AtWb, self._reg_matrix(reg_matrices, name), A_t,
                    b_t, Wm, mask))
                out[name] = 10.0 ** root if np.isfinite(root) else np.nan
            elif method == "manual":
                out[name] = regparam_mod.manual_reg_param(name)
            elif method == "prompt":
                out[name] = float(input(f"Enter {name} regularization parameter: "))
            else:
                raise ValueError(f"unknown regularization method {method!r}")
            if np.isnan(out[name]):
                logger.warning(
                    "Could not find any roots to the objective function "
                    "chi^2-nu in the range (1e-100,1). Returning NANs for "
                    "regularization parameters."
                )
        return out

    # the reference's per-method entry points (interpolate.py:152,263,353,
    # 383), through find_reg_param
    def chi2(self, A, b, W, reg_matrices, reg):
        return self.find_reg_param(A, b, W, reg_matrices, method="chi2")[reg]

    def gcv(self, A, b, W, reg_matrices, reg):
        return self.find_reg_param(A, b, W, reg_matrices, method="gcv")[reg]

    def manual(self, A, b, W, reg_matrices, reg):
        return regparam_mod.manual_reg_param(reg)

    def prompt(self, A, b, W, reg_matrices, reg):
        return float(input(f"Enter {reg} regularization parameter: "))

    def chi2objfunct(self, alpha, A, b, W, reg_matrices, nu, reg):
        """chi^2(10^alpha) - nu of one record with only ``reg``
        regularized, under the reference's cutoff solve
        (interpolate.py:220-261); a Python float."""
        _, (AtWA, AtWb, btWb, _) = self._record(A, b, W)
        R = self._reg_matrix(reg_matrices, reg)
        return float(cutoff_chi2(10.0**alpha, AtWA, AtWb, btWb, R)) - nu

    def compute_hull(self, lat, lon, alt):
        """Reference interpolate.py:409-426; sets self.hull_vert."""
        self.hull_vert = compute_hull_vertices(lat, lon, alt)

    def read_datafile(self, filename):
        """Reference interpolate.py:582-667."""
        return read_datafile(
            filename, self.param, self.errlim, self.chi2lim, self.goodfitcode
        )

    # ------------------------------------------------------------------
    # the batched fit
    # ------------------------------------------------------------------

    def _reg_matrices(self):
        # memoized: the matrices depend only on the model config
        cached = getattr(self, "_reg_matrices_cache", None)
        if cached is not None:
            return cached
        reg_matricies = {}
        for reg in self.regularization_list:
            try:
                reg_matricies[reg] = np.asarray(
                    self.model.eval_reg_matricies[reg]()
                )
            except KeyError as e:
                # message parity with interpolate.py:490-493
                logger.warning(
                    "The model %s does not support %s regularization! "
                    "If you would like to use %s regularization, please "
                    "modify %s.py so that it includes functions to calculate "
                    "the appropriate regularization matrix.",
                    self.model_name, reg, reg, self.model_name,
                )
                raise e
        self._reg_matrices_cache = reg_matricies
        return reg_matricies

    def _reg_taus(self, names, nb):
        """Tau vectors [nreg, nb] of [DEFAULT] REGULARIZATION_PROFILE, or
        None (volumetricinterp_tpu/interpolate.py:197-237).

        "chapman,<nmax>,<hmax_km>,<scale_km>" is the Chapman-layer density
        n(z) = nmax exp(0.5 (1 - y - e^-y)), y = (z - z0)/H in the model's
        scaled altitude z = 100 alt/RE; every '0thorder'-regularized
        parameter is pulled toward it (penalty alpha (C'Psi C - 2 tau'C),
        tau from Model.eval_tau).  Rows of other regularization types are
        zero."""
        spec = self.config.fit.regularization_profile.strip()
        if not spec or not names:
            return None
        kind, *params = [p.strip() for p in spec.split(",")]
        if kind.lower() != "chapman":
            raise ValueError(
                f"unknown REGULARIZATION_PROFILE kind {kind!r} "
                "(supported: chapman,<nmax>,<hmax_km>,<scale_km>)")
        nmax, hmax_km, scale_km = (float(p) for p in params)
        z0 = 100.0 * hmax_km * 1000.0 / RE
        hz = 100.0 * scale_km * 1000.0 / RE

        def profile(z):
            y = (np.asarray(z) - z0) / hz
            return nmax * np.exp(0.5 * (1.0 - y - np.exp(-y)))

        if "0thorder" not in names:
            logger.warning(
                "REGULARIZATION_PROFILE is set but '0thorder' is not in "
                "REGULARIZATION_LIST; the profile pull only applies to "
                "0thorder regularization and will be ignored.")
            return None
        tau_vec = np.asarray(self.model.eval_tau(profile)).reshape(-1)
        taus = np.zeros((len(names), nb))
        for i, r in enumerate(names):
            if r == "0thorder":
                taus[i] = tau_vec
        return taus

    def _fit_setup(self):
        """The regularization matrices [nreg, nb, nb], their tau vectors
        (or None), the method and the manual alphas of a fit."""
        with self.timer.phase("reg_matrices"):
            logger.info(
                "Evaluating Regularization matricies.  This may take a few minutes."
            )
            reg_mats_dict = self._reg_matrices()
            names = self.regularization_list
            nb = self.model.nbasis
            reg_mats = (np.stack([reg_mats_dict[r] for r in names]) if names
                        else np.zeros((0, nb, nb)))
            reg_taus = self._reg_taus(names, nb)
        return (reg_mats, reg_taus) + self._resolve_method(names)

    @staticmethod
    def _window(starttime, endtime, utime, *per_record):
        """The records inside [starttime, endtime] (both given), else all:
        (utime, *per_record) sliced."""
        if not (starttime and endtime):
            return (utime,) + per_record
        epoch = dt.datetime(1970, 1, 1)  # naive UTC
        idx = np.argwhere(
            (utime[:, 0] >= (starttime - epoch).total_seconds())
            & (utime[:, 1] <= (endtime - epoch).total_seconds())
        ).flatten()
        return (utime[idx, :],) + tuple(a[idx] for a in per_record)

    def calc_coeffs(self, starttime=None, endtime=None, resume=False):
        """Fit every record in the file (optionally a time window), batched
        in record chunks (reference flow, interpolate.py:472-579).  With
        resume=True and an existing partial output file, completed chunks
        are skipped; only a one-process run resumes (process 0 alone holds
        the file, so the others could not know where to start)."""
        from .parallel.mesh import world

        if resume and world()[1] > 1:
            raise ValueError("resume=True needs a one-process run: in a "
                             "torch.distributed world only process 0 holds "
                             "the output file")
        reg_mats, reg_taus, method, manual_params = self._fit_setup()
        names = self.regularization_list

        with self.timer.phase("read_datafile"):
            utime, lat, lon, alt, value, error = self.read_datafile(self.filename)

        with self.timer.phase("compute_hull"):
            self.compute_hull(lat, lon, alt)

        utime, value, error = self._window(starttime, endtime, utime, value,
                                           error)
        nrec = value.shape[0]

        with self.timer.phase("design_matrix"):
            # basis() widens the Legendre tables to the data's colatitudes
            A = self.model.basis(lat, lon, alt)

        writer = None
        start0 = 0
        self._flushed_output = None
        if self.outputfilename and _is_writer():
            # per-chunk flush whenever an output file is configured: the run
            # is checkpointed, and saveh5() becomes a metadata-only finalize
            writer = self._make_writer(nrec, fresh=not resume)
            if resume:
                start0 = writer.nrec_done
                if start0:
                    logger.info("resuming at record %d / %d", start0, nrec)
        try:
            C_all, dC_all, c2_all, rp_all = self._run_fit_pipeline(
                value, error, A, reg_mats, reg_taus, method, manual_params,
                utime, writer=writer, start0=start0)
        finally:
            if writer is not None:
                writer.close()
        if writer is not None:
            self._flushed_output = self.outputfilename

        self.time = utime
        self.Coeffs = C_all
        self.Covariance = dC_all
        self.chi_sq = c2_all
        self.reg_params = rp_all

        if self.config.fit.time_coupling:
            # the day re-solved jointly at the searched alphas
            # (ops/timejoint.py): Coeffs and chi_sq change; the covariance
            # keeps the independent fits' error bars
            with self.timer.phase("time_coupled_solve"):
                from .ops.timejoint import fit_time_coupled

                with np.errstate(divide="ignore"):
                    la = np.log10(np.where(rp_all > 0, rp_all, 0.0))
                C_j, c2_j = fit_time_coupled(
                    value, error, A, reg_mats, la,
                    self.config.fit.time_coupling, device=self.device)
                n_filled = int((np.isnan(c2_all) & np.isfinite(c2_j)).sum())
                self.Coeffs = C_j
                self.chi_sq = c2_j
                logger.info(
                    "time-coupled solve: beta_rel=%.3g, %d failed records "
                    "carried by neighbors", self.config.fit.time_coupling,
                    n_filled)
                # the flushed file holds the independent coefficients:
                # saveh5 rewrites it with the joint ones
                self._flushed_output = None

        self.timefit = None
        if self.config.fit.time_smoothing:
            with self.timer.phase("time_spline"):
                from .ops.timesmooth import fit_time_spline

                lam = self.config.fit.time_smoothing
                if lam != "gcv":
                    lam = float(lam)
                self.timefit = fit_time_spline(
                    np.mean(utime, axis=1), C_all, lam=lam,
                    nseg=self.config.fit.time_knots or None)
                logger.info("time spline: lam=%.3g, K=%d",
                            self.timefit["lam"], self.timefit["S"].shape[0])

        nvalid = np.isfinite(value).sum(axis=1)
        fit_quality_report(c2_all, nvalid, rp_all, names)

    def _resolve_method(self, names):
        """Reference method dispatch incl. the py3 prompt fix
        (interpolate.py:383-407: asked once per regularization type)."""
        method = self.reg_method
        manual_params = None
        if method == "manual":
            manual_params = [regparam_mod.manual_reg_param(r) for r in names]
        elif method == "prompt":
            manual_params = [
                float(input("Enter {} regularization parameter: ".format(r)))
                for r in names
            ]
            method = "manual"
        return method, manual_params

    def _run_fit_pipeline(self, value, error, A_np, reg_mats, reg_taus,
                          method, manual_params, utime, writer=None,
                          start0=0):
        """Fit record chunks of ``chunk_size`` (default min(nrec, 128))
        records in turn; returns host (C_all, dC_all, c2_all, rp_all).

        Each chunk's first step (ops/fit.prepare_chunk: its statistics and
        the host LAPACK decompositions that depend on them alone: AtWA's,
        the 'fast' pencils, the 'exact' search's start and seed anchor)
        runs one chunk ahead on a worker thread and, on the card, a side
        stream, so that it overlaps the search of the chunk before; the
        two threads' host_eigh calls each have their own pool of host
        threads (ops/solve.py).

        Inside ``fit_records`` the main thread's spans are
        ``lookahead_wait`` (its wait for the worker), ``search_solve``
        (fit_records from the prepared chunk to its results),
        ``device_wait`` (the stream's synchronize; zero length off the
        card) and ``copy_to_host``; the worker's is ``prepare_chunk``, a
        child of ``fit_records`` (utils/logging.carry)."""
        names = self.regularization_list
        nrec = value.shape[0]
        nb = self.model.nbasis
        chunk = self.config.tpu.chunk_size or min(nrec, 128) or 1

        C_all = np.zeros((nrec, nb))
        dC_all = np.empty((nrec, nb, nb))  # every row is assigned below
        c2_all = np.zeros(nrec)
        rp_all = np.zeros((nrec, len(names)))
        if writer is not None and start0 > 0:
            C_all[:start0] = writer.f["Coeffs/C"][:start0]
            dC_all[:start0] = writer.f["Coeffs/dC"][:start0]
            c2_all[:start0] = writer.f["FitParams/chi2"][:start0]
            if names:
                rp_all[:start0] = writer.f["FitParams/reg_params"][:start0]

        mesh = self._mesh()

        def finish(s, e, res):
            with span("device_wait"):  # the chunk's device work, not its copy
                if res[1].is_cuda:
                    torch.cuda.current_stream(res[1].device).synchronize()
            with self.timer.phase("copy_to_host"):
                C_all[s:e], dC_all[s:e], c2_all[s:e], rp_all[s:e] = (
                    t.cpu().numpy() for t in res)
            if writer is not None:
                writer.write_chunk(s, utime[s:e], C_all[s:e], dC_all[s:e],
                                   c2_all[s:e], rp_all[s:e])

        with self.timer.phase("fit_records"):
            # fit-constant inputs go to the device once
            A_d = torch.as_tensor(A_np, dtype=torch.float64, device=self.device)
            R_d = torch.as_tensor(reg_mats, dtype=torch.float64,
                                  device=self.device)
            mode = self.config.tpu.regparam_mode
            # R's eigenbases (the exact searches' alpha = 1 side) once a run
            reg_eig = (reg_mats_eig(R_d) if len(names) and mode == "exact"
                       and method in ("chi2", "gcv") else None)
            starts = list(range(start0, nrec, chunk))
            if mesh is not None:
                # records over the mesh's rows, points over a row's ranks
                from .parallel.fit import fit_records_sharded

                for s in starts:
                    e = min(s + chunk, nrec)
                    finish(s, e, fit_records_sharded(
                        value[s:e], error[s:e], A_d, R_d, mesh, method=method,
                        manual_params=manual_params, regparam_mode=mode,
                        reg_taus=reg_taus, device=self.device,
                        reg_eig=reg_eig))
                return C_all, dC_all, c2_all, rp_all
            cuda = self.device.type == "cuda"
            side = torch.cuda.Stream(self.device) if cuda else None
            if cuda:
                side.wait_stream(torch.cuda.current_stream(self.device))

            def stage(s, e):
                with self.timer.phase("prepare_chunk"), (
                        torch.cuda.stream(side) if cuda
                        else contextlib.nullcontext()):
                    p = prepare_chunk(value[s:e], error[s:e], A_d, R_d,
                                      method, mode, self.device, reg_eig,
                                      reg_taus)
                    if cuda:
                        p["event"] = side.record_event()
                return p

            stage = carry(stage)
            with ThreadPoolExecutor(1) as pool:
                ahead = (pool.submit(stage, starts[0], min(starts[0] + chunk,
                                                           nrec))
                         if starts else None)
                for i, s in enumerate(starts):
                    e = min(s + chunk, nrec)
                    with span("lookahead_wait"):
                        prepared = ahead.result()
                    if i + 1 < len(starts):
                        s2 = starts[i + 1]
                        ahead = pool.submit(stage, s2, min(s2 + chunk, nrec))
                    with span("search_solve"):
                        if cuda:
                            main = torch.cuda.current_stream(self.device)
                            main.wait_event(prepared.pop("event"))
                            for t in _tensors(prepared):
                                t.record_stream(main)
                        res = fit_records(
                            value[s:e], error[s:e], A_d, R_d, method=method,
                            manual_params=manual_params, regparam_mode=mode,
                            device=self.device, reg_eig=reg_eig,
                            reg_taus=reg_taus, prepared=prepared)
                    finish(s, e, res)
        return C_all, dC_all, c2_all, rp_all

    def _mesh(self):
        """The (records, points) mesh of a sharded fit, or None for the
        plain one-process fit: sharded when the torch.distributed world has
        more than one process or [TPU] MESH_RECORDS / MESH_POINTS ask for
        more than one (a layout larger than the world raises)."""
        from .parallel.mesh import world

        tpu = self.config.tpu
        if world()[1] > 1 or tpu.mesh_records > 1 or tpu.mesh_points > 1:
            from .parallel.distributed import make_global_mesh

            return make_global_mesh(tpu.mesh_records, tpu.mesh_points)
        return None

    def calc_coeffs_multiparam(self, params, starttime=None, endtime=None):
        """Fits of several parameters (e.g. ['dens', 'temp_e']) in one
        record stream (volumetricinterp_tpu/interpolate.py:648-738): one
        read per parameter, one hull, design matrix and set of
        regularization matrices, and the k * nrec records through one chunk
        loop of fit_records.  Writes one coefficient file per parameter
        (OUTPUTFILENAME with a `.{param}` suffix before the extension) and
        returns {param: (time, Coeffs, Covariance, chi_sq)}."""
        base_param, base_out = self.param, self.outputfilename
        root, ext = os.path.splitext(base_out)
        try:
            reg_mats, reg_taus, method, manual_params = self._fit_setup()
            names = self.regularization_list
            vals, errs = [], []
            with self.timer.phase("read_datafile"):
                for prm in params:
                    self.param = prm
                    utime, lat, lon, alt, v, e = self.read_datafile(
                        self.filename)
                    vals.append(v)
                    errs.append(e)
            with self.timer.phase("compute_hull"):
                self.compute_hull(lat, lon, alt)
            k = len(params)
            utime, *ve = self._window(starttime, endtime, utime, *vals, *errs)
            vals, errs = ve[:k], ve[k:]
            nrec = vals[0].shape[0]
            with self.timer.phase("design_matrix"):
                A = self.model.basis(lat, lon, alt)

            self._flushed_output = None
            C, dC, c2, rp = self._run_fit_pipeline(
                np.concatenate(vals), np.concatenate(errs), A, reg_mats,
                reg_taus, method, manual_params, np.concatenate([utime] * k))

            results = {}
            for i, prm in enumerate(params):
                sl = slice(i * nrec, (i + 1) * nrec)
                self.param = prm
                self.outputfilename = f"{root}.{prm}{ext}"
                self.time = utime
                self.Coeffs, self.Covariance = C[sl], dC[sl]
                self.chi_sq, self.reg_params = c2[sl], rp[sl]
                self.timefit = None
                self.saveh5()
                fit_quality_report(c2[sl], np.isfinite(vals[i]).sum(axis=1),
                                   rp[sl], names)
                results[prm] = (self.time, self.Coeffs, self.Covariance,
                                self.chi_sq)
        finally:
            self.param, self.outputfilename = base_param, base_out
        return results

    def _make_writer(self, nrec, fresh=False):
        meta = dict(
            reg_list=self.regularization_list,
            reg_method=self.reg_method,
            hull_vert=self.hull_vert,
            raw_filename=self.filename,
            config_name=os.path.basename(self.configfile) if self.configfile else "",
            config_path=(
                os.path.dirname(os.path.abspath(self.configfile))
                if self.configfile else ""
            ),
            config_contents=self.config.raw_text,
        )
        return IncrementalCoeffWriter(
            self.outputfilename, nrec, self.model.nbasis, meta, fresh=fresh
        )

    def saveh5(self):
        """Write the coefficient file (reference interpolate.py:671-708).

        When calc_coeffs already flushed this run chunk by chunk to
        OUTPUTFILENAME, the datasets are on disk and this finalizes the
        schema in place (drops the checkpoint counter); otherwise it writes
        the whole file.  Mutating Coeffs/Covariance between calc_coeffs and
        saveh5 voids the in-place path: set self._flushed_output = None
        first to force a full rewrite."""
        if not _is_writer():
            return  # every process holds the results; process 0 writes
        timefit = getattr(self, "timefit", None)
        if getattr(self, "_flushed_output", None) == self.outputfilename \
                and self.outputfilename:
            finalize_checkpoint(self.outputfilename, timefit=timefit)
            return
        name = os.path.basename(self.configfile) if self.configfile else ""
        path = (
            os.path.dirname(os.path.abspath(self.configfile))
            if self.configfile else ""
        )
        save_coeff_file(
            self.outputfilename,
            self.time,
            self.Coeffs,
            self.Covariance,
            self.chi_sq,
            self.hull_vert,
            self.regularization_list,
            self.reg_method,
            self.filename,
            name,
            path,
            self.config.raw_text,
            reg_params=self.reg_params,
            timefit=timefit,
        )


def _is_writer():
    """Whether this process writes the output file: process 0 of a
    torch.distributed world, or the only process."""
    from .parallel.mesh import world

    return world()[0] == 0


def _tensors(tree):
    """Every tensor in a nest of dicts, tuples and lists."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
