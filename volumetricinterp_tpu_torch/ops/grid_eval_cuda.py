"""The grid-evaluation kernel's launcher, its build, and its plain twin.

``eval_records`` evaluates one point set with a batch of records' folded
coefficients.  On CUDA tensors it launches the hand-written Hopper kernel
``csrc/grid_eval.cu`` (which replaces the TPU kernel
volumetricinterp_tpu/ops/grid_eval_pallas.py::_kernel) and raises if the
kernel cannot be built or launched; on CPU tensors it runs
``eval_records_plain``, the same maths in plain torch.  ``launches`` counts
kernel launches, so a run can show that it went through the kernel.

The kernel reads its tables in a packed layout made here (``pack_coef``,
``pack_ceff``): rows of four floats, zero-padded, so that it loads them as
16-byte shared-memory broadcasts.  ``kernel_config`` picks the
instantiation (maxl, maxk rounded up to 4, points per thread) and
``record_chunks`` splits the records into launches by the shared-memory
budget.  The kernel takes all of these from here: the instantiation as
``-D`` defines, each launch's shared-memory size as an argument.  Each
instantiation is compiled by ``nvcc`` into ``_build/`` beside the package
at its first use (keyed by the instantiation and a hash of the source and
flags), with the compiler's log beside it, and loaded with ctypes; nothing
is compiled at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..coords import geodetic_to_cap

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "grid_eval.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v"]
# compile-time caps of the kernel (csrc/grid_eval.cu)
MAX_L = 10
MAX_K = 16
MAX_DEGREE = 256
THREADS = 256  # threads per block
# shared memory a launch's tables may take: two blocks fit on an SM
SMEM_BUDGET = 96 * 1024

launches = 0  # kernel launches by eval_records
_libs = {}  # KernelConfig -> loaded library


def _ceil4(n):
    return -(-n // 4) * 4


@dataclass(frozen=True)
class KernelConfig:
    """One instantiation of the kernel."""

    maxl: int
    maxkb: int  # Laguerre rows: maxk rounded up to 4
    pt: int  # consecutive points per thread

    @property
    def npairs(self):
        return self.maxl * (self.maxl + 1) // 2

    @property
    def npp(self):  # coef row stride
        return _ceil4(self.npairs)

    @property
    def live(self):
        """Registers a point holds through the record loop: Pc, Ps and the
        Laguerre rows."""
        return 2 * self.npairs - self.maxl + self.maxkb

    @property
    def minblocks(self):
        """Blocks an SM the launch bounds ask for: two (128 registers a
        thread) while PT points' live state fits, else one (no spills)."""
        return 2 if self.pt * self.live <= 96 else 1

    def smem_bytes(self, degree, nrec):
        return 4 * (degree * self.npp + nrec * 2 * self.npairs * self.maxkb)


def kernel_config(maxl, maxk):
    """The instantiation for a model order: two points a thread while
    their live state (``KernelConfig.live``) stays well inside the 128
    registers a thread has at two blocks of 256 threads an SM, else one."""
    cfg = KernelConfig(maxl, _ceil4(maxk), 1)
    return KernelConfig(maxl, cfg.maxkb, 2 if cfg.live <= 48 else 1)


def pack_coef(coef, pair_degree):
    """[degree, npairs] band coefficients -> [degree, ceil4(npairs)]: zero
    above each pair's own degree and in the padding columns."""
    degree, npairs = coef.shape
    deg = torch.as_tensor(np.asarray(pair_degree), device=coef.device)
    keep = torch.arange(degree, device=coef.device)[:, None] < deg[None, :]
    out = coef.new_zeros((degree, _ceil4(npairs)))
    out[:, :npairs] = torch.where(keep, coef, torch.zeros_like(coef))
    return out


def pack_ceff(ceff):
    """[nrec, 2, npairs, maxk] -> [nrec, 2, npairs, ceil4(maxk)], zero-padded
    and 16-byte aligned (a copy unless ``ceff`` already is both)."""
    maxk = ceff.shape[-1]
    if maxk % 4 == 0 and ceff.data_ptr() % 16 == 0:
        return ceff
    return torch.nn.functional.pad(ceff, (0, _ceil4(maxk) - maxk))


def record_chunks(cfg, degree, nrec):
    """(first record, count) of each launch: as many records as the
    shared-memory budget holds beside the coef table, at least one."""
    per = max(1, (SMEM_BUDGET - cfg.smem_bytes(degree, 0))
              // cfg.smem_bytes(0, 1))
    return [(r0, min(per, nrec - r0)) for r0 in range(0, nrec, per)]


def vector_ok(cfg, npts, *tensors):
    """Whether the kernel may move PT points with one vector access:
    npts a multiple of PT and every point/output base PT-float aligned."""
    align = 4 * cfg.pt
    return npts % cfg.pt == 0 and all(t.data_ptr() % align == 0
                                      for t in tensors)


def build(cfg):
    """Compile the instantiation ``cfg`` (unless this source is already
    built for it) and load it.

    Returns {"config", "path", "seconds", "log"}: the instantiation, the
    shared library, the compile time (0.0 when it was already built) and
    the path of the compiler's log, written beside the library."""
    flags = NVCC_FLAGS + defines(cfg)
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    so = BUILD_DIR / (f"grid_eval_l{cfg.maxl}_k{cfg.maxkb}_p{cfg.pt}_"
                      f"{digest}.so")
    log = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        seconds, text = nvcc(flags, SOURCE, so)
        log.write_text(text)
    lib = bind(so)
    got = (ctypes.c_int * 5)()
    lib.vi_grid_eval_config(ctypes.addressof(got))
    if tuple(got) != (cfg.maxl, cfg.maxkb, cfg.pt, THREADS, cfg.minblocks):
        raise RuntimeError(f"{so} holds instantiation {tuple(got)}, not {cfg}")
    _libs[cfg] = lib
    return {"config": cfg, "path": str(so), "seconds": seconds,
            "log": str(log)}


def defines(cfg):
    return [f"-DVI_MAXL={cfg.maxl}", f"-DVI_MAXKB={cfg.maxkb}",
            f"-DVI_PT={cfg.pt}", f"-DVI_THREADS={THREADS}",
            f"-DVI_MINBLOCKS={cfg.minblocks}"]


def nvcc(flags, source, so):
    """Compile ``source`` into the shared library ``so``; returns (seconds,
    the compiler's output)."""
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    so.parent.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    res = subprocess.run([exe, *flags, "-o", str(tmp), str(source)],
                         capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source} ({flags}):\n{log}")
    os.replace(tmp, so)
    return seconds, log


def bind(so):
    """Load a built library and declare its C interface."""
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vi_grid_eval_records.argtypes = [
        P, P, P, P, P, P, P, ctypes.c_longlong, I, I, I,
        F, F, F, F, F, F, ctypes.c_longlong, P]
    lib.vi_grid_eval_records.restype = I
    lib.vi_grid_eval_config.argtypes = [P]
    lib.vi_grid_eval_config.restype = None
    lib.vi_cuda_error_string.argtypes = [I]
    lib.vi_cuda_error_string.restype = ctypes.c_char_p
    return lib


def band_constants(ev, dtype):
    """(center, 1/half-width) of the evaluator's colatitude band, formed in
    the working precision exactly as the kernel receives them."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    lo, hi = npdt(ev.theta_lo), npdt(ev.theta_hi)
    half = (hi - lo) * npdt(0.5)
    return float(lo + half), float(npdt(1.0) / half)


def eval_records_plain(lat, lon, alt, ceff, ev, inside=None, chunk=1 << 20):
    """Plain torch twin of the kernel, in the dtype of ``lat``.

    lat/lon/alt: [npts]; ceff: [nrec, 2, npairs, maxk] (GridEvaluator.
    fold_coeffs); inside: optional bool [npts].  Returns [nrec, npts].
    Same maths as the kernel (fused transform, pair series at each pair's
    own degree, radial contraction, e^{-z/2}); float64 inputs give the
    float64 reference of the float32 kernel."""
    dt, dev = lat.dtype, lat.device
    nrec, npts = ceff.shape[0], lat.shape[0]
    center, inv_half = band_constants(ev, dt)
    coef = torch.as_tensor(ev.table.coef, dtype=dt, device=dev)  # [D, npairs]
    deg = torch.as_tensor(ev.pair_degree, device=dev)
    coef = torch.where(torch.arange(coef.shape[0], device=dev)[:, None]
                       < deg[None, :], coef, torch.zeros_like(coef))
    mbar = torch.as_tensor(ev.mbar_pair, device=dev)
    out = torch.empty((nrec, npts), dtype=dt, device=dev)
    for s in range(0, npts, chunk):
        sl = slice(s, s + chunk)
        z, theta, c1, s1 = geodetic_to_cap(lat[sl], lon[sl], alt[sl], ev.rot)
        u_raw = (theta - center) * inv_half
        u = torch.clamp(u_raw, -1.0, 1.0)
        T = [torch.ones_like(u), u]
        for _ in range(2, coef.shape[0]):
            T.append(2.0 * u * T[-1] - T[-2])
        P = torch.stack(T[:coef.shape[0]], dim=-1) @ coef  # [n, npairs]
        cosm, sinm = [torch.ones_like(c1), c1], [torch.zeros_like(s1), s1]
        for _ in range(2, ev.maxl):
            cosm.append(2.0 * c1 * cosm[-1] - cosm[-2])
            sinm.append(2.0 * c1 * sinm[-1] - sinm[-2])
        cos_p = torch.stack(cosm, dim=-1)[:, mbar]
        sin_p = torch.stack(sinm, dim=-1)[:, mbar]
        lag = [torch.ones_like(z), 1.0 - z]
        for kk in range(1, ev.maxk - 1):
            lag.append(((2 * kk + 1 - z) * lag[kk] - kk * lag[kk - 1])
                       * (1.0 / (kk + 1.0)))
        lag = torch.stack(lag[:ev.maxk], dim=-1)  # [n, maxk]
        ez = torch.exp(-0.5 * z)
        nan = (u_raw.abs() > 1.0 + 1e-4)
        if inside is not None:
            nan = nan | ~inside[sl]
        for r in range(nrec):
            Rc = lag @ ceff[r, 0].T
            Rs = lag @ ceff[r, 1].T
            o = (P * (cos_p * Rc + sin_p * Rs)).sum(-1) * ez
            out[r, sl] = torch.where(nan, float("nan"), o)
    return out


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"grid_eval kernel: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def eval_records(lat, lon, alt, ceff, ev, inside=None):
    """Evaluate [nrec, npts] = records ``ceff`` at the points lat/lon/alt.

    CUDA tensors launch the kernel (float32 only), once per record chunk
    (``record_chunks``), or raise; CPU tensors run ``eval_records_plain``."""
    global launches
    dev = lat.device
    if dev.type == "cpu":
        return eval_records_plain(lat, lon, alt, ceff, ev, inside)
    if dev.type != "cuda":
        raise ValueError(f"grid_eval: unsupported device {dev}")
    npts, nrec = lat.shape[0], ceff.shape[0]
    npairs = ev.maxl * (ev.maxl + 1) // 2
    if not (1 <= ev.maxl <= MAX_L and 1 <= ev.maxk <= MAX_K
            and 1 <= ev.degree <= MAX_DEGREE):
        raise ValueError(
            f"grid_eval kernel caps: maxl <= {MAX_L}, maxk <= {MAX_K}, "
            f"degree <= {MAX_DEGREE}; got maxl={ev.maxl}, maxk={ev.maxk}, "
            f"degree={ev.degree}")
    cfg = kernel_config(ev.maxl, ev.maxk)
    for name, t in (("lat", lat), ("lon", lon), ("alt", alt)):
        _check(name, t, torch.float32, (npts,), dev)
    _check("ceff", ceff, torch.float32, (nrec, 2, npairs, ev.maxk), dev)
    coef = ev.coef_packed
    _check("packed coef", coef, torch.float32, (ev.degree, cfg.npp), dev)
    if inside is not None:
        _check("inside", inside, torch.bool, (npts,), dev)
        inside = inside.view(torch.uint8)
    out = torch.empty((nrec, npts), dtype=torch.float32, device=dev)
    if npts == 0 or nrec == 0:
        return out
    if cfg not in _libs:
        build(cfg)
    lib = _libs[cfg]
    ceff = pack_ceff(ceff)
    vec = vector_ok(cfg, npts, lat, lon, alt, out)
    center, inv_half = band_constants(ev, torch.float32)
    kx, ky, ct0, st0 = ev.rot
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for r0, n in record_chunks(cfg, ev.degree, nrec):
            rc = lib.vi_grid_eval_records(
                lat.data_ptr(), lon.data_ptr(), alt.data_ptr(),
                None if inside is None else inside.data_ptr(),
                coef.data_ptr(), ceff[r0].data_ptr(), out[r0].data_ptr(),
                npts, n, ev.degree, int(vec), center, inv_half,
                kx, ky, ct0, st0, cfg.smem_bytes(ev.degree, n), stream)
            if rc != 0:
                raise RuntimeError(
                    f"grid_eval kernel launch failed: CUDA error {rc} "
                    f"({lib.vi_cuda_error_string(rc).decode()})")
            launches += 1
    return out
