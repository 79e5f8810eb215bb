"""The grid-evaluation kernels' launcher, their build, and their plain twin.

``eval_records`` evaluates one point set with a batch of records' folded
coefficients.  On CUDA tensors it launches one of two hand-written Hopper
kernels, both of which replace the TPU kernel
volumetricinterp_tpu/ops/grid_eval_pallas.py::_kernel, and raises if the
kernel cannot be built or launched; on CPU tensors it runs
``eval_records_plain``, the same maths in plain torch, the plain version of
both.  ``kernel_config`` routes a model order to its kernel:

* ``csrc/grid_eval.cu`` keeps a point's basis in registers; it takes the
  orders whose live state (``KernelConfig.live``) fits two blocks an SM,
  the production order among them.  ``record_chunks`` splits the records
  into launches by the shared-memory budget.
* ``csrc/grid_eval_tiled.cu`` compacts the live points into tiles, stages
  their basis in shared memory and tiles the contraction in registers; it
  takes the orders above (maxl 10, maxl 9 with maxk 13-16), every record
  in one launch (``record_groups``, ``contraction_tm``).

``launches`` and ``tiled_launches`` count the launches of each, so a run
can show that it went through them.

The kernels read their tables in packed layouts made here (``pack_coef``,
``pack_ceff``, ``pack_ceff_rows``): rows of whole float4s, zero-padded, so
that they load them as 16-byte shared-memory broadcasts.  The kernels take
their instantiation from here as ``-D`` defines and each launch's
shared-memory size as an argument.  Each instantiation is compiled by
``nvcc`` into ``_build/`` beside the package at its first use (keyed by the
source, the instantiation and a hash of the source and flags), with the
compiler's log beside it, and loaded with ctypes; nothing is compiled at
import.
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
TILED_SOURCE = _PKG / "csrc" / "grid_eval_tiled.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v"]
# compile-time caps of the kernel (csrc/grid_eval.cu)
MAX_L = 10
MAX_K = 16
MAX_DEGREE = 256
THREADS = 256  # threads per block
# blocks an SM the launch bounds ask for (128 registers a thread): every
# instantiation kernel_config builds keeps its state within them
MINBLOCKS = 2
# shared memory a launch's tables may take: two blocks fit on an SM
SMEM_BUDGET = 96 * 1024
# registers a point may hold through grid_eval.cu's record loop; orders
# above go to grid_eval_tiled.cu
LIVE_MAX = 96
TILE = 128  # grid_eval_tiled.cu: points a tile
GROUP = 8  # grid_eval_tiled.cu: records a shared-memory group
SMEM_MAX = 232448  # the most shared memory a block may take (227 KB)

launches = 0  # launches of grid_eval.cu by eval_records
tiled_launches = 0  # launches of grid_eval_tiled.cu by eval_records
_libs = {}  # KernelConfig -> loaded library


def _ceil4(n):
    return -(-n // 4) * 4


@dataclass(frozen=True)
class KernelConfig:
    """One instantiation of a kernel: of grid_eval.cu, or of
    grid_eval_tiled.cu when ``tiled``."""

    maxl: int
    maxkb: int  # Laguerre rows: maxk rounded up to 4
    pt: int  # consecutive points per thread (grid_eval.cu; 1 when tiled)
    tiled: bool = False

    @property
    def source(self):
        return TILED_SOURCE if self.tiled else SOURCE

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
    def nrows(self):
        """Basis rows a point in the tiled kernel: Pc of every pair, Ps of
        the mbar > 0 pairs."""
        return self.maxl * self.maxl

    @property
    def tm_max(self):
        """Most points a thread of the tiled kernel's contraction: 4 x 16
        accumulators would not fit 128 registers beside the loads (the
        kernel's TM_MAX)."""
        return 4 if self.maxkb <= 12 else 2

    @property
    def rstride(self):
        """Floats a record's row block takes in ``pack_ceff_rows``: an odd
        number of float4s, so that 8 records fall on distinct banks."""
        return 4 * ((self.nrows * self.maxkb // 4) | 1)

    def smem_bytes(self, degree, nrec):
        """Dynamic shared memory of a launch of nrec records: grid_eval.cu's
        coef and ceff tables; grid_eval_tiled.cu's basis and Laguerre tiles,
        point stage, group buffer and coef rows (pair octets), whatever the
        record count (vi_grid_eval_tiled_smem)."""
        if self.tiled:
            np8 = -(-self.npairs // 8) * 8
            return 4 * ((self.nrows + self.maxkb) * TILE
                        + 5 * (TILE + THREADS) + GROUP * self.rstride
                        + degree * np8)
        return 4 * (degree * self.npp + nrec * 2 * self.npairs * self.maxkb)


def kernel_config(maxl, maxk):
    """The instantiation for a model order.  grid_eval.cu while a point's
    live state (``KernelConfig.live``) fits two blocks of 256 threads an SM
    (128 registers a thread): two points a thread while it stays well
    inside, else one.  Above LIVE_MAX (every maxl = 10, maxl = 9 with maxk
    13-16) the state would force one block an SM, and grid_eval_tiled.cu
    takes the order."""
    cfg = KernelConfig(maxl, _ceil4(maxk), 1)
    if cfg.live > LIVE_MAX:
        return KernelConfig(maxl, cfg.maxkb, 1, tiled=True)
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


def pack_ceff_rows(ceff, cfg, sin_pairs):
    """[nrec, 2, npairs, maxk] -> [nrec, rstride], the tiled kernel's row
    blocks: the cos rows of every pair, then the sin rows of the mbar > 0
    pairs (``sin_pairs``, their indices), each of maxkb floats, zero-padded
    to the record stride."""
    nrec, _, _, maxk = ceff.shape
    rows = torch.cat([ceff[:, 0], ceff[:, 1].index_select(1, sin_pairs)], 1)
    rows = torch.nn.functional.pad(rows, (0, cfg.maxkb - maxk))
    return torch.nn.functional.pad(rows.reshape(nrec, -1),
                                   (0, cfg.rstride - cfg.nrows * cfg.maxkb))


def record_groups(nrec):
    """(first record, count) of each record group the tiled kernel stages
    in shared memory: GROUP records, the last one what is left."""
    return [(r0, min(GROUP, nrec - r0)) for r0 in range(0, nrec, GROUP)]


def contraction_tm(cfg, nrec):
    """Points a thread of the tiled kernel's contraction (4, 2 or 1) for a
    launch of nrec records.  A pass of the block takes 2 x 32 / (TILE / TM /
    4) records; a warp issues a row's loads and FMAs when any of its
    records is live, and the SM takes 4 warp instructions and one
    shared-memory wavefront a clock (each warp row's basis load and each
    coefficient load is one).  The TM whose passes cost the fewest clocks,
    of those the build holds (``KernelConfig.tm_max``): the bits do not
    depend on it."""
    kq = cfg.maxkb // 4

    def clocks(tm):
        rw = 32 // (TILE // tm // 4)  # records a warp
        per_row = max((1 + kq + tm * cfg.maxkb) / 4, 1 + kq)
        return sum(4 * min(2, -(-(n - p0) // rw)) * per_row
                   for _, n in record_groups(nrec)
                   for p0 in range(0, n, 2 * rw))

    return min((tm for tm in (4, 2, 1) if tm <= cfg.tm_max), key=clocks)


def record_chunks(cfg, degree, nrec):
    """(first record, count) of each launch: grid_eval.cu takes as many
    records as the shared-memory budget holds beside the coef table, at
    least one; grid_eval_tiled.cu takes every record in one launch."""
    if cfg.tiled:
        return [(0, nrec)]
    per = max(1, (SMEM_BUDGET - cfg.smem_bytes(degree, 0))
              // cfg.smem_bytes(0, 1))
    return [(r0, min(per, nrec - r0)) for r0 in range(0, nrec, per)]


def vector_ok(cfg, npts, *tensors):
    """Whether the kernel may move PT points with one vector access:
    npts a multiple of PT and every point/output base PT-float aligned."""
    align = 4 * cfg.pt
    return npts % cfg.pt == 0 and all(t.data_ptr() % align == 0
                                      for t in tensors)


def library_path(cfg):
    """The shared library of ``cfg``: named by the source and the
    instantiation, keyed by a hash of the source and the nvcc flags."""
    flags = NVCC_FLAGS + defines(cfg)
    digest = hashlib.sha256(
        cfg.source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    if cfg.tiled:
        return BUILD_DIR / f"grid_eval_tiled_l{cfg.maxl}_k{cfg.maxkb}_{digest}.so"
    return BUILD_DIR / (f"grid_eval_l{cfg.maxl}_k{cfg.maxkb}_p{cfg.pt}_"
                        f"{digest}.so")


def build(cfg):
    """Compile the instantiation ``cfg`` (unless its source is already
    built for it) and load it.

    Returns {"config", "path", "seconds", "log"}: the instantiation, the
    shared library, the compile time (0.0 when it was already built) and
    the path of the compiler's log, written beside the library."""
    so = library_path(cfg)
    log = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        seconds, text = nvcc(NVCC_FLAGS + defines(cfg), cfg.source, so)
        log.write_text(text)
    lib = bind(so, cfg.tiled)
    if cfg.tiled:
        got = (ctypes.c_int * 7)()
        lib.vi_grid_eval_tiled_config(ctypes.addressof(got))
        want = (cfg.maxl, cfg.maxkb, TILE, GROUP, THREADS, MINBLOCKS,
                cfg.tm_max)
        sizes = [(d, lib.vi_grid_eval_tiled_smem(d))
                 for d in (1, 28, MAX_DEGREE)]
        bad = [x for x in sizes if x[1] != cfg.smem_bytes(x[0], 1)]
        if bad:
            raise RuntimeError(f"{so} sizes shared memory (degree, bytes) "
                               f"{bad}, unlike smem_bytes")
    else:
        got = (ctypes.c_int * 5)()
        lib.vi_grid_eval_config(ctypes.addressof(got))
        want = (cfg.maxl, cfg.maxkb, cfg.pt, THREADS, MINBLOCKS)
    if tuple(got) != want:
        raise RuntimeError(f"{so} holds instantiation {tuple(got)}, not {cfg}")
    _libs[cfg] = lib
    return {"config": cfg, "path": str(so), "seconds": seconds,
            "log": str(log)}


def defines(cfg):
    if cfg.tiled:
        return [f"-DVI_MAXL={cfg.maxl}", f"-DVI_MAXKB={cfg.maxkb}",
                f"-DVI_TILE={TILE}", f"-DVI_GROUP={GROUP}",
                f"-DVI_THREADS={THREADS}", f"-DVI_MINBLOCKS={MINBLOCKS}"]
    return [f"-DVI_MAXL={cfg.maxl}", f"-DVI_MAXKB={cfg.maxkb}",
            f"-DVI_PT={cfg.pt}", f"-DVI_THREADS={THREADS}",
            f"-DVI_MINBLOCKS={MINBLOCKS}"]


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


def bind(so, tiled=False):
    """Load a built library and declare its C interface."""
    lib = ctypes.CDLL(str(so))
    P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    if tiled:
        lib.vi_grid_eval_tiled.argtypes = [
            P, P, P, P, P, I, P, P, P, LL, I, I, I,
            F, F, F, F, F, F, LL, P]
        lib.vi_grid_eval_tiled.restype = I
        lib.vi_grid_eval_tiled_config.argtypes = [P]
        lib.vi_grid_eval_tiled_config.restype = None
        lib.vi_grid_eval_tiled_smem.argtypes = [I]
        lib.vi_grid_eval_tiled_smem.restype = LL
    else:
        lib.vi_grid_eval_records.argtypes = [
            P, P, P, P, P, P, P, LL, I, I, I, F, F, F, F, F, F, LL, P]
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
    """Plain torch twin of both kernels, in the dtype of ``lat``.

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

    CUDA tensors launch the order's kernel (``kernel_config``; float32
    only) or raise; CPU tensors run ``eval_records_plain``."""
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
    _check("packed coef", ev.coef_packed, torch.float32,
           (ev.degree, cfg.npp), dev)
    if inside is not None:
        _check("inside", inside, torch.bool, (npts,), dev)
    out = torch.empty((nrec, npts), dtype=torch.float32, device=dev)
    if npts == 0 or nrec == 0:
        return out
    launch_records(cfg, lat, lon, alt, ceff, ev, inside, out)
    return out


def launch_records(cfg, lat, lon, alt, ceff, ev, inside, out):
    """Launch instantiation ``cfg`` (built at its first use) on checked
    inputs: grid_eval.cu once per record chunk (``record_chunks``),
    grid_eval_tiled.cu once for every record.  Raises on a failed launch."""
    global launches, tiled_launches
    dev = lat.device
    npts, nrec = lat.shape[0], ceff.shape[0]
    if cfg not in _libs:
        build(cfg)
    lib = _libs[cfg]
    mask = None if inside is None else inside.view(torch.uint8).data_ptr()
    center, inv_half = band_constants(ev, torch.float32)
    kx, ky, ct0, st0 = ev.rot
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if cfg.tiled:
            if npts >= 2**31:
                raise ValueError("grid_eval_tiled kernel: npts must be < 2^31")
            rows = pack_ceff_rows(ceff, cfg, ev.sin_pairs)
            counter = torch.zeros(1, dtype=torch.int32, device=dev)
            rc = lib.vi_grid_eval_tiled(
                lat.data_ptr(), lon.data_ptr(), alt.data_ptr(), mask,
                ev.coef_packed.data_ptr(), cfg.npp, rows.data_ptr(),
                out.data_ptr(), counter.data_ptr(), npts, nrec, ev.degree,
                contraction_tm(cfg, nrec), center, inv_half, kx, ky, ct0,
                st0, cfg.smem_bytes(ev.degree, nrec), stream)
            _raise_on(lib, rc)
            tiled_launches += 1
            return
        ceff = pack_ceff(ceff)
        vec = vector_ok(cfg, npts, lat, lon, alt, out)
        for r0, n in record_chunks(cfg, ev.degree, nrec):
            rc = lib.vi_grid_eval_records(
                lat.data_ptr(), lon.data_ptr(), alt.data_ptr(), mask,
                ev.coef_packed.data_ptr(), ceff[r0].data_ptr(),
                out[r0].data_ptr(), npts, n, ev.degree, int(vec), center,
                inv_half, kx, ky, ct0, st0, cfg.smem_bytes(ev.degree, n),
                stream)
            _raise_on(lib, rc)
            launches += 1


def _raise_on(lib, rc):
    if rc != 0:
        raise RuntimeError(
            f"grid_eval kernel launch failed: CUDA error {rc} "
            f"({lib.vi_cuda_error_string(rc).decode()})")
