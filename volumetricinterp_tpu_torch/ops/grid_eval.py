"""Fused dense-grid evaluation of the fitted model (the Estimate hot path).

Computes out(x) = sum_n C_n B_n(x) on arbitrary geodetic grids, the
product path of the reference's Estimate (estimate.py:113-115).

* **Band refit.**  The model's float64 Legendre tables cover every possible
  colatitude (degree ~200 at maxl=6); a real grid spans a narrow band (the
  radar FoV), over which the same functions need a far lower degree.  The
  evaluator refits the tables onto the requested band once on the host,
  and records each pair's own required degree — the same numbers as the
  JAX package's GridEvaluator (ops/grid_eval.py:58-121 there).
* **Folded coefficients.**  The radial Laguerre contraction and the static
  scales (K_vm, the negative-m Gamma-ratio suppression) fold into per-pair
  effective coefficients ceff[2, npairs, maxk] per record.
* **Evaluation** goes through ops/grid_eval_cuda.eval_records: the Hopper
  kernel on the card, its plain torch twin on the CPU.

``RBFGridEvaluator`` is the radbasfun model's evaluator (the JAX package's
ops/grid_eval.py:265-322): a matmul, an ``exp`` and a contraction in
torch, with no kernel of its own (the JAX package runs no Pallas kernel
there either).  ``make_grid_evaluator`` and ``grid_eval`` pick the
evaluator by the model.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import coords
from ..tables import cheb_fit, cheb_nodes
from ..utils.device import check_device
from . import grid_eval_cuda


@dataclass
class BandTable:
    """The band refit: everything about an evaluator that depends on the
    model and the colatitude band, and not on the device."""

    coef: np.ndarray  # [degree, npairs] float64 Chebyshev coefficients
    pair_degree: np.ndarray  # [npairs] terms each pair needs
    mbar_pair: np.ndarray  # [npairs] |m| of each (l, mbar) pair
    theta_lo: float
    theta_hi: float

    @property
    def degree(self) -> int:
        return self.coef.shape[0]


def refit_band(model, theta_range, tol=3e-8) -> BandTable:
    """Refit the model's shift-0 Legendre table columns onto the band
    theta_range (radians, padded by 2% + 1e-6), truncated at ``tol``."""
    lo, hi = theta_range
    pad = 0.02 * (hi - lo) + 1e-6
    theta_lo = max(float(lo) - pad, 0.0)
    theta_hi = min(float(hi) + pad, model.tables.theta_max)

    tbl = model.tables
    npairs = tbl.npairs
    n_nodes = 256
    u = cheb_nodes(n_nodes)
    theta = theta_lo + (u + 1.0) * 0.5 * (theta_hi - theta_lo)
    vals0 = tbl.eval_all_np(theta)[:, 1::3]  # shift-0 columns [nodes, npairs]
    coef = cheb_fit(vals0)
    sup = np.max(np.abs(vals0), axis=0)
    sup = np.where(sup == 0, 1.0, sup)
    D = n_nodes
    for deg in range(8, n_nodes):
        if np.all(np.max(np.abs(coef[deg:]) / sup, axis=0) < tol):
            D = deg
            break
    # per-pair required degree: low-l pairs converge long before the
    # global D driven by l = maxl - 1
    tails = np.abs(coef[:D]) / sup[None, :]
    deg_j = np.full(npairs, D, dtype=np.int64)
    for j in range(npairs):
        above = np.nonzero(tails[:, j] >= tol)[0]
        deg_j[j] = int(above[-1]) + 1 if above.size else 1
    mbar = np.concatenate([np.arange(l + 1) for l in range(model.maxl)])
    return BandTable(coef=np.ascontiguousarray(coef[:D]), pair_degree=deg_j,
                     mbar_pair=mbar, theta_lo=theta_lo, theta_hi=theta_hi)


class _Evaluator:
    """What both evaluators share: points to flat device tensors, and the
    one-record and many-record calls on top of ``fold_coeffs`` and
    ``eval_records_flat``."""

    def _points(self, gdlat, gdlon, gdalt):
        return tuple(
            torch.as_tensor(np.asarray(a), dtype=self.dtype,
                            device=self.device).reshape(-1)
            if not torch.is_tensor(a)
            else a.to(self.device, self.dtype).reshape(-1)
            for a in (gdlat, gdlon, gdalt))

    def __call__(self, C, gdlat, gdlon, gdalt, inside=None):
        """Field values of one coefficient vector, shaped like gdlat."""
        shape = np.shape(gdlat)
        lat, lon, alt = self._points(gdlat, gdlon, gdalt)
        Cs = np.asarray(C, np.float64).reshape(1, self.model.nbasis)
        out = self.eval_records_flat(self.fold_coeffs(Cs), lat, lon, alt,
                                     inside)
        return out[0].reshape(shape)

    def eval_records(self, Cs, gdlat, gdlon, gdalt, inside=None):
        """Evaluate the SAME grid with many coefficient vectors in one
        call.  Cs: [nrec, nbasis]; returns [nrec, *grid.shape]."""
        shape = np.shape(gdlat)
        lat, lon, alt = self._points(gdlat, gdlon, gdalt)
        Cs = np.asarray(Cs, np.float64).reshape(-1, self.model.nbasis)
        out = self.eval_records_flat(self.fold_coeffs(Cs), lat, lon, alt,
                                     inside)
        return out.reshape((Cs.shape[0],) + tuple(shape))


class GridEvaluator(_Evaluator):
    """Reusable fused evaluator for one model and one colatitude band.

    model: models.sphharmlag.Model; theta_range: (lo, hi) radians, the band
    to cover (points outside it evaluate to NaN); dtype: torch.float32 (the
    kernel) or torch.float64 (the plain twin only); tol: Chebyshev
    truncation tolerance of the refit; table: a prepared BandTable in place
    of the refit (convert.from_jax_evaluator)."""

    def __init__(self, model, theta_range=None, dtype=torch.float32,
                 tol=3e-8, device="cuda", table=None):
        self.device = check_device(device)
        self.model = model
        self.dtype = dtype
        self.table = table if table is not None else refit_band(
            model, theta_range, tol)
        self.theta_lo, self.theta_hi = self.table.theta_lo, self.table.theta_hi
        self.degree = self.table.degree
        self.pair_degree = self.table.pair_degree
        self.mbar_pair = self.table.mbar_pair
        self.npairs = len(self.pair_degree)
        self.maxl, self.maxk = model.maxl, model.maxk
        self.rot = coords.cap_rotation(model.latcp, model.loncp)
        # the band table on the device once, and the kernel's packed copy
        self.coef_device = torch.as_tensor(
            self.table.coef, dtype=dtype, device=self.device).contiguous()
        self.coef_packed = grid_eval_cuda.pack_coef(self.coef_device,
                                                    self.pair_degree)
        # the mbar > 0 pairs, whose sin rows the tiled kernel reads
        self.sin_pairs = torch.as_tensor(np.flatnonzero(self.mbar_pair > 0),
                                         device=self.device)

        self._scale = model._kvm * model._negm_scale
        self._k_n = model._k
        self._sin_n = (model._m < 0).astype(np.int64)
        self._pair_n = model._l * (model._l + 1) // 2 + model._mbar

    def fold_coeffs(self, C, dtype=None):
        """Ceff [nrec, 2, npairs, maxk] of coefficient vectors C [nrec,
        nbasis] (or [nbasis] -> [2, npairs, maxk]): branch 0 = cos (m>=0),
        1 = sin (m<0), with the K_vm and negative-m scales folded in."""
        C = np.asarray(C, dtype=np.float64)
        ceff = np.zeros(C.shape[:-1] + (2, self.npairs, self.maxk))
        np.add.at(
            ceff,
            (Ellipsis, self._sin_n, self._pair_n, self._k_n),
            self._scale * C,
        )
        return torch.as_tensor(ceff, dtype=dtype or self.dtype,
                               device=self.device)

    def eval_records_flat(self, ceff, lat, lon, alt, inside=None):
        """[nrec, npts] on flat device point tensors (no reshaping)."""
        return grid_eval_cuda.eval_records(lat, lon, alt, ceff, self, inside)


class RBFGridEvaluator(_Evaluator):
    """Dense-grid evaluator of the radbasfun model:
    out(x) = sum_n C_n exp(-||R(x) - c_n||^2 / eps^2).

    The points go to ECEF in float64 on the device and are recentred on the
    centre-of-centres before they drop to ``dtype`` (distances are
    translation invariant; relative coordinates of ~1e5 m instead of
    ~6.4e6 m give float32 squared distances 30x finer).  Then, a point
    chunk at a time, d2 = |R|^2 - 2 R.c + |c|^2 clamped at 0, exp, and the
    contraction with the records' coefficients, by torch.matmul.  The
    [points, nbasis] intermediate is bounded to ``point_chunk`` points (by
    default ~0.5 GB): at the config-4 grid (33.5M points) and the default
    343 basis functions it would be 46 GB at once."""

    theta_lo, theta_hi = 0.0, float(np.pi)  # no colatitude band

    def __init__(self, model, dtype=torch.float32, device="cuda"):
        self.device = check_device(device)
        self.model = model
        self.dtype = dtype
        nb = model.nbasis
        itemsize = torch.empty((), dtype=dtype).element_size()
        self.point_chunk = max(1, 2**29 // (itemsize * nb))
        cen64 = np.asarray(model.centers, np.float64)
        self._origin = torch.as_tensor(cen64.mean(axis=0), device=self.device)
        cen = torch.as_tensor(cen64 - cen64.mean(axis=0), dtype=dtype,
                              device=self.device)
        self._centers_t = cen.T.contiguous()  # [3, nb]
        self._c2 = (cen * cen).sum(-1)  # [nb]
        self._neg_inv_eps2 = -1.0 / float(model.eps) ** 2

    def fold_coeffs(self, C, dtype=None):
        """The coefficient vectors as a device tensor ([nrec, nb] or [nb])."""
        return torch.as_tensor(np.asarray(C, np.float64),
                               dtype=dtype or self.dtype, device=self.device)

    def eval_records_flat(self, Cs, lat, lon, alt, inside=None):
        """[nrec, npts] on flat device point tensors; NaN where ``inside``
        (a bool mask, or None) is False."""
        x, y, z = coords.geodetic2ecef(lat.double(), lon.double(),
                                       alt.double())
        R = (torch.stack([x, y, z], dim=-1) - self._origin).to(self.dtype)
        Cs = Cs.reshape(-1, self.model.nbasis)
        out = torch.empty((R.shape[0], Cs.shape[0]), dtype=self.dtype,
                          device=self.device)
        for s in range(0, R.shape[0], self.point_chunk):
            Rc = R[s:s + self.point_chunk]
            d2 = torch.addmm(self._c2, Rc, self._centers_t, alpha=-2.0)
            d2.add_((Rc * Rc).sum(-1, keepdim=True)).clamp_(min=0.0)
            A = d2.mul_(self._neg_inv_eps2).exp_()
            torch.matmul(A, Cs.T, out=out[s:s + self.point_chunk])
        out = out.T
        if inside is not None:
            out = torch.where(inside.to(self.device), out, float("nan"))
        return out.contiguous()


def make_grid_evaluator(model, theta_range=None, dtype=torch.float32,
                        device="cuda"):
    """Model-dispatching evaluator factory: sphharmlag needs a colatitude
    band, radbasfun does not."""
    if hasattr(model, "tables"):
        return GridEvaluator(model, theta_range, dtype=dtype, device=device)
    return RBFGridEvaluator(model, dtype=dtype, device=device)


def grid_eval(model, C, gdlat, gdlon, gdalt, dtype=torch.float32,
              device="cuda"):
    """One-shot evaluation of one coefficient vector on a grid (an
    evaluator built per call), shaped like gdlat."""
    theta_range = None
    if hasattr(model, "tables"):
        _, t, _ = coords.np_geodetic_to_cap(
            *(np.asarray(a, np.float64).ravel() for a in (gdlat, gdlon, gdalt)),
            model.latcp, model.loncp)
        model.ensure_theta_domain(float(t.max()))
        theta_range = (float(t.min()), float(t.max()))
    ev = make_grid_evaluator(model, theta_range, dtype=dtype, device=device)
    return ev(C, gdlat, gdlon, gdalt)
