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


class GridEvaluator:
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

    def _points(self, gdlat, gdlon, gdalt):
        return tuple(
            torch.as_tensor(np.asarray(a), dtype=self.dtype,
                            device=self.device).reshape(-1)
            if not torch.is_tensor(a)
            else a.to(self.device, self.dtype).reshape(-1)
            for a in (gdlat, gdlon, gdalt))

    def eval_records_flat(self, ceff, lat, lon, alt, inside=None):
        """[nrec, npts] on flat device point tensors (no reshaping)."""
        return grid_eval_cuda.eval_records(lat, lon, alt, ceff, self, inside)

    def __call__(self, C, gdlat, gdlon, gdalt, inside=None):
        """Field values of one coefficient vector, shaped like gdlat."""
        shape = np.shape(gdlat)
        lat, lon, alt = self._points(gdlat, gdlon, gdalt)
        out = self.eval_records_flat(self.fold_coeffs(C)[None], lat, lon, alt,
                                     inside)
        return out[0].reshape(shape)

    def eval_records(self, Cs, gdlat, gdlon, gdalt, inside=None):
        """Evaluate the SAME grid with many coefficient vectors in one
        launch.  Cs: [nrec, nbasis]; returns [nrec, *grid.shape]."""
        shape = np.shape(gdlat)
        lat, lon, alt = self._points(gdlat, gdlon, gdalt)
        Cs = np.asarray(Cs, np.float64).reshape(-1, self.model.nbasis)
        out = self.eval_records_flat(self.fold_coeffs(Cs), lat, lon, alt,
                                     inside)
        return out.reshape((Cs.shape[0],) + tuple(shape))


def make_grid_evaluator(model, theta_range=None, dtype=torch.float32,
                        device="cuda"):
    """Model-dispatching evaluator factory."""
    if not hasattr(model, "tables"):
        raise NotImplementedError(
            "grid evaluation of the radbasfun model is not ported to the "
            "PyTorch package yet (ROADMAP queue 1: radbasfun and series)")
    return GridEvaluator(model, theta_range, dtype=dtype, device=device)
