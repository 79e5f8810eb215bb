"""Gaussian radial-basis-function model, host float64.

The reference's alternative model (models/radbasfun.py there) and the JAX
package's port of it (volumetricinterp_tpu/models/radbasfun.py):
basis_n(R) = exp(-||R - c_n||^2 / eps^2) on ECEF coordinates, with centres
on a NUMGRIDPNT^3 lat/lon/alt meshgrid in numpy's 'xy' order (the
reference's centre order, radbasfun.py:55-60).  It has no regularization
(eval_reg_matricies = {}, reference :62): a fit is the plain cutoff solve.

The design matrix and its gradient take ||R - c||^2 as ||R||^2 - 2 R.c +
||c||^2 clamped at 0, in exact float64 numpy on the host for numpy points
and in float64 torch on the points' device for tensor points
(``design_from_ecef``), as the JAX package takes one route for concrete
and one for traced inputs.  Dense grids are evaluated by
ops/grid_eval.RBFGridEvaluator, not here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from .. import coords


class Model:
    """Model class fulfilling the reference plugin contract."""

    def __init__(self, config_file):
        if isinstance(config_file, Config):
            cfg = config_file
        else:
            cfg = Config.from_file(config_file)
        self.config = cfg

        self.latcp = cfg.model.latcp
        self.loncp = cfg.model.loncp
        self.eps = cfg.model.eps
        self.latrange = cfg.model.latrange
        self.lonrange = cfg.model.lonrange
        self.altrange = cfg.model.altrange
        self.numgridpnt = cfg.model.numgridpnt

        # centre grid: meshgrid order matches reference radbasfun.py:55-60
        lat, lon, alt = np.meshgrid(
            np.linspace(self.latrange[0], self.latrange[1], self.numgridpnt),
            np.linspace(self.lonrange[0], self.lonrange[1], self.numgridpnt),
            np.linspace(self.altrange[0], self.altrange[1],
                        self.numgridpnt) * 1000.0,
        )
        X, Y, Z = coords.np_geodetic2ecef(lat.flatten(), lon.flatten(),
                                          alt.flatten())
        self.centers = np.stack([X, Y, Z], axis=-1)  # [nbasis, 3]
        self.nbasis = self.centers.shape[0]

        self.eval_reg_matricies = {}

    def transform_coords(self, lat, lon, alt):
        """Geodetic -> ECEF [3, npts] (reference radbasfun.py:232-256)."""
        return np.stack(coords.np_geodetic2ecef(lat, lon, alt))

    def _ecef(self, gdlat, gdlon, gdalt):
        """Flat ECEF points [npts, 3] in float64: numpy on the host, or a
        tensor on gdlat's device when gdlat is a tensor."""
        if torch.is_tensor(gdlat):
            x, y, z = coords.geodetic2ecef(
                *(torch.as_tensor(a, dtype=torch.float64,
                                  device=gdlat.device).reshape(-1)
                  for a in (gdlat, gdlon, gdalt)))
            return torch.stack([x, y, z], dim=-1)
        x, y, z = coords.np_geodetic2ecef(
            *(np.asarray(a, np.float64).ravel() for a in (gdlat, gdlon, gdalt)))
        return np.stack([x, y, z], axis=-1)

    def design_from_ecef(self, R):
        """A[npoints, nbasis] from ECEF points R[npoints, 3] in float64
        torch, on R's device (arrays go to the CPU)."""
        R = torch.as_tensor(R, dtype=torch.float64)
        c = torch.as_tensor(self.centers, device=R.device)
        d2 = ((R * R).sum(-1, keepdim=True) - 2.0 * (R @ c.T)
              + (c * c).sum(-1)[None, :])
        return torch.exp(-torch.clamp(d2, min=0.0) / self.eps**2)

    def _design_np(self, R):
        """A[npoints, nbasis] from ECEF points R[npoints, 3]."""
        c = self.centers
        d2 = np.maximum(
            np.sum(R * R, axis=-1, keepdims=True)
            - 2.0 * (R @ c.T)
            + np.sum(c * c, axis=-1)[None, :],
            0.0,
        )
        return np.exp(-d2 / self.eps**2)

    def basis(self, gdlat, gdlon, gdalt):
        """A[..., nbasis] at geodetic points (reference radbasfun.py:83-112),
        shape-preserving: host float64 numpy, or float64 torch on gdlat's
        device for a tensor."""
        shape = tuple(np.shape(gdlat))
        R = self._ecef(gdlat, gdlon, gdalt)
        A = (self.design_from_ecef(R) if torch.is_tensor(R)
             else self._design_np(R))
        return A.reshape(shape + (self.nbasis,))

    def grad_basis(self, gdlat, gdlon, gdalt):
        """Gradient of each RBF in ECEF components, [..., 3, nbasis]:
        grad_n = -2 (R - c_n) / eps^2 basis_n (the reference's version is
        commented out, radbasfun.py:115-152; the JAX package's :106-127);
        a tensor on gdlat's device for a tensor gdlat."""
        shape = tuple(np.shape(gdlat))
        R = self._ecef(gdlat, gdlon, gdalt)
        if torch.is_tensor(R):
            A = self.design_from_ecef(R)
            c = torch.as_tensor(self.centers, device=R.device)
            G = -2.0 / self.eps**2 * (R[:, :, None] - c.T) * A[:, None, :]
            return G.reshape(shape + (3, self.nbasis))
        A = self._design_np(R)
        diff = R[:, :, None] - self.centers.T[None, :, :]
        G = -2.0 / self.eps**2 * diff * A[:, None, :]
        return G.reshape(shape + (3, self.nbasis))
