"""Spherical-cap-harmonic x weighted-Laguerre basis model, host float64.

The reference's default model (models/sphharmlag.py): the 3-D basis is

    B_n(z, theta, phi) = e^{-z/2} L_k(z) * K_vm trig(|m| phi) * P_nu(l)^m(cos theta)

with n -> (k, l, m) per the index map at models/sphharmlag.py:79-99, the
Thebault nu(l) approximation at :101-115, and the cap coordinate transform
at :324-359.  SIGNED m is passed to the Legendre function as the reference
does at :141 (P_nu^{-|m|} through the Gamma-ratio connection).

The port of ``volumetricinterp_tpu/models/sphharmlag.py``.  ``basis`` and
``grad_basis`` take two routes, as the JAX package's take one for concrete
and one for traced inputs:

* numpy points: the host route, exact float64 numpy from Chebyshev tables
  of P_nu^m (tables.py), or with BASIS_IMPL = series from the direct
  hypergeometric series (special.lpmv, float64 torch); bit-identical to
  the JAX package, which runs the same numpy code;
* torch tensor points: the device route, the same expressions in float64
  torch on the points' device (``design_from_ztp`` / ``_design_core`` and
  ``_grad_core``), the cap transform by coords.geodetic_to_cap.

The regularization matrices come from separable 1-D integral tables
combined by outer products, in 'quad' mode (host scipy.integrate.quad,
identical to the reference) or 'gauss' mode (fixed Gauss rules).  Dense
grids are evaluated by ops/grid_eval.py, not here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import Config
from ..constants import RE
from .. import coords, special
from ..tables import build_legendre_tables, nu_of_l
from ..quadrature import (
    composite_legendre,
    gauss_laguerre,
    gauss_legendre,
    geometric_panels,
)


class Model:
    """Model class fulfilling the reference plugin contract."""

    def __init__(self, config_file):
        if isinstance(config_file, Config):
            cfg = config_file
        else:
            cfg = Config.from_file(config_file)
        self.config = cfg
        if cfg.tpu.basis_impl not in ("table", "series"):
            raise ValueError(f"unknown BASIS_IMPL {cfg.tpu.basis_impl!r} "
                             "(table or series)")
        self.basis_impl = cfg.tpu.basis_impl

        self.maxk = cfg.model.maxk
        self.maxl = cfg.model.maxl
        self.latcp = cfg.model.latcp
        self.loncp = cfg.model.loncp
        self.cap_lim = cfg.model.cap_lim * np.pi / 180.0  # radians
        self.max_z_int = cfg.model.max_z_int
        self.nbasis = self.maxk * self.maxl**2

        self._quad_mode = cfg.tpu.quad_mode
        self._build_index_tables()
        self._dev = {}  # the index tables as tensors, per device (_consts)
        # Default theta domain for the Legendre tables.  The reference's
        # transform rotates by +theta0 (docs/PARITY_NOTES.md #1), which maps
        # the cap CENTER to colatitude 2*theta0, so data colatitudes cluster
        # there; the domain is sized accordingly and basis() widens it
        # adaptively if points fall beyond.
        x0, y0, z0 = coords.np_geodetic2ecef(self.latcp, self.loncp, 0.0)
        theta0 = float(np.arccos(z0 / np.sqrt(x0**2 + y0**2 + z0**2)))
        default_domain = min(
            2.0 * theta0 + cfg.tpu.table_domain_factor * self.cap_lim,
            np.pi * 0.95,
        )
        self.tables = build_legendre_tables(
            self.maxl,
            self.cap_lim,
            theta_max=default_domain,
            tol=cfg.tpu.table_tol,
        )

        # reference attribute name kept verbatim (sphharmlag.py:62)
        self.eval_reg_matricies = {
            "curvature": self.eval_omega,
            "0thorder": self.eval_psi,
        }

    # ------------------------------------------------------------------
    # static index / scale tables
    # ------------------------------------------------------------------

    def _build_index_tables(self):
        import scipy.special as sp

        n = np.arange(self.nbasis)
        k = n // (self.maxl**2)
        r = n % (self.maxl**2)
        l = np.floor(np.sqrt(r)).astype(np.int64)
        m = r - l * (l + 1)  # signed, in [-l, l]
        mbar = np.abs(m)
        nu = nu_of_l(l, self.cap_lim)

        # K_vm (sphharmlag.py:305-321), computed in log space
        kvm = np.sqrt(
            (2.0 * nu + 1.0)
            / (4.0 * np.pi)
            * np.exp(sp.gammaln(nu - mbar + 1.0) - sp.gammaln(nu + mbar + 1.0))
        )
        kvm = np.where(mbar != 0, kvm * np.sqrt(2.0), kvm)

        # P_nu^{-mbar} = (-1)^mbar G(nu-mbar+1)/G(nu+mbar+1) P_nu^{+mbar}
        def negm_scale(nu_arr):
            ratio = np.exp(sp.gammaln(nu_arr - mbar + 1.0)
                           - sp.gammaln(nu_arr + mbar + 1.0))
            return np.where(m < 0, ((-1.0) ** mbar) * ratio, 1.0)

        self._k = k
        self._l = l
        self._m = m
        self._mbar = mbar
        self._nu = nu
        self._kvm = kvm
        self._negm_scale = negm_scale(nu)  # degree nu
        self._negm_scale_p1 = negm_scale(nu + 1.0)  # degree nu + 1
        # table columns per basis function, degree shifts 0 and +1
        pair = l * (l + 1) // 2 + mbar
        self._col_0 = 3 * pair + 1
        self._col_p1 = 3 * pair + 2
        self._is_cos = (m >= 0).astype(np.float64)

    def _consts(self, device):
        """The per-basis index and scale tables as tensors on ``device``."""
        device = torch.device(device)
        c = self._dev.get(device)
        if c is None:
            pair = self._l * (self._l + 1) // 2 + self._mbar
            c = {name: torch.as_tensor(arr, device=device) for name, arr in (
                ("k", self._k), ("mbar", self._mbar), ("pair", pair),
                ("col_0", self._col_0), ("col_p1", self._col_p1),
                ("negm", self._negm_scale), ("negm_p1", self._negm_scale_p1),
                ("kvm", self._kvm), ("is_cos", self._is_cos),
                ("m", self._m.astype(np.float64)),
                ("mbar_f", self._mbar.astype(np.float64)), ("nu", self._nu))}
            self._dev[device] = c
        return c

    # ------------------------------------------------------------------
    # reference-parity helpers (sphharmlag.py:79-115, 263-321)
    # ------------------------------------------------------------------

    def basis_numbers(self, n):
        k = n // (self.maxl**2)
        r = n % (self.maxl**2)
        l = np.floor(np.sqrt(r))
        m = r - l * (l + 1)
        return k, l, m

    def nu(self, n):
        _, l, _ = self.basis_numbers(n)
        return (2 * l + 0.5) * np.pi / (2 * self.cap_lim) - 0.5

    def Az(self, v, m, phi):
        """K_vm trig(|m| phi), float64 torch (on phi's device for a tensor)."""
        phi = torch.as_tensor(phi, dtype=torch.float64)
        trig = torch.sin if m < 0 else torch.cos
        return float(self.Kvm(v, abs(m))) * trig(abs(m) * phi)

    def dAz(self, v, m, phi):
        """d Az / d phi, float64 torch."""
        phi = torch.as_tensor(phi, dtype=torch.float64)
        kv = float(self.Kvm(v, abs(m)))
        if m < 0:
            return abs(m) * kv * torch.cos(abs(m) * phi)
        return -1 * m * kv * torch.sin(abs(m) * phi)

    def Kvm(self, v, m):
        return special.kvm(v, int(m))

    def transform_coord(self, gdlat, gdlon, gdalt):
        """Geodetic -> (z, theta, phi) cap coordinates (sphharmlag.py:324-359),
        host float64."""
        return coords.np_geodetic_to_cap(gdlat, gdlon, gdalt, self.latcp,
                                         self.loncp)

    # ------------------------------------------------------------------
    # design matrix
    # ------------------------------------------------------------------

    def ensure_theta_domain(self, theta_max_needed: float):
        """Rebuild the Legendre tables if a larger theta domain is needed."""
        margin = 1.05 * float(theta_max_needed)
        if margin > self.tables.theta_max:
            self.tables = build_legendre_tables(
                self.maxl,
                self.cap_lim,
                theta_max=min(margin, np.pi * 0.95),
                tol=self.config.tpu.table_tol,
            )

    def _coords_for(self, gdlat, gdlon, gdalt):
        """Flat host-f64 cap coordinates; widens the tables if needed."""
        z, t, p = coords.np_geodetic_to_cap(
            np.asarray(gdlat, dtype=np.float64).ravel(),
            np.asarray(gdlon, dtype=np.float64).ravel(),
            np.asarray(gdalt, dtype=np.float64).ravel(),
            self.latcp, self.loncp)
        tmax = float(np.max(t)) if t.size else 0.0
        if np.isfinite(tmax):
            self.ensure_theta_domain(tmax)
        return z, t, p

    def _coords_t(self, gdlat, gdlon, gdalt):
        """Flat float64 cap coordinates (z, theta, phi) of tensor points, on
        gdlat's device (the other two are moved there); widens the tables
        if needed, as the host route does (one read of max theta)."""
        dev = gdlat.device
        lat, lon, alt = (torch.as_tensor(a, dtype=torch.float64,
                                         device=dev).reshape(-1)
                         for a in (gdlat, gdlon, gdalt))
        z, t, cosp, sinp = coords.geodetic_to_cap(
            lat, lon, alt, coords.cap_rotation(self.latcp, self.loncp))
        tmax = float(t.max()) if t.numel() else 0.0
        if np.isfinite(tmax):
            self.ensure_theta_domain(tmax)
        return z, t, torch.atan2(sinp, cosp)

    def _trig(self, p):
        """(cos(m p), sin(m p)) [npts, maxl] for m = 0 .. maxl-1, numpy or
        torch as p is."""
        if torch.is_tensor(p):
            mb = torch.arange(self.maxl, dtype=p.dtype, device=p.device)
            return torch.cos(p[:, None] * mb), torch.sin(p[:, None] * mb)
        mb = np.arange(self.maxl, dtype=np.float64)
        return np.cos(p[:, None] * mb[None, :]), np.sin(p[:, None] * mb[None, :])

    def _series_legendre(self, x):
        """P_nu^m columns [npts, nbasis] at x = cos(theta), a float64
        tensor, by special.lpmv's hypergeometric series, one call per
        (l, mbar) pair, on x's device (BASIS_IMPL = series: the table-free
        path of the JAX package's _design_core,
        volumetricinterp_tpu/models/sphharmlag.py:231-243)."""
        cols = [special.lpmv(mbar, float(nu_of_l(l, self.cap_lim)), x)
                for l in range(self.maxl) for mbar in range(l + 1)]
        return torch.stack(cols, dim=-1)[:, self._consts(x.device)["pair"]]

    def design_from_ztp(self, z, t, p, tables=None):
        """A[npoints, nbasis] from cap coordinates, float64 torch on the
        device of z (arrays go to the CPU): the device route's core."""
        tbl = self.tables if tables is None else tables
        return self._design_core(z, t, p, tbl.coef_np, tbl.theta_max)

    def _design_core(self, z, t, p, coef, theta_max):
        """The torch design matrix: the Legendre part by Clenshaw on the
        tables (or the series), the Laguerre recurrence for the radial
        part, cos/sin(m phi) for the azimuth (the JAX package's
        _design_core, volumetricinterp_tpu/models/sphharmlag.py:224-261)."""
        from ..tables import cheb_clenshaw

        z = torch.as_tensor(z, dtype=torch.float64).reshape(-1)
        t, p = (torch.as_tensor(a, dtype=torch.float64,
                                device=z.device).reshape(-1) for a in (t, p))
        c = self._consts(z.device)
        if self.basis_impl == "series":
            Pn = self._series_legendre(torch.cos(t)) * c["negm"]
        else:
            P = cheb_clenshaw(2.0 * t / theta_max - 1.0, coef)
            Pn = P[:, c["col_0"]] * c["negm"]
        radial = torch.exp(-0.5 * z)[:, None] * special.laguerre_all(
            self.maxk - 1, z)
        cosm, sinm = self._trig(p)
        trig = (cosm[:, c["mbar"]] * c["is_cos"]
                + sinm[:, c["mbar"]] * (1.0 - c["is_cos"]))
        return radial[:, c["k"]] * (c["kvm"] * trig) * Pn

    def _design_np(self, z, t, p):
        """Host float64 design matrix [npoints, nbasis] at cap coordinates:
        Chebyshev Clenshaw (or, with BASIS_IMPL = series, the direct series)
        for the Legendre part, Laguerre recurrence for the radial part,
        cos/sin(m phi) for the azimuth."""
        from ..tables import np_cheb_clenshaw

        if self.basis_impl == "series":
            P = self._series_legendre(torch.as_tensor(np.cos(t))).numpy()
        else:
            tbl = self.tables
            u = 2.0 * t / tbl.theta_max - 1.0
            P = np_cheb_clenshaw(u, tbl.coef_np)[:, self._col_0]
        Pn = P * self._negm_scale[None, :]

        lag = special.np_laguerre_all(self.maxk - 1, z)
        radial = np.exp(-0.5 * z)[:, None] * lag

        cosm, sinm = self._trig(p)
        trig = (
            cosm[:, self._mbar] * self._is_cos[None, :]
            + sinm[:, self._mbar] * (1.0 - self._is_cos)[None, :]
        )
        return radial[:, self._k] * (self._kvm[None, :] * trig) * Pn

    def basis(self, gdlat, gdlon, gdalt):
        """A[..., nbasis] at geodetic points (reference sphharmlag.py:118-145),
        shape-preserving over the input dimensionality: host float64 numpy
        for numpy points, float64 torch on gdlat's device for a tensor."""
        shape = tuple(np.shape(gdlat))
        if torch.is_tensor(gdlat):
            z, t, p = self._coords_t(gdlat, gdlon, gdalt)
            return self.design_from_ztp(z, t, p).reshape(shape + (self.nbasis,))
        z, t, p = self._coords_for(gdlat, gdlon, gdalt)
        return self._design_np(z, t, p).reshape(shape + (self.nbasis,))

    def _grad_np(self, z, t, p):
        """Host float64 gradient of every basis function at cap
        coordinates, [npts, 3, nbasis] in (z-hat, theta-hat, phi-hat):
        d/dz of e^{-z/2} L_k through L^1_{k-1} (scaled by 100/RE to d/dr),
        d/dtheta of P_nu^m through P_{nu+1}^m, d/dphi of the azimuth, the
        angular ones over r sin(theta) (volumetricinterp_tpu/models/
        sphharmlag.py:312-362)."""
        from ..tables import np_cheb_clenshaw

        x, y, e = np.cos(t), np.sin(t), np.exp(-0.5 * z)
        tbl = self.tables
        P = np_cheb_clenshaw(2.0 * t / tbl.theta_max - 1.0, tbl.coef_np)
        Pmv = P[:, self._col_0] * self._negm_scale[None, :]
        Pmv1 = P[:, self._col_p1] * self._negm_scale_p1[None, :]

        L0 = special.np_laguerre_all(self.maxk - 1, z)[:, self._k]
        # L^1_{k-1}, indexed by k (L^1_{-1} = 0)
        lag1 = special.np_laguerre_all(max(self.maxk - 2, 0), z, alpha=1.0)
        L1 = np.concatenate([np.zeros_like(z)[:, None], lag1],
                            axis=-1)[:, self._k]

        cosm, sinm = self._trig(p)
        cos_b, sin_b = cosm[:, self._mbar], sinm[:, self._mbar]
        trig = cos_b * self._is_cos + sin_b * (1.0 - self._is_cos)
        dtrig = (-self._m.astype(np.float64) * sin_b * self._is_cos
                 + self._mbar.astype(np.float64) * cos_b
                 * (1.0 - self._is_cos))
        A_az = self._kvm * trig
        dA_az = self._kvm * dtrig

        v = self._nu[None, :]
        msgn = self._m.astype(np.float64)[None, :]
        denom = (y * (z / 100.0 + 1.0) * RE)[:, None]
        zhat = -0.5 * e[:, None] * (L0 + 2.0 * L1) * Pmv * A_az * 100.0 / RE
        that = (e[:, None] * L0
                * (-(v + 1.0) * x[:, None] * Pmv + (v - msgn + 1.0) * Pmv1)
                * A_az / denom)
        phat = e[:, None] * L0 * Pmv * dA_az / denom
        return np.stack([zhat, that, phat], axis=-2)

    def grad_basis(self, gdlat, gdlon, gdalt):
        """Gradient of each basis function (reference sphharmlag.py:148-184)
        at geodetic points: [..., 3, nbasis] in cap components (z-hat,
        theta-hat, phi-hat), host float64 numpy for numpy points, float64
        torch on gdlat's device for a tensor.  Always from the tables,
        whatever BASIS_IMPL says, as in the JAX package."""
        shape = tuple(np.shape(gdlat))
        if torch.is_tensor(gdlat):
            z, t, p = self._coords_t(gdlat, gdlon, gdalt)
            G = self._grad_core(z, t, p, self.tables.coef_np,
                                self.tables.theta_max)
            return G.reshape(shape + (3, self.nbasis))
        z, t, p = self._coords_for(gdlat, gdlon, gdalt)
        return self._grad_np(z, t, p).reshape(shape + (3, self.nbasis))

    def _grad_core(self, z, t, p, coef, theta_max):
        """The torch twin of _grad_np on z's device (the JAX package's
        _grad_core, volumetricinterp_tpu/models/sphharmlag.py:398-448)."""
        from ..tables import cheb_clenshaw

        c = self._consts(z.device)
        x, y, e = torch.cos(t), torch.sin(t), torch.exp(-0.5 * z)
        P = cheb_clenshaw(2.0 * t / theta_max - 1.0, coef)
        Pmv = P[:, c["col_0"]] * c["negm"]
        Pmv1 = P[:, c["col_p1"]] * c["negm_p1"]

        L0 = special.laguerre_all(self.maxk - 1, z)[:, c["k"]]
        # L^1_{k-1}, indexed by k (L^1_{-1} = 0)
        lag1 = special.laguerre_all(max(self.maxk - 2, 0), z, alpha=1.0)
        L1 = torch.cat([torch.zeros_like(z)[:, None], lag1],
                       dim=-1)[:, c["k"]]

        cosm, sinm = self._trig(p)
        cos_b, sin_b = cosm[:, c["mbar"]], sinm[:, c["mbar"]]
        trig = cos_b * c["is_cos"] + sin_b * (1.0 - c["is_cos"])
        dtrig = (-c["m"] * sin_b * c["is_cos"]
                 + c["mbar_f"] * cos_b * (1.0 - c["is_cos"]))
        A_az = c["kvm"] * trig
        dA_az = c["kvm"] * dtrig

        v = c["nu"][None, :]
        msgn = c["m"][None, :]
        denom = (y * (z / 100.0 + 1.0) * RE)[:, None]
        zhat = -0.5 * e[:, None] * (L0 + 2.0 * L1) * Pmv * A_az * 100.0 / RE
        that = (e[:, None] * L0
                * (-(v + 1.0) * x[:, None] * Pmv + (v - msgn + 1.0) * Pmv1)
                * A_az / denom)
        phat = e[:, None] * L0 * Pmv * dA_az / denom
        return torch.stack([zhat, that, phat], dim=-2)

    def inverse_transform(self, gdlat, gdlon, gdalt, vec):
        """Vectors in cap-frame spherical components (r-hat, theta-hat,
        phi-hat; ``vec`` [..., 3], e.g. grad_basis contractions) at geodetic
        points, rotated back to ECEF (x, y, z), host float64.  The
        reference's own inverse_transform (sphharmlag.py:363-395) is stale;
        this is the JAX package's working version (:450-480)."""
        shape = np.shape(gdlat)
        _, t, p = self._coords_for(gdlat, gdlon, gdalt)
        vec = np.asarray(vec, dtype=np.float64).reshape((-1, 3))
        st, ct, sp_, cp_ = np.sin(t), np.cos(t), np.sin(p), np.cos(p)
        rhat = np.stack([st * cp_, st * sp_, ct], axis=-1)
        that = np.stack([ct * cp_, ct * sp_, -st], axis=-1)
        phat = np.stack([-sp_, cp_, np.zeros_like(sp_)], axis=-1)
        v = vec[:, 0:1] * rhat + vec[:, 1:2] * that + vec[:, 2:3] * phat
        # undo the +theta0 rotation (docs/PARITY_NOTES.md #1)
        k, theta0 = coords.cap_rotation_axis_angle(self.latcp, self.loncp)
        vx, vy, vz = coords.rodrigues_rotate(k, -theta0, v[:, 0], v[:, 1],
                                             v[:, 2])
        return np.stack([vx, vy, vz], axis=-1).reshape(shape + (3,))

    # ------------------------------------------------------------------
    # regularization matrices (separable 1-D integral tables)
    # ------------------------------------------------------------------

    def _signed_lpmv_host(self, m, v, x, reference_exact):
        """Host Legendre seed for integrand tables.

        reference_exact=True reproduces scipy.special.lpmv verbatim
        (including its negative-m underflow-to-zero at large nu, which the
        reference inherits at models/sphharmlag.py:205,231); otherwise the
        accurate Gamma-ratio path is used.
        """
        import scipy.special as sp

        if reference_exact:
            return sp.lpmv(m, v, x)
        return special.lpmv_host(m, v, x)

    def _horizontal_indices(self):
        """(l, m, nu) of the horizontal index j = l(l+1)+m in [0, maxl^2),
        in basis order for one k-slab."""
        l = self._l[: self.maxl**2]
        m = self._m[: self.maxl**2]
        nu = self._nu[: self.maxl**2]
        return l, m, nu

    def _iz_table(self, power: int) -> np.ndarray:
        """Iz[ki, kj] = int e^{-z} L_ki L_kj z^power dz over (0, max_z_int)."""
        import scipy.integrate
        import scipy.special as sp
        import warnings

        K = self.maxk
        iz = np.zeros((K, K))
        if self._quad_mode == "quad":
            for ki in range(K):
                for kj in range(ki, K):
                    f = lambda zz: (
                        np.exp(-zz)
                        * sp.eval_laguerre(ki, zz)
                        * sp.eval_laguerre(kj, zz)
                        * zz**power
                    )
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        val = scipy.integrate.quad(f, 0.0, self.max_z_int)[0]
                    iz[ki, kj] = iz[kj, ki] = val
            return iz
        # gauss mode
        if math.isinf(self.max_z_int):
            zq, wq = gauss_laguerre(2 * K + 8)  # weight e^{-z} folded in
            lagv = np.stack(
                [np.polynomial.laguerre.lagval(zq, np.eye(K)[k]) for k in range(K)]
            )
            zp = zq.astype(np.float64) ** power
            iz = np.einsum("q,iq,jq,q->ij", wq, lagv, lagv, zp)
        else:
            zq, wq = gauss_legendre(128, 0.0, self.max_z_int)
            lagv = np.stack(
                [np.polynomial.laguerre.lagval(zq, np.eye(K)[k]) for k in range(K)]
            )
            iz = np.einsum(
                "q,iq,jq,q->ij", wq * np.exp(-zq), lagv, lagv, zq**power
            )
        return iz

    def _az_host(self, v, m, phi):
        import scipy.special as sp

        kv = np.sqrt(
            (2.0 * v + 1.0)
            / (4.0 * np.pi)
            * np.exp(sp.gammaln(v - abs(m) + 1.0) - sp.gammaln(v + abs(m) + 1.0))
        )
        if m != 0:
            kv = kv * np.sqrt(2.0)
        return kv * (np.sin(abs(m) * phi) if m < 0 else np.cos(abs(m) * phi))

    def _ip_table(self) -> np.ndarray:
        """Ip[j, j'] = int_0^{2pi} Az_i Az_j dphi (analytic in gauss mode)."""
        import scipy.integrate

        l, m, nu = self._horizontal_indices()
        J = self.maxl**2
        ip = np.zeros((J, J))
        if self._quad_mode == "quad":
            for i in range(J):
                for j in range(i, J):
                    f = lambda pp: self._az_host(nu[i], m[i], pp) * self._az_host(
                        nu[j], m[j], pp
                    )
                    val = scipy.integrate.quad(f, 0.0, 2.0 * np.pi)[0]
                    ip[i, j] = ip[j, i] = val
            return ip
        # analytic: orthogonality of cos/sin over the full period
        import scipy.special as sp

        kv = np.sqrt(
            (2.0 * nu + 1.0)
            / (4.0 * np.pi)
            * np.exp(sp.gammaln(nu - np.abs(m) + 1.0) - sp.gammaln(nu + np.abs(m) + 1.0))
        )
        kv = np.where(m != 0, kv * np.sqrt(2.0), kv)
        same = (m[:, None] == m[None, :]).astype(np.float64)
        fac = np.where(m == 0, 2.0 * np.pi, np.pi)
        ip = same * kv[:, None] * kv[None, :] * fac[None, :]
        return ip

    def _omega_t_integrand_host(self, theta, l, m, nu, reference_exact):
        """The Legendre combination of the curvature theta-integrand for one
        (l, m): -nu(nu cos^2 + nu + 1) P_nu^m + nu(nu+m) cos P_{nu-1}^m
        + nu(nu-m+1) cos P_{nu+1}^m   (models/sphharmlag.py:205)."""
        x = np.cos(theta)
        P0 = self._signed_lpmv_host(m, nu, x, reference_exact)
        Pm = self._signed_lpmv_host(m, nu - 1.0, x, reference_exact)
        Pp = self._signed_lpmv_host(m, nu + 1.0, x, reference_exact)
        return (
            -nu * (nu * x**2 + nu + 1.0) * P0
            + nu * (nu + m) * x * Pm
            + nu * (nu - m + 1.0) * x * Pp
        )

    def _it_table(self, kind: str) -> np.ndarray:
        """It[j, j'] theta-integral table.  kind in {'omega', 'psi'}."""
        import scipy.integrate

        l, m, nu = self._horizontal_indices()
        J = self.maxl**2
        it = np.zeros((J, J))

        if self._quad_mode == "quad":
            for i in range(J):
                for j in range(i, J):
                    if kind == "psi":
                        f = lambda tt: (
                            self._signed_lpmv_host(m[i], nu[i], np.cos(tt), True)
                            * self._signed_lpmv_host(m[j], nu[j], np.cos(tt), True)
                            * np.sin(tt)
                        )
                    else:
                        f = lambda tt: (
                            self._omega_t_integrand_host(tt, l[i], m[i], nu[i], True)
                            * self._omega_t_integrand_host(tt, l[j], m[j], nu[j], True)
                            / np.sin(tt) ** 3
                        )
                    val = scipy.integrate.quad(f, 0.0, self.cap_lim)[0]
                    it[i, j] = it[j, i] = val
            return it

        # gauss mode: composite rules; values from accurate host seeds
        if kind == "psi":
            tq, wq = composite_legendre(
                geometric_panels(0.0, self.cap_lim, n_panels=3), 64
            )
            vals = np.stack(
                [
                    self._signed_lpmv_host(m[i], nu[i], np.cos(tq), False)
                    for i in range(J)
                ]
            )
            it = np.einsum("q,iq,jq->ij", wq * np.sin(tq), vals, vals)
        else:
            tq, wq = composite_legendre(
                geometric_panels(0.0, self.cap_lim, n_panels=8), 64
            )
            vals = np.stack(
                [
                    self._omega_t_integrand_host(tq, l[i], m[i], nu[i], False)
                    for i in range(J)
                ]
            )
            it = np.einsum("q,iq,jq->ij", wq / np.sin(tq) ** 3, vals, vals)
        return it

    def _assemble(self, iz: np.ndarray, ih: np.ndarray) -> np.ndarray:
        """Omega/Psi[n, n'] = Iz[k, k'] * Ih[j, j'] via outer gathers."""
        k = self._k
        j = self._l * (self._l + 1) + self._m
        return iz[np.ix_(k, k)] * ih[np.ix_(j, j)]

    def eval_omega(self):
        """Curvature regularization matrix (reference sphharmlag.py:188-212)."""
        iz = self._iz_table(power=-2)
        it = self._it_table("omega")
        ip = self._ip_table()
        return self._assemble(iz, it * ip)

    def eval_psi(self):
        """0th-order regularization matrix (reference sphharmlag.py:215-239)."""
        iz = self._iz_table(power=2)
        it = self._it_table("psi")
        ip = self._ip_table()
        return self._assemble(iz, it * ip)

    def eval_tau(self, reg_func):
        """Tau vector [nbasis, 1] of data-informed 0th-order regularization
        toward the profile ``reg_func(z)`` (reference sphharmlag.py:241-259;
        volumetricinterp_tpu/models/sphharmlag.py:683-744): 'quad' mode
        takes the reference's adaptive scipy.integrate.quad per integral;
        'gauss' mode the same separable integrals on fixed Gauss-Laguerre /
        Gauss-Legendre nodes, with the azimuth integral in closed form (2 pi
        for m = 0, exactly 0 otherwise)."""
        import scipy.integrate
        import scipy.special as sp

        if self._quad_mode == "quad":
            tau = np.zeros((self.nbasis, 1))
            for n in range(self.nbasis):
                k, m = int(self._k[n]), int(self._m[n])
                v = float(self._nu[n])
                z_int = lambda zz: (np.exp(-0.5 * zz) * sp.eval_laguerre(k, zz)
                                    * reg_func(zz) * zz**2)
                t_int = lambda tt: sp.lpmv(m, v, np.cos(tt)) * np.sin(tt)
                p_int = lambda pp: self._az_host(v, m, pp)
                tau[n] = (scipy.integrate.quad(z_int, 0.0, self.max_z_int)[0]
                          * scipy.integrate.quad(t_int, 0.0, self.cap_lim)[0]
                          * scipy.integrate.quad(p_int, 0.0, 2.0 * np.pi)[0])
            return tau

        # gauss mode: z on Gauss-Laguerre (e^{-z} folded in, the integrand
        # carries the residual e^{+z/2}) or mapped Legendre for a finite
        # MAX_Z_INT; theta on Gauss-Legendre over [0, cap_lim]
        K = self.maxk
        if math.isinf(self.max_z_int):
            zq, wz = gauss_laguerre(8 * K + 48)
        else:
            xq, wl = np.polynomial.legendre.leggauss(8 * K + 32)
            zq = 0.5 * self.max_z_int * (xq + 1.0)
            wz = 0.5 * self.max_z_int * wl * np.exp(-zq)
        fz = np.exp(0.5 * zq) * reg_func(zq) * zq**2
        lagv = np.stack(
            [np.polynomial.laguerre.lagval(zq, np.eye(K)[k]) for k in range(K)])
        iz = lagv @ (wz * fz)  # [K]

        tq, wt = np.polynomial.legendre.leggauss(96)
        tq = 0.5 * self.cap_lim * (tq + 1.0)
        wt = 0.5 * self.cap_lim * wt
        tau = np.zeros((self.nbasis, 1))
        for n in range(self.nbasis):
            k, m = int(self._k[n]), int(self._m[n])
            if m != 0:
                continue  # the azimuth integral vanishes exactly
            v = float(self._nu[n])
            it = float(np.sum(wt * sp.lpmv(m, v, np.cos(tq)) * np.sin(tq)))
            # az(nu, 0, .) is constant: its integral is 2 pi az(nu, 0, 0)
            tau[n] = iz[k] * it * 2.0 * np.pi * float(self._az_host(v, 0, 0.0))
        return tau
