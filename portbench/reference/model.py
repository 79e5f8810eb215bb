"""The plain reference model: the spherical-cap harmonic x Laguerre basis
and its 0th-order regularization matrix, in NumPy and SciPy.

The basis is a frozen copy of the independent oracle the port's tests hold
it to (the reference's semantics: B_n = e^{-z/2} L_k(z) K_vm trig(|m| phi)
P_nu^m(cos theta), signed m passed to scipy.special.lpmv; WGS84 geodetic to
ECEF, a Rodrigues rotation of the cap centre to the pole, z = 100 (r/RE -
1)).  The 0th-order matrix Psi[n, n'] = Iz[k, k'] It[j, j'] Ip[j, j'] is
separable: each factor is taken on fixed Gauss nodes, all pairs at once,
where the reference's adaptive quadrature per pair cannot reach nbasis
1200.  ``model`` is a configuration's dict of [MODEL] keys.
"""

from __future__ import annotations

import numpy as np
import scipy.special as sp

RE = 6371.2 * 1000.0
WGS84_A = 6378137.0
WGS84_B = 6356752.314245179
WGS84_E2 = 1.0 - (WGS84_B / WGS84_A) ** 2


def geodetic2ecef(lat, lon, alt):
    lat = np.deg2rad(np.asarray(lat, dtype=np.float64))
    lon = np.deg2rad(np.asarray(lon, dtype=np.float64))
    alt = np.asarray(alt, dtype=np.float64)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * np.sin(lat) ** 2)
    x = (n + alt) * np.cos(lat) * np.cos(lon)
    y = (n + alt) * np.cos(lat) * np.sin(lon)
    z = (n * (1.0 - WGS84_E2) + alt) * np.sin(lat)
    return x, y, z


def cap_coords(lat, lon, alt, latcp, loncp):
    """(z, theta, phi) of geodetic points in the cap frame."""
    x0, y0, z0 = geodetic2ecef(latcp, loncp, 0.0)
    theta0 = np.arccos(z0 / np.sqrt(x0**2 + y0**2 + z0**2))
    phi0 = np.arctan2(y0, x0)
    k = np.array([np.cos(phi0 + np.pi / 2.0), np.sin(phi0 + np.pi / 2.0), 0.0])
    R = np.stack(geodetic2ecef(lat, lon, alt), axis=-1)
    Rr = (R * np.cos(theta0) + np.cross(k, R) * np.sin(theta0)
          + np.outer(R @ k, k) * (1.0 - np.cos(theta0)))
    r = np.linalg.norm(Rr, axis=-1)
    return (100.0 * (r / RE - 1.0), np.arccos(Rr[:, 2] / r),
            np.arctan2(Rr[:, 1], Rr[:, 0]))


def indices(model):
    """(k, l, m, nu) of every basis function n = k L^2 + l (l + 1) + m."""
    maxk, maxl = int(model["MAXK"]), int(model["MAXL"])
    n = np.arange(maxk * maxl**2)
    k, r = n // maxl**2, n % maxl**2
    l = np.floor(np.sqrt(r)).astype(int)
    m = r - l * (l + 1)
    cap = np.deg2rad(float(model["CAP_LIM"]))
    return k, l, m, (2 * l + 0.5) * np.pi / (2 * cap) - 0.5


def _kvm(v, mbar):
    # the gamma ratio in logs: gamma(v + mbar + 1) overflows at nu > 170
    kv = np.sqrt((2 * v + 1) / (4 * np.pi) * np.exp(
        sp.gammaln(v - mbar + 1) - sp.gammaln(v + mbar + 1)))
    return np.where(mbar != 0, kv * np.sqrt(2.0), kv)


def _azimuth(v, m, phi):
    """[points, functions]: K_vm times cos(|m| phi), or sin for m < 0."""
    am = np.abs(m)
    return _kvm(v, am) * np.where(m < 0, np.sin(am * phi[:, None]),
                                  np.cos(am * phi[:, None]))


def basis(model, lat, lon, alt):
    """The design matrix [points, nbasis] at geodetic points."""
    z, t, p = cap_coords(np.ravel(lat), np.ravel(lon), np.ravel(alt),
                         float(model["LATCP"]), float(model["LONCP"]))
    k, _, m, v = indices(model)
    radial = np.exp(-0.5 * z)[:, None] * sp.eval_laguerre(k, z[:, None])
    return radial * _azimuth(v, m, p) * sp.lpmv(m, v, np.cos(t)[:, None])


def psi(model, nz=96, nt=512, nphi=256):
    """The 0th-order regularization matrix [nbasis, nbasis]."""
    if str(model["MAX_Z_INT"]).upper() != "INF":
        raise ValueError("the reference integrates z over [0, inf) only")
    k, l, m, v = indices(model)
    maxk, L2 = int(model["MAXK"]), int(model["MAXL"]) ** 2
    zq, wz = sp.roots_laguerre(nz)  # weight e^{-z} folded in
    lag = sp.eval_laguerre(np.arange(maxk)[:, None], zq[None, :])
    Iz = (lag * wz * zq**2) @ lag.T  # [K, K]

    r = slice(0, L2)  # the angular functions of k = 0 are all of them
    cap = np.deg2rad(float(model["CAP_LIM"]))
    tq, wt = np.polynomial.legendre.leggauss(nt)
    tq, wt = 0.5 * cap * (tq + 1.0), 0.5 * cap * wt
    P = sp.lpmv(m[r][None, :], v[r][None, :], np.cos(tq)[:, None])
    It = (P * (wt * np.sin(tq))[:, None]).T @ P  # [L2, L2]
    pq, wp = np.polynomial.legendre.leggauss(nphi)
    pq, wp = np.pi * (pq + 1.0), np.pi * wp
    Z = _azimuth(v[r], m[r], pq)
    Ip = (Z * wp[:, None]).T @ Z
    ang = It * Ip
    return Iz[np.ix_(k, k)] * ang[np.ix_(np.arange(len(k)) % L2,
                                         np.arange(len(k)) % L2)]
