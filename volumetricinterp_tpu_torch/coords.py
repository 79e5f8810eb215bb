"""Geodetic coordinate transforms.

Host numpy float64 halves (``np_geodetic2ecef``, ``np_geodetic_to_cap``,
``ecef2geodetic``, ``cap_rotation_axis_angle``, ``rodrigues_rotate``) are
copies of the JAX package's: the fit's design matrix, Estimate's point API
and gradients, and Validate's plot grid transform on the host in exact
float64.  ``geodetic2ecef`` is their torch twin.  ``cap_rotation`` gives
the rotation constants of the cap transform, and ``geodetic_to_cap`` is
the torch transform used by the grid evaluator's plain version; both follow
models/sphharmlag.py:324-359 of the reference, including its +theta0
rotation quirk (docs/PARITY_NOTES.md #1).
"""

from __future__ import annotations

import numpy as np

from .constants import RE, WGS84_A, WGS84_B, WGS84_E2, WGS84_EP2


def np_geodetic2ecef(gdlat, gdlon, gdalt):
    """Geodetic (deg, deg, m) -> ECEF (m), WGS-84, host float64."""
    lat = np.deg2rad(np.asarray(gdlat, dtype=np.float64))
    lon = np.deg2rad(np.asarray(gdlon, dtype=np.float64))
    alt = np.asarray(gdalt, dtype=np.float64)
    sin_lat = np.sin(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat**2)
    x = (n + alt) * np.cos(lat) * np.cos(lon)
    y = (n + alt) * np.cos(lat) * np.sin(lon)
    z = (n * (1.0 - WGS84_E2) + alt) * sin_lat
    return x, y, z


def geodetic2ecef(gdlat, gdlon, gdalt):
    """Geodetic (deg, deg, m) -> ECEF (m), WGS-84, torch in the inputs'
    dtype and on their device (the radbasfun grid evaluator's float64
    transform)."""
    import torch

    lat = torch.deg2rad(gdlat)
    lon = torch.deg2rad(gdlon)
    sin_lat = torch.sin(lat)
    n = WGS84_A / torch.sqrt(1.0 - WGS84_E2 * sin_lat**2)
    x = (n + gdalt) * torch.cos(lat) * torch.cos(lon)
    y = (n + gdalt) * torch.cos(lat) * torch.sin(lon)
    z = (n * (1.0 - WGS84_E2) + gdalt) * sin_lat
    return x, y, z


def ecef2geodetic(x, y, z):
    """ECEF (m) -> geodetic (deg, deg, m), WGS-84, host float64: a Bowring
    seed and five fixed-point rounds (volumetricinterp_tpu/coords.py:37)."""
    x, y, z = (np.asarray(a, dtype=np.float64) for a in (x, y, z))
    p = np.sqrt(x**2 + y**2)
    theta = np.arctan2(z * WGS84_A, p * WGS84_B)
    st, ct = np.sin(theta), np.cos(theta)
    lat = np.arctan2(z + WGS84_EP2 * WGS84_B * st**3,
                     p - WGS84_E2 * WGS84_A * ct**3)
    for _ in range(5):
        sin_lat = np.sin(lat)
        n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat**2)
        lat = np.arctan2(z + WGS84_E2 * n * sin_lat, p)
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat**2)
    # altitude: p-based away from the poles, z-based near them
    alt = np.where(
        np.abs(cos_lat) > 1e-6,
        p / np.where(np.abs(cos_lat) < 1e-12, 1.0, cos_lat) - n,
        z / np.where(np.abs(sin_lat) < 1e-12, 1.0, sin_lat)
        - n * (1.0 - WGS84_E2))
    return np.rad2deg(lat), np.rad2deg(np.arctan2(y, x)), alt


def cap_rotation_axis_angle(latcp, loncp):
    """(axis k [3], angle theta0) of the rotation in the cap transform
    (models/sphharmlag.py:345-349): theta0 the geocentric colatitude of the
    cap centre at 0 altitude, k horizontal, 90 degrees east of it."""
    x0, y0, z0 = np_geodetic2ecef(latcp, loncp, 0.0)
    theta0 = np.arccos(z0 / np.sqrt(x0**2 + y0**2 + z0**2))
    phi0 = np.arctan2(y0, x0)
    k = np.array([np.cos(phi0 + np.pi / 2.0), np.sin(phi0 + np.pi / 2.0),
                  0.0])
    return k, theta0


def rodrigues_rotate(k, theta, vx, vy, vz):
    """Vectors (vx, vy, vz) rotated by theta about the unit axis k:
    v cos t + (k x v) sin t + k (k.v)(1 - cos t)."""
    ct, st = np.cos(theta), np.sin(theta)
    kx, ky, kz = k[0], k[1], k[2]
    cx = ky * vz - kz * vy
    cy = kz * vx - kx * vz
    cz = kx * vy - ky * vx
    kdv = kx * vx + ky * vy + kz * vz
    return (vx * ct + cx * st + kx * kdv * (1.0 - ct),
            vy * ct + cy * st + ky * kdv * (1.0 - ct),
            vz * ct + cz * st + kz * kdv * (1.0 - ct))


def np_geodetic_to_cap(gdlat, gdlon, gdalt, latcp, loncp):
    """Geodetic -> cap coordinates (z, theta, phi), host float64."""
    x0, y0, z0 = np_geodetic2ecef(latcp, loncp, 0.0)
    r0 = np.sqrt(x0**2 + y0**2 + z0**2)
    theta0 = np.arccos(z0 / r0)
    phi0 = np.arctan2(y0, x0)
    k = np.array(
        [np.cos(phi0 + np.pi / 2.0), np.sin(phi0 + np.pi / 2.0), 0.0]
    )
    x, y, z = np_geodetic2ecef(gdlat, gdlon, gdalt)
    ct, st = np.cos(theta0), np.sin(theta0)
    cx = k[1] * z - k[2] * y
    cy = k[2] * x - k[0] * z
    cz = k[0] * y - k[1] * x
    kdv = k[0] * x + k[1] * y + k[2] * z
    rx = x * ct + cx * st + k[0] * kdv * (1.0 - ct)
    ry = y * ct + cy * st + k[1] * kdv * (1.0 - ct)
    rz = z * ct + cz * st + k[2] * kdv * (1.0 - ct)
    r = np.sqrt(rx**2 + ry**2 + rz**2)
    t = np.arccos(rz / r)
    p = np.arctan2(ry, rx)
    return 100.0 * (r / RE - 1.0), t, p


def cap_rotation(latcp, loncp):
    """Rotation constants (kx, ky, cos theta0, sin theta0) of the cap
    transform, computed on the host in float64 exactly as the TPU kernel's
    launcher does (grid_eval_pallas.py:223-228).  The axis k = (kx, ky, 0)
    is horizontal, 90 degrees east of the cap centre."""
    x0, y0, z0 = np_geodetic2ecef(latcp, loncp, 0.0)
    th0 = float(np.arccos(z0 / np.sqrt(x0**2 + y0**2 + z0**2)))
    phi0 = float(np.arctan2(y0, x0))
    return (float(np.cos(phi0 + np.pi / 2.0)),
            float(np.sin(phi0 + np.pi / 2.0)),
            float(np.cos(th0)), float(np.sin(th0)))


def geodetic_to_cap(gdlat, gdlon, gdalt, rot):
    """Torch geodetic -> rotated-frame quantities, in the inputs' dtype.

    ``rot`` is ``cap_rotation(latcp, loncp)``; its constants are rounded
    to the inputs' dtype first, as the kernel receives them.  Returns
    (z, theta, cos phi, sin phi): theta as atan2(rho, rz) with rho the
    rotated frame's horizontal radius (the same angle as the reference's
    arccos(rz / r), without the cancellation of 1 - q^2 near the pole), and
    cos/sin(phi) as rx/rho, ry/rho, so phi itself is never formed."""
    import torch

    # python-float constants enter float32 arithmetic rounded to float32,
    # exactly as the kernel's float constants do
    kx, ky, ct0, st0 = rot
    if gdlat.dtype == torch.float32:
        kx, ky, ct0, st0 = (float(np.float32(c)) for c in rot)
    latr = gdlat * (np.pi / 180.0)
    lonr = gdlon * (np.pi / 180.0)
    sla, cla = torch.sin(latr), torch.cos(latr)
    nrad = WGS84_A / torch.sqrt(1.0 - WGS84_E2 * sla * sla)
    rho = (nrad + gdalt) * cla
    x = rho * torch.cos(lonr)
    y = rho * torch.sin(lonr)
    zz = (nrad * (1.0 - WGS84_E2) + gdalt) * sla
    kdv = kx * x + ky * y
    omc = 1.0 - ct0
    rx = x * ct0 + ky * zz * st0 + kx * kdv * omc
    ry = y * ct0 - kx * zz * st0 + ky * kdv * omc
    rz = zz * ct0 + (kx * y - ky * x) * st0
    r2h = rx * rx + ry * ry
    rho_h = torch.sqrt(torch.clamp(r2h, min=1e-30))
    r = torch.sqrt(r2h + rz * rz)
    theta = torch.atan2(rho_h, rz)
    z = 100.0 * (r * (1.0 / RE) - 1.0)
    return z, theta, rx / rho_h, ry / rho_h
