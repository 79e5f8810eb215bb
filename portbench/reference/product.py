"""The plain reference of a volume product: the FoV hull test of every grid
point and the field at sampled points, from the benchmark's own inputs.

The hull is the convex hull of the data points (scipy's qhull), and a point
is inside when it lies inside or on it: max over facets of (n . x + b) <=
tol * max |b|, the reference's per-point vertex comparison as a half-space
test.  The test runs in plain torch, float64, on whatever device holds the
grid.  The field is the reference basis (model.basis, float64) times the
coefficients.

The control, one precision below the product's float32: the contraction in
TF32 (both operands rounded to 10 mantissa bits, as the tensor cores do),
and the hull test in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from .model import WGS84_A, WGS84_E2, basis, geodetic2ecef

HULL_TOL = 1e-8


def hull_equations(lat, lon, alt):
    """Facet equations [nfacet, 4] of the data points' convex hull."""
    from scipy.spatial import ConvexHull

    return ConvexHull(np.stack(geodetic2ecef(lat, lon, alt), axis=-1)).equations


def inside(eqs, lat, lon, alt, dtype=torch.float64, chunk=1 << 22):
    """Inside-or-on-the-hull mask (bool tensor [points]) of the grid points
    lat, lon, alt (flat tensors on one device), computed in ``dtype``."""
    eqs = torch.as_tensor(eqs, dtype=dtype, device=lat.device)
    nT, b = eqs[:, :3].T, eqs[:, 3]
    thr = HULL_TOL * b.abs().max()
    out = torch.empty(lat.numel(), dtype=torch.bool, device=lat.device)
    for s in range(0, lat.numel(), chunk):
        la = torch.deg2rad(lat[s:s + chunk].to(dtype))
        lo = torch.deg2rad(lon[s:s + chunk].to(dtype))
        al = alt[s:s + chunk].to(dtype)
        n = WGS84_A / torch.sqrt(1.0 - WGS84_E2 * torch.sin(la) ** 2)
        P = torch.stack([(n + al) * torch.cos(la) * torch.cos(lo),
                         (n + al) * torch.cos(la) * torch.sin(lo),
                         (n * (1.0 - WGS84_E2) + al) * torch.sin(la)], -1)
        out[s:s + chunk] = (P @ nT + b).amax(-1) <= thr
    return out


def tf32(x):
    """float32 values rounded to TF32's 10 mantissa bits (nearest, ties
    away from zero)."""
    bits = np.asarray(x, np.float32).view(np.int32)
    return ((bits + np.int32(1 << 12)) & np.int32(~0x1FFF)).view(np.float32)


def field(model, C, lat, lon, alt, control=False):
    """(values [records, points], gross [records, points]) at geodetic
    points: the sum over basis functions of C_n B_n and of |C_n B_n|; with
    ``control``, the values of the TF32 contraction instead."""
    B = basis(model, lat, lon, alt)
    gross = np.abs(C) @ np.abs(B).T
    if control:
        return tf32(C).astype(np.float64) @ tf32(B).astype(np.float64).T, gross
    return C @ B.T, gross
