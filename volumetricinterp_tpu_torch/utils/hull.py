"""Field-of-view convex hull: host construction and point test.

The reference tests a point by rebuilding a qhull hull per query point and
comparing vertex sets (estimate.py:153-178).  Since the hull vertices are
stored in the coefficient file, the equivalent test "inside or on the hull"
is a half-space check  max_f (n_f . x + b_f) <= tol * scale  against the
hull's facet equations, built once.  Host numpy copies of the JAX
package's ``compute_hull_vertices``, ``hull_equations``, ``np_check_hull``
and ``check_hull_reference`` (the reference's own per-point test, the
parity oracle), and ``check_hull``, the same half-space test in float64
torch on a device, chunked over points.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import coords
from .device import check_device

# bytes of one chunk's [points, nfacet] float64 distance matrix in check_hull
HULL_CHUNK_BYTES = 1 << 30


def compute_hull_vertices(lat, lon, alt):
    """ECEF hull vertices of the data cloud (interpolate.py:409-426)."""
    from scipy.spatial import ConvexHull

    x, y, z = coords.np_geodetic2ecef(lat, lon, alt)
    R = np.stack([x, y, z], axis=-1)
    ch = ConvexHull(R)
    return R[ch.vertices]


def hull_equations(hull_vert):
    """Facet equations [nfacet, 4] of the hull spanned by hull_vert
    (normal . x + offset <= 0 inside)."""
    from scipy.spatial import ConvexHull

    ch = ConvexHull(np.asarray(hull_vert))
    return ch.equations


def np_check_hull(hull_eqs, gdlat, gdlon, gdalt, tol=1e-8):
    """Inside-hull mask of geodetic points, host float64, shaped like gdlat.

    Chunked over points: the dense [npts, nfacet] distance matrix of a
    33.5M-point grid would take tens of GB at once; 256k-point chunks keep
    the intermediate to a few hundred MB."""
    gdlat = np.asarray(gdlat)
    shape = gdlat.shape
    x, y, z = coords.np_geodetic2ecef(
        gdlat.ravel().astype(np.float64),
        np.asarray(gdlon, np.float64).ravel(),
        np.asarray(gdalt, np.float64).ravel(),
    )
    P = np.stack([x, y, z], axis=-1)
    eqs = np.asarray(hull_eqs)
    nT = eqs[:, :3].T
    b = eqs[None, :, 3]
    thr = tol * np.max(np.abs(eqs[:, 3]))
    n = P.shape[0]
    inside = np.empty(n, dtype=bool)
    step = 1 << 18
    for s in range(0, n, step):
        d = P[s:s + step] @ nT + b
        inside[s:s + step] = np.max(d, axis=-1) <= thr
    return inside.reshape(shape)


def check_hull(hull_eqs, gdlat, gdlon, gdalt, tol=1e-8, device="cuda",
               chunk=None):
    """Inside-hull mask of geodetic points in float64 torch on ``device``,
    a bool tensor shaped like gdlat: the half-space test of np_check_hull
    with its threshold, tol * max|offset|.

    Chunked over points: a chunk's [points, nfacet] distance matrix is kept
    near HULL_CHUNK_BYTES (``chunk`` points a chunk when given), where the
    whole matrix of a 33.5M-point grid would take ~37 GB."""
    device = check_device(device)
    shape = tuple(np.shape(gdlat))
    lat, lon, alt = (torch.as_tensor(a, dtype=torch.float64,
                                     device=device).reshape(-1)
                     for a in (gdlat, gdlon, gdalt))
    eqs = torch.as_tensor(np.asarray(hull_eqs, np.float64), device=device)
    nT, b = eqs[:, :3].T, eqs[:, 3]
    thr = tol * b.abs().max()
    n = lat.numel()
    step = chunk or max(1, HULL_CHUNK_BYTES // (8 * eqs.shape[0]))
    inside = torch.empty(n, dtype=torch.bool, device=device)
    for s in range(0, n, step):
        x, y, z = coords.geodetic2ecef(lat[s:s + step], lon[s:s + step],
                                       alt[s:s + step])
        d = torch.addmm(b, torch.stack([x, y, z], dim=-1), nT)
        inside[s:s + step] = d.amax(dim=-1) <= thr
    return inside.reshape(shape)


def check_hull_reference(hull_vert, gdlat, gdlon, gdalt):
    """Host replica of the reference's per-point vertex-set comparison
    (estimate.py:153-178): one qhull build a point, the parity oracle of
    check_hull."""
    from scipy.spatial import ConvexHull

    hull = ConvexHull(hull_vert)
    lat = np.asarray(gdlat).ravel()
    lon = np.asarray(gdlon).ravel()
    alt = np.asarray(gdalt).ravel()
    x, y, z = coords.np_geodetic2ecef(lat, lon, alt)
    out = []
    for xi, yi, zi in zip(x, y, z):
        pnts = np.append(hull_vert, np.array([[xi, yi, zi]]), axis=0)
        new_hull = ConvexHull(pnts)
        out.append(np.array_equal(hull.vertices, new_hull.vertices))
    return np.array(out).reshape(np.asarray(gdalt).shape)
