"""Field-of-view convex hull: host construction and point test.

The reference tests a point by rebuilding a qhull hull per query point and
comparing vertex sets (estimate.py:153-178).  Since the hull vertices are
stored in the coefficient file, the equivalent test "inside or on the hull"
is a half-space check  max_f (n_f . x + b_f) <= tol * scale  against the
hull's facet equations, built once.  Host numpy copies of the JAX
package's ``compute_hull_vertices``, ``hull_equations`` and
``np_check_hull``.
"""

from __future__ import annotations

import numpy as np

from .. import coords


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
