"""Fixed-order quadrature rules for regularization-matrix integrals.

Host numpy copy of ``volumetricinterp_tpu/quadrature.py``.  Replaces
adaptive scipy.integrate.quad (models/sphharmlag.py:208-210,
234-236, 255-257) with static Gauss rules, and exploits
the separability of every regularization integral (the z-, theta-, and
phi-integrands each depend on only a subset of the pair indices, see
algorithm_docs/amisr_fit_documentation.tex:310-315) to replace the
reference's O(nbasis^2) x 3 adaptive quadratures with three small 1-D
integral tables combined by outer products.

Two modes are provided by the model layer:
* 'quad'  — host scipy.integrate.quad per 1-D table entry: numerically
            identical to the reference (including its behaviour on the
            DIVERGENT curvature z-integral; see docs/PARITY_NOTES.md).
* 'gauss' — the rules below, pure numpy, well-defined and fast.
"""

from __future__ import annotations

import numpy as np


def gauss_legendre(n: int, a: float, b: float):
    """n-point Gauss-Legendre nodes/weights on [a, b] (host numpy)."""
    x, w = np.polynomial.legendre.leggauss(n)
    xm, xr = 0.5 * (b + a), 0.5 * (b - a)
    return xm + xr * x, xr * w


def gauss_laguerre(n: int):
    """n-point Gauss-Laguerre nodes/weights (weight e^{-z} on [0, inf))."""
    return np.polynomial.laguerre.laggauss(n)


def composite_legendre(panels, n: int):
    """Composite Gauss-Legendre over consecutive panels [(a0,b0), ...]."""
    xs, ws = [], []
    for a, b in panels:
        x, w = gauss_legendre(n, a, b)
        xs.append(x)
        ws.append(w)
    return np.concatenate(xs), np.concatenate(ws)


def geometric_panels(a: float, b: float, n_panels: int = 6, ratio: float = 4.0):
    """Panels of [a, b] geometrically refined toward a (integrable
    endpoint singularities, e.g. the 1/sin^3 prefactor of the curvature
    theta-integrand, models/sphharmlag.py:205)."""
    edges = [b]
    for _ in range(n_panels - 1):
        edges.append(a + (edges[-1] - a) / ratio)
    edges.append(a)
    edges = edges[::-1]
    return list(zip(edges[:-1], edges[1:]))
