"""Chebyshev tables for non-integer-degree associated Legendre functions.

Float64 copy of ``volumetricinterp_tpu/tables.py``.  Each P_nu^m(cos
theta) of the basis is a smooth 1-D function of theta on the cap domain; it
is interpolated once on the host from machine-accurate scipy.special.lpmv
seeds, truncated where every function's Chebyshev tail falls below ``tol``
relative to its sup-norm, and evaluated by Clenshaw: on the host
(``np_cheb_clenshaw``) for the design matrix of numpy points, in torch on
the points' device (``cheb_clenshaw``, ``LegendreTables.eval_all``) for
tensor points.  The grid evaluator refits the same tables onto the narrow
colatitude band of a query grid.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def cheb_nodes(n: int) -> np.ndarray:
    """Chebyshev points of the first kind on [-1, 1], ascending."""
    j = np.arange(n)
    return -np.cos((2 * j + 1) * np.pi / (2 * n))


def cheb_fit(values: np.ndarray) -> np.ndarray:
    """Chebyshev coefficients from values at first-kind nodes.

    values: [n_nodes, nfun] samples of f at cheb_nodes(n_nodes).
    Returns coefficients [n_nodes, nfun] with f(x) ~= sum_k c_k T_k(x).
    """
    n = values.shape[0]
    j = np.arange(n)
    x = cheb_nodes(n)
    theta = np.arccos(x)
    T = np.cos(np.outer(j, theta))  # [k, j]
    c = (2.0 / n) * T @ values
    c[0] *= 0.5
    return c


def np_cheb_clenshaw(u, coef):
    """Host float64 Clenshaw: sum_k coef[k, :] T_k(u), u.shape + (ncols,)."""
    u = np.clip(np.asarray(u, np.float64), -1.0, 1.0)
    coef = np.asarray(coef, np.float64)
    two_u = (2.0 * u)[..., None]
    b1 = np.zeros(u.shape + (coef.shape[1],))
    b2 = np.zeros_like(b1)
    for k in range(coef.shape[0] - 1, 0, -1):
        b1, b2 = two_u * b1 - b2 + coef[k], b1
    return u[..., None] * b1 - b2 + coef[0]


def cheb_clenshaw(u, coef):
    """sum_k coef[k, :] T_k(u) by Clenshaw, u.shape + (ncols,), in torch in
    the dtype and on the device of the tensor ``u`` (clipped to [-1, 1]);
    coef: [D, ncols], an array or a tensor."""
    import torch

    u = torch.clamp(u, -1.0, 1.0)
    coef = torch.as_tensor(coef, dtype=u.dtype, device=u.device)
    two_u = (2.0 * u)[..., None]
    b1 = torch.zeros(u.shape + (coef.shape[1],), dtype=u.dtype,
                     device=u.device)
    b2 = torch.zeros_like(b1)
    for k in range(coef.shape[0] - 1, 0, -1):
        b1, b2 = two_u * b1 - b2 + coef[k], b1
    return u[..., None] * b1 - b2 + coef[0]


@dataclass
class LegendreTables:
    """Chebyshev tables of P_nu(l)^{mbar}(cos theta) on theta in [0, theta_max].

    Column layout: for each (l, mbar) pair (mbar = 0..l, pair index
    j = l(l+1)/2 + mbar) there are three columns, one per degree shift
    d in {-1, 0, +1}: column = 3*j + (d+1).
    """

    maxl: int
    cap_lim: float  # radians
    theta_max: float  # table domain upper end (radians)
    degree: int  # number of Chebyshev coefficients kept
    coef_np: np.ndarray  # [degree, 3 * maxl(maxl+1)/2] float64

    @property
    def npairs(self) -> int:
        return self.maxl * (self.maxl + 1) // 2

    def pair_index(self, l: int, mbar: int) -> int:
        return l * (l + 1) // 2 + mbar

    def column(self, l: int, mbar: int, shift: int) -> int:
        return 3 * self.pair_index(l, mbar) + (shift + 1)

    def theta_to_u(self, theta):
        return 2.0 * theta / self.theta_max - 1.0

    def eval_all(self, theta):
        """All table functions at the tensor theta, theta.shape + (ncols,),
        by Clenshaw on theta's device (float64 for float64 theta)."""
        return cheb_clenshaw(self.theta_to_u(theta), self.coef_np)

    def eval_all_np(self, theta: np.ndarray) -> np.ndarray:
        """All table functions at theta (host), theta.shape + (ncols,)."""
        u = 2.0 * np.asarray(theta) / self.theta_max - 1.0
        k = np.arange(self.degree)
        T = np.cos(np.outer(np.arccos(np.clip(u, -1.0, 1.0)), k))
        return T @ self.coef_np


def nu_of_l(l, cap_lim: float):
    """Non-integer SCH degree, Thebault et al. 2006 approximation
    (reference models/sphharmlag.py:101-115):
    nu = (2l + 0.5) pi / (2 cap_lim) - 0.5."""
    return (2.0 * np.asarray(l) + 0.5) * np.pi / (2.0 * cap_lim) - 0.5


def build_legendre_tables(
    maxl: int,
    cap_lim: float,
    theta_max: float | None = None,
    tol: float = 1e-12,
    domain_factor: float = 2.0,
) -> LegendreTables:
    """Host-side table builder (runs once per model configuration).

    Seeds from scipy.special.lpmv at Chebyshev nodes (m >= 0 only; signed-m
    values follow through the Gamma-ratio connection, see
    special.lpmv_host).  The kept Chebyshev degree is the smallest for which
    every function's tail falls below tol relative to its own sup-norm.
    """
    import scipy.special as sp

    if theta_max is None:
        theta_max = min(domain_factor * cap_lim, np.pi * 0.95)

    numax = float(nu_of_l(maxl - 1, cap_lim)) + 1.0
    # oscillation count sets the resolution requirement
    n_nodes = int(2 ** math.ceil(math.log2(max(128, 2.5 * numax * theta_max + 64))))

    u = cheb_nodes(n_nodes)
    theta = (u + 1.0) * 0.5 * theta_max
    x = np.cos(theta)

    npairs = maxl * (maxl + 1) // 2
    values = np.zeros((n_nodes, 3 * npairs))
    for l in range(maxl):
        v = float(nu_of_l(l, cap_lim))
        for mbar in range(l + 1):
            j = l * (l + 1) // 2 + mbar
            for di, d in enumerate((-1, 0, 1)):
                values[:, 3 * j + di] = sp.lpmv(mbar, v + d, x)

    coef = cheb_fit(values)

    # adaptive truncation: per-function tail below tol * sup-norm
    sup = np.max(np.abs(values), axis=0)
    sup = np.where(sup == 0.0, 1.0, sup)
    degree = 8
    for deg in range(8, n_nodes + 1):
        tail = np.max(np.abs(coef[deg:]) / sup, axis=0) if deg < n_nodes else 0.0
        if np.all(tail < tol):
            degree = deg
            break
    else:
        degree = n_nodes

    coef_np = np.ascontiguousarray(coef[:degree])
    return LegendreTables(
        maxl=maxl,
        cap_lim=cap_lim,
        theta_max=float(theta_max),
        degree=degree,
        coef_np=coef_np,
    )
