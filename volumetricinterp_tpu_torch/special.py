"""Special functions of the spherical-cap-harmonic basis, float64.

The fit's design matrix and the regularization tables are built on the
host in exact float64 (numpy/scipy), and ``BASIS_IMPL = series`` evaluates
the Legendre functions by a direct series in float64 torch
(``volumetricinterp_tpu/special.py``):

* ``np_laguerre_all``: Laguerre polynomials by the forward three-term
  recurrence (stable for the small orders used, k <= ~16).
* ``gamma_ratio`` / ``kvm``: the K_vm normalization of
  models/sphharmlag.py:305-321 (reference), in log-gamma form.
* ``lpmv_host``: machine-accurate Ferrers P_v^m with the reference's SIGNED
  m (scipy.special.lpmv for m >= 0; the Gamma-ratio connection for m < 0,
  where scipy itself underflows at large degree).
* ``laguerre_all`` / ``eval_laguerre`` / ``lpmv`` (with ``_hyp_series``):
  torch float64 twins of the JAX package's device functions, the Ferrers
  function of non-integer degree by the Gauss hypergeometric series at a
  fixed term count (200) with scipy's sign convention.  The series loses
  accuracy like exp(2 nu sin(theta/2)): ~1e-10 relative inside the default
  10 degree cap at maxl = 6 (nu ~ 94), worse beyond.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def np_laguerre_all(kmax: int, z, alpha: float = 0.0):
    """Generalized Laguerre polynomials L_0^a .. L_{kmax}^a at z, shape
    z.shape + (kmax+1,).  Forward recurrence
    (k+1) L_{k+1}^a = (2k+1+a-z) L_k^a - (k+a) L_{k-1}^a."""
    z = np.asarray(z, np.float64)
    out = [np.ones_like(z)]
    if kmax >= 1:
        out.append(1.0 + alpha - z)
    for k in range(1, kmax):
        out.append(((2 * k + 1 + alpha - z) * out[k]
                    - (k + alpha) * out[k - 1]) / (k + 1.0))
    return np.stack(out, axis=-1)


def gamma_ratio(v, m: int):
    """Gamma(v - m + 1) / Gamma(v + m + 1) for m >= 0 (underflow-safe)."""
    import scipy.special as sp

    v = np.asarray(v, np.float64)
    return np.exp(sp.gammaln(v - m + 1.0) - sp.gammaln(v + m + 1.0))


def kvm(v, m: int):
    """Normalization constant K_vm (reference models/sphharmlag.py:305-321):
    sqrt((2v+1)/(4 pi) * Gamma(v-m+1)/Gamma(v+m+1)), x sqrt(2) if m != 0.
    m is the absolute order."""
    v = np.asarray(v, np.float64)
    k = np.sqrt((2.0 * v + 1.0) / (4.0 * np.pi) * gamma_ratio(v, m))
    if m != 0:
        k = k * np.sqrt(2.0)
    return k


def lpmv_host(m: int, v: float, x):
    """Machine-accurate lpmv on host, signed-m scipy semantics.

    scipy.special.lpmv directly for m >= 0; for m < 0 the connection
    P_v^{-m} = (-1)^m Gamma(v-m+1)/Gamma(v+m+1) P_v^{m} applied to the
    accurate positive-order values (scipy underflows there at large v)."""
    import scipy.special as sp

    x = np.asarray(x, dtype=np.float64)
    if m >= 0:
        return sp.lpmv(m, v, x)
    mm = -m
    ratio = np.exp(sp.gammaln(v - mm + 1.0) - sp.gammaln(v + mm + 1.0))
    return ((-1.0) ** mm) * ratio * sp.lpmv(mm, v, x)


def _f64(x):
    """x as a float64 tensor (on its own device when it is a tensor)."""
    return (x.to(torch.float64) if torch.is_tensor(x)
            else torch.as_tensor(np.asarray(x, np.float64)))


def laguerre_all(kmax: int, z, alpha: float = 0.0):
    """Generalized Laguerre polynomials L_0^a .. L_{kmax}^a at z, float64
    torch, shape z.shape + (kmax+1,): the forward recurrence of
    ``np_laguerre_all``."""
    z = _f64(z)
    out = [torch.ones_like(z)]
    if kmax >= 1:
        out.append(1.0 + alpha - z)
    for k in range(1, kmax):
        out.append(((2 * k + 1 + alpha - z) * out[k]
                    - (k + alpha) * out[k - 1]) / (k + 1.0))
    return torch.stack(out, dim=-1)


def eval_laguerre(k: int, z, alpha: float = 0.0):
    """One generalized Laguerre polynomial L_k^alpha(z); L_{-1} = 0 (the
    reference's eval_genlaguerre(-1, 1, z) at k = 0)."""
    if k < 0:
        return torch.zeros_like(_f64(z))
    return laguerre_all(k, z, alpha)[..., k]


def _hyp_series(mm: int, v, s, nterms: int):
    """F(v+1, -v; 1+mm; s) by direct summation of ``nterms`` terms."""
    v = _f64(v).to(s.device)
    acc = torch.zeros_like(s)
    term = torch.ones_like(s)
    for k in range(nterms):
        acc = acc + term
        term = term * ((v + 1.0 + k) * (k - v) / ((1.0 + mm + k) * (1.0 + k))) * s
    return acc


def lpmv(m: int, v, x, nterms: int = 200):
    """Ferrers function P_v^m(x) with scipy.special.lpmv's convention, by
    the hypergeometric series (DLMF 14.3.1) and the integer-order
    connection (DLMF 14.9.2).  m: signed integer order; v: real degree
    (scalar or tensor); x in (-1, 1].  float64 torch."""
    x = _f64(x)
    mm = abs(m)
    F = _hyp_series(mm, v, (1.0 - x) / 2.0, nterms)
    if mm == 0:
        base = F
    else:
        # ((1-x)/(1+x))^{mm/2} -> 0 correctly as x -> 1
        base = ((1.0 - x) / (1.0 + x)) ** (mm / 2.0) * F / float(
            math.factorial(mm))
    if m < 0:
        return base
    v = _f64(v).to(x.device)
    ratio = torch.exp(torch.lgamma(v + mm + 1.0) - torch.lgamma(v - mm + 1.0))
    return ((-1.0) ** mm) * ratio * base
