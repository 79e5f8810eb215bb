"""Special functions of the spherical-cap-harmonic basis, host float64.

Host halves of ``volumetricinterp_tpu/special.py``: the fit's design matrix
and the regularization tables are built on the host in exact float64, so
only the numpy/scipy functions are needed here.

* ``np_laguerre_all``: Laguerre polynomials by the forward three-term
  recurrence (stable for the small orders used, k <= ~16).
* ``gamma_ratio`` / ``kvm``: the K_vm normalization of
  models/sphharmlag.py:305-321 (reference), in log-gamma form.
* ``lpmv_host``: machine-accurate Ferrers P_v^m with the reference's SIGNED
  m (scipy.special.lpmv for m >= 0; the Gamma-ratio connection for m < 0,
  where scipy itself underflows at large degree).
"""

from __future__ import annotations

import numpy as np


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
