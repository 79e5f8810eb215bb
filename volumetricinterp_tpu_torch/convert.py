"""State carried over from the JAX package.

The "weights" of this system are a grid evaluator's band table and a
record's fitted coefficients.  Coefficient FILES need no conversion (the
schema is shared); these helpers convert in-memory JAX results, passed as
numpy arrays, so tests can run both packages on identical state.
"""

from __future__ import annotations

import numpy as np

from .ops.grid_eval import BandTable


def from_jax_evaluator(fields):
    """BandTable from a JAX ``GridEvaluator``'s fields, a mapping with
    ``_coef`` ([npairs_pad, D], evaluator dtype), ``pair_degree``,
    ``_mbar_pair``, ``theta_lo``, ``theta_hi`` and ``degree``.  Pass it as
    ``GridEvaluator(model, table=...)``."""
    mbar = np.asarray(fields["_mbar_pair"], np.int64)
    D = int(fields["degree"])
    coef = np.asarray(fields["_coef"], np.float64)[: mbar.size, :D].T
    return BandTable(coef=np.ascontiguousarray(coef),
                     pair_degree=np.asarray(fields["pair_degree"], np.int64),
                     mbar_pair=mbar, theta_lo=float(fields["theta_lo"]),
                     theta_hi=float(fields["theta_hi"]))


def coeffs_from_jax(C, dC):
    """(C [nrec, nb], dC [nrec, nb, nb]) float64 from the JAX fit_records
    output: dC there is a two-word expansion [nrec, 2, nb, nb], combined
    and symmetrized as the JAX package's cov_to_f64 does."""
    a = np.asarray(dC)
    d = a[..., 0, :, :].astype(np.float64) + a[..., 1, :, :].astype(np.float64)
    return (np.asarray(C, np.float64),
            0.5 * (d + np.swapaxes(d, -1, -2)))
