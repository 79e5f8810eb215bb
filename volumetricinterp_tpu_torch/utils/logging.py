"""Phase timing and fit-quality statistics for fit runs.

``PhaseTimer`` sums wall time per named phase and marks each phase as a
``torch.profiler`` range, so a profiler trace of a run shows the same phase
names the log does.  ``fit_quality_report`` summarises chi2/nu (the
method's own quality criterion), the selected regularization parameters and
the failed-record count.
"""

from __future__ import annotations

import contextlib
import logging
import time

import numpy as np

logger = logging.getLogger("volumetricinterp_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(name)s %(levelname)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


class PhaseTimer:
    """Collects wall-times per named phase; also emits profiler ranges."""

    def __init__(self):
        self.times = {}

    @contextlib.contextmanager
    def phase(self, name):
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        dt = time.perf_counter() - t0
        self.times[name] = self.times.get(name, 0.0) + dt
        logger.info("phase %-24s %8.3f s", name, dt)

    def report(self):
        return dict(self.times)


def fit_quality_report(chi2, nvalid, reg_params, reg_list):
    """Summarize per-record goodness-of-fit; returns a dict and logs it."""
    chi2 = np.asarray(chi2)
    nvalid = np.asarray(nvalid)
    ok = np.isfinite(chi2)
    ratio = chi2[ok] / np.maximum(nvalid[ok], 1)
    rep = {
        "n_records": int(chi2.size),
        "n_failed": int((~ok).sum()),
        "chi2_over_nu_median": float(np.median(ratio)) if ratio.size else np.nan,
        "chi2_over_nu_p90": float(np.percentile(ratio, 90)) if ratio.size else np.nan,
    }
    for i, name in enumerate(reg_list):
        vals = np.asarray(reg_params)[:, i]
        v = vals[np.isfinite(vals) & (vals > 0)]
        rep[f"log10_alpha_{name}_median"] = (
            float(np.median(np.log10(v))) if v.size else np.nan
        )
    logger.info(
        "fit quality: %d records, %d failed, chi2/nu median %.3f p90 %.3f",
        rep["n_records"], rep["n_failed"],
        rep["chi2_over_nu_median"], rep["chi2_over_nu_p90"],
    )
    return rep
