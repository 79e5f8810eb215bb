"""Phase and span timing and fit-quality statistics for fit runs.

``PhaseTimer`` sums wall time per named phase and marks each phase as a
``torch.profiler`` range, so a profiler trace of a run shows the same phase
names the log does.  Inside a phase the timer is its thread's active timer:
``span(name)``, which any module may open, adds its seconds to the
innermost active timer of the calling thread under its own name (a thread
with none only opens the profiler range), and ``carry(fn)`` runs work
submitted to another thread as a child of the submitting thread's
innermost span.  Only a phase with no enclosing phase writes its INFO log
line.  ``span_log()`` keeps a ``Span`` record of every timed span of every
thread, stamped with ``time.time_ns()``, the clock of the profiler's own
events (utils/profiling.trace writes them into its Chrome trace).
``fit_quality_report`` summarises chi2/nu (the method's own quality
criterion), the selected regularization parameters and the failed-record
count.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import NamedTuple

import numpy as np

logger = logging.getLogger("volumetricinterp_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(name)s %(levelname)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)

_lock = threading.Lock()  # every timer's totals
_open = threading.local()  # .spans: the calling thread's open spans
_log = None  # the span log's list while span_log() is on


class Span(NamedTuple):
    """One closed span of a span log: its thread's native id, the name of
    the span that enclosed it (on its thread, or on the thread that
    submitted its work) and its ends in ``time.time_ns()``."""
    name: str
    thread: int
    parent: str | None
    start_ns: int
    end_ns: int


def _open_spans():
    try:
        return _open.spans
    except AttributeError:
        _open.spans = []
        return _open.spans


class _Span:
    """A timed profiler range; ``timer``: the PhaseTimer it adds to (None:
    the calling thread's innermost active one, if any).  ``seconds`` holds
    its wall time once closed."""

    __slots__ = ("name", "timer", "outer", "log", "ns0", "t0", "rf",
                 "seconds")

    def __init__(self, name, timer=None):
        self.name, self.timer = name, timer

    def __enter__(self):
        from torch.profiler import record_function

        spans = _open_spans()
        self.outer = spans[-1] if spans else None
        if self.timer is None and self.outer is not None:
            self.timer = self.outer.timer
        spans.append(self)
        self.log = _log if self.timer is not None else None
        self.rf = record_function(self.name)
        self.rf.__enter__()
        self.ns0 = time.time_ns() if self.log is not None else 0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        if self.log is not None:
            self.log.append(Span(self.name, threading.get_native_id(),
                                 self.outer.name if self.outer else None,
                                 self.ns0, time.time_ns()))
        self.rf.__exit__(*exc)
        _open_spans().pop()
        if self.timer is not None:
            self.timer._add(self.name, self.seconds)
            if self.outer is None or self.outer.timer is None:
                logger.info("phase %-24s %8.3f s", self.name, self.seconds)
        return False


def span(name):
    """A profiler range named ``name`` whose wall seconds go to the calling
    thread's innermost active PhaseTimer (none: the range alone).  As a
    context manager it gives the span, whose ``seconds`` are set on exit."""
    return _Span(name)


def carry(fn):
    """fn, made to run on another thread as a child of the calling
    thread's innermost open span: its spans have that span as parent and
    add to that span's timer."""
    spans = _open_spans()
    outer = spans[-1:]

    def run(*args, **kwargs):
        saved = _open_spans()
        _open.spans = list(outer)
        try:
            return fn(*args, **kwargs)
        finally:
            _open.spans = saved
    return run


@contextlib.contextmanager
def span_log():
    """Inside the block, a ``Span`` record of every span closed in a timer,
    on every thread, is appended to the yielded list.  One log is on at a
    time."""
    global _log
    if _log is not None:
        raise RuntimeError("a span log is already on")
    _log = log = []
    try:
        yield log
    finally:
        _log = None


class PhaseTimer:
    """Collects wall-times per named phase and span (thread-safe); also
    emits profiler ranges."""

    def __init__(self):
        self.times = {}

    def phase(self, name):
        """A span timed by this timer, which is the calling thread's active
        timer inside it."""
        return _Span(name, self)

    def _add(self, name, seconds):
        with _lock:
            self.times[name] = self.times.get(name, 0.0) + seconds

    def report(self):
        with _lock:
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
