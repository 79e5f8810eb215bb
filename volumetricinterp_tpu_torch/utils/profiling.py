"""Profiling and debug instrumentation (the JAX package's
utils/profiling.py).

* ``trace(logdir)``: a torch.profiler context over any pipeline section
  (host and, on the card, CUDA activity) that writes a Chrome trace,
  ``logdir``/trace.json, loadable in Perfetto or chrome://tracing.  The
  profile object is yielded, so the caller can read ``key_averages()``
  or ``events()``.  The profiler keeps no range that another Python
  thread opens (the fit's look-ahead worker), so the section also keeps
  the program's span log (utils/logging.span_log) and the trace gets
  every thread's spans, on the profiler's clock, as one more process,
  "program spans", with a row a thread.
* ``debug_mode()``: PyTorch's anomaly detection (NaN checks on backward
  passes) and synchronous CUDA error checks, restored on exit: it sets
  CUDA_LAUNCH_BLOCKING=1, which makes every kernel launch synchronous in a
  process that has not touched CUDA yet, and synchronizes the card on
  entry and exit, so an asynchronous CUDA error surfaces inside the block
  that caused it.  The pipeline is functional and deterministic, so this
  is the sanitizer-like mode for numerical forensics.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading

from .logging import span_log

# the Chrome trace's process id of the span rows: above Linux's largest
# pid (2**22), so no process of the trace has it
SPAN_PID = 1 << 22


@contextlib.contextmanager
def trace(logdir="vitpu_trace"):
    """Profile the enclosed section; on exit write logdir/trace.json,
    the program's spans of every thread included."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with span_log() as spans, profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    # ts 0 of the export stands for time.time_ns() = baseTimeNanoseconds;
    # a trace without the key is read as counting from the epoch
    doc["traceEvents"] += span_events(spans,
                                      doc.get("baseTimeNanoseconds", 0))
    with open(path, "w") as f:
        json.dump(doc, f)


def span_events(spans, base):
    """Chrome trace events of a span log: each span a complete event in
    microseconds from ``base`` (ns), on the SPAN_PID process's row of its
    thread, its parent span in ``args``."""
    main = threading.main_thread().native_id
    out = [{"ph": "M", "name": "process_name", "pid": SPAN_PID,
            "args": {"name": "program spans"}}]
    for tid in sorted({s.thread for s in spans}):
        out.append({"ph": "M", "name": "thread_name", "pid": SPAN_PID,
                    "tid": tid, "args": {"name": "main thread" if tid == main
                                         else f"thread {tid}"}})
    out += [{"ph": "X", "cat": "span", "name": s.name, "pid": SPAN_PID,
             "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"parent": s.parent}} for s in spans]
    return out


@contextlib.contextmanager
def debug_mode(nans=True, checks=True):
    """Anomaly detection (``nans``) and synchronous CUDA error checks
    (``checks``) inside the block."""
    import torch

    old_anomaly = torch.is_anomaly_enabled()
    old_blocking = os.environ.get("CUDA_LAUNCH_BLOCKING")
    cuda = checks and torch.cuda.is_available()
    torch.autograd.set_detect_anomaly(bool(nans))
    if checks:
        os.environ["CUDA_LAUNCH_BLOCKING"] = "1"
    try:
        if cuda:
            torch.cuda.synchronize()
        yield
        if cuda:
            torch.cuda.synchronize()
    finally:
        torch.autograd.set_detect_anomaly(old_anomaly)
        if old_blocking is None:
            os.environ.pop("CUDA_LAUNCH_BLOCKING", None)
        else:
            os.environ["CUDA_LAUNCH_BLOCKING"] = old_blocking
