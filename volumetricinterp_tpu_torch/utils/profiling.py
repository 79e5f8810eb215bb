"""Profiling and debug instrumentation (the JAX package's
utils/profiling.py).

* ``trace(logdir)``: a torch.profiler context over any pipeline section
  (host and, on the card, CUDA activity) that writes a Chrome trace,
  ``logdir``/trace.json, loadable in Perfetto or chrome://tracing.  The
  profile object is yielded, so the caller can read ``key_averages()``
  or ``events()``.
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
import os


@contextlib.contextmanager
def trace(logdir="vitpu_trace"):
    """Profile the enclosed section; on exit write logdir/trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
