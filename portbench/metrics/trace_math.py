"""Reduction of a torch.profiler trace to the numbers the per-layer readers
take: the device's busy time (the union of its activity intervals), each
device operation's time by name, and the idle gaps between activities,
each labelled by the program's phase (a ``PhaseTimer`` range, which is
also a profiler range) that the host was in at the gap's middle.
"""

from __future__ import annotations

import contextlib
import time

TOP = 10  # entries of each breakdown list
NAME_CHARS = 120  # a device operation's name is cut to this length


def union(intervals):
    """(total length of the union of [start, end) intervals, the merged
    intervals in order)."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def gaps(merged):
    """The idle gaps [(start, end)] between merged busy intervals."""
    return [(merged[j][1], merged[j + 1][0]) for j in range(len(merged) - 1)]


def label(t, ranges):
    """The innermost range (name, start, end) holding time t, or
    'outside_phases'."""
    best = None
    for name, a, b in ranges:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0] if best else "outside_phases"


def summarize(events, wall_s, phase_names):
    """The reduction of one traced section.  ``events``: the profiler's
    (name, is_device, start_us, end_us) tuples; ``wall_s``: the section's
    host wall time; ``phase_names``: the names of the program's phases."""
    dev = [(n, a, b) for n, d, a, b in events if d]
    busy_us, merged = union([(a, b) for _, a, b in dev])
    ops = {}
    for n, a, b in dev:
        n = n[:NAME_CHARS]
        ops[n] = ops.get(n, 0.0) + (b - a) * 1e-6
    ranges = [(n, a, b) for n, d, a, b in events
              if not d and n in phase_names]
    idle = [(label(0.5 * (a + b), ranges), (b - a) * 1e-6)
            for a, b in gaps(merged)]
    return {"busy_s": busy_us * 1e-6, "window_s": wall_s, "ops": ops,
            "idle": idle}


def merge(a, b):
    """Two traced sections' reductions as one."""
    if a is None:
        return b
    ops = dict(a["ops"])
    for n, s in b["ops"].items():
        ops[n] = ops.get(n, 0.0) + s
    return {"busy_s": a["busy_s"] + b["busy_s"],
            "window_s": a["window_s"] + b["window_s"], "ops": ops,
            "idle": a["idle"] + b["idle"]}


def breakdown(traced):
    """The result line's breakdown: the device operations that took most
    time and the longest idle gaps by the host's phase."""
    ops = sorted(traced["ops"].items(), key=lambda x: -x[1])[:TOP]
    idle = sorted(traced["idle"], key=lambda x: -x[1])[:TOP]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}


@contextlib.contextmanager
def profiled(device, phase_names):
    """Profile the enclosed section (host and, on the card, CUDA
    activity); the yielded dict gets the section's reduction on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = {}
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield out
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    # a phase's profiler range is also drawn on the device's timeline, as
    # a user annotation that spans the phase: it is no device activity
    events = [(ev.name, ev.device_type == cuda, ev.time_range.start,
               ev.time_range.end) for ev in prof.events()
              if not (ev.device_type == cuda
                      and (ev.name in phase_names
                           or getattr(ev, "is_user_annotation", False)))]
    out.update(summarize(events, wall, phase_names))
