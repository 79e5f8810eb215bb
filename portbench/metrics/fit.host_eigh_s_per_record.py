"""Seconds in host_eigh (ops/solve's host_eigh_seconds counter, summed over
the calling threads, so it can exceed wall time) over the window, per
fitted record."""


def read(run):
    if run["traffic"]["op"] != "fit":
        return None
    return run["counts"]["host_eigh_seconds"] / run["ops"]
