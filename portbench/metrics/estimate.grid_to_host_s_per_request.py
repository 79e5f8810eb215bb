"""Seconds of Estimate's span grid_to_host (inside grid_eval: a chunk's
blk.cpu(), the wait for its kernel and the pageable copy of its volumes to
the host) over the window, per request.  A program without the span reads
nothing."""


def read(run):
    ph = run["phases"]
    if run["traffic"]["op"] != "product" or "grid_to_host" not in ph:
        return None
    return ph["grid_to_host"] / run["ops"]
