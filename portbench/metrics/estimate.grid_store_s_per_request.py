"""Seconds of Estimate's span grid_store (inside grid_eval: the host copy
of a chunk's volumes into the returned array) over the window, per
request.  A program without the span reads nothing."""


def read(run):
    if run["traffic"]["op"] != "product" or "grid_store" not in run["phases"]:
        return None
    return run["phases"]["grid_store"] / run["ops"]
