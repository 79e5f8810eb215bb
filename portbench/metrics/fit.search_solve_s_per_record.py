"""Seconds of Interpolate's span search_solve (ops/fit.fit_records from the
prepared chunk to its results: every method's search and the final solve,
on the main thread) over the window, per fitted record.  A program without
the span reads nothing."""


def read(run):
    if run["traffic"]["op"] != "fit" or "search_solve" not in run["phases"]:
        return None
    return run["phases"]["search_solve"] / run["ops"]
