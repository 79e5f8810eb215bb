"""Seconds of Interpolate's look-ahead span prepare_chunk (ops/fit.
prepare_chunk on the pipeline's worker thread: a chunk's statistics and the
host eighs that depend on them alone) over the window, per fitted record.
A program without the span reads nothing."""


def read(run):
    if run["traffic"]["op"] != "fit" or "prepare_chunk" not in run["phases"]:
        return None
    return run["phases"]["prepare_chunk"] / run["ops"]
