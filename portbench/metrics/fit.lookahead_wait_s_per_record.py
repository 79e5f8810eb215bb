"""Seconds of Interpolate's span lookahead_wait (the main thread waiting
for the worker's prepare_chunk of the next chunk: the look-ahead's time
that the search before it did not hide) over the window, per fitted
record.  A program without the span reads nothing."""


def read(run):
    if run["traffic"]["op"] != "fit" or "lookahead_wait" not in run["phases"]:
        return None
    return run["phases"]["lookahead_wait"] / run["ops"]
