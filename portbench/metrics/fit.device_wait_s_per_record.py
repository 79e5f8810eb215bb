"""Seconds of Interpolate's span device_wait (the main thread's stream
synchronize after a chunk's search, before its copy to the host: device
work the host did not overlap) over the window, per fitted record.  A
program without the span reads nothing."""


def read(run):
    if run["traffic"]["op"] != "fit" or "device_wait" not in run["phases"]:
        return None
    return run["phases"]["device_wait"] / run["ops"]
