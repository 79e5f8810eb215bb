"""The device's idle share in the traced fit calls: 1 - (the union of its
CUDA activity intervals / the traced wall time)."""


def read(run):
    tr = run["trace"]
    if run["traffic"]["op"] != "fit" or tr is None or tr["busy_s"] <= 0.0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
