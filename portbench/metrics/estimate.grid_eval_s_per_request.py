"""Host seconds of Estimate's grid_eval phase (the kernel launches and the
copies of the volumes to the host) over the window, per request."""


def read(run):
    if run["traffic"]["op"] != "product" or "grid_eval" not in run["phases"]:
        return None
    return run["phases"]["grid_eval"] / run["ops"]
