"""Host seconds of Estimate's grid_hash phase (the content hash of the
request's grid) over the window, per request."""


def read(run):
    if run["traffic"]["op"] != "product" or "grid_hash" not in run["phases"]:
        return None
    return run["phases"]["grid_hash"] / run["ops"]
