"""A cell's files cut to a size the CPU tests can hold: a 32-record day,
16-record calls (8 at nbasis 1200), a 40 x 40 x 16 grid; the cell's own
basis order unless ``order`` (MAXK, MAXL) is given."""

import copy

from portbench import harness


def tiny(workload, order=None):
    """(config, traffic, limits) of ``workload`` at the tests' size."""
    _, cfg, traffic, limits = harness.cell_files(workload)
    cfg, traffic = copy.deepcopy(cfg), dict(traffic)
    cfg["day"]["nrec"] = 32
    if order is not None:
        cfg["MODEL"]["MAXK"], cfg["MODEL"]["MAXL"] = order
    big = int(cfg["MODEL"]["MAXK"]) * int(cfg["MODEL"]["MAXL"]) ** 2 > 500
    if traffic["op"] == "fit":
        traffic.update(records_per_call=8 if big else 16, days=2,
                       check_samples=4 if big else 8)
    else:
        traffic.update(coeff_records=16, records_per_request=4,
                       check_samples=512,
                       grid=dict(traffic["grid"], nlat=40, nlon=40, nalt=16))
    return cfg, traffic, limits
