"""Matrices the fit decomposed in host LAPACK (ops/solve's
host_eigh_matrices counter) over the window, per fitted record."""


def read(run):
    if run["traffic"]["op"] != "fit":
        return None
    return run["counts"]["host_eigh_matrices"] / run["ops"]
