"""Host seconds a fitted record of Interpolate.calc_coeffs' preparation:
its PhaseTimer phases read_datafile, compute_hull, design_matrix and
reg_matrices over the window, per record."""

PHASES = ("read_datafile", "compute_hull", "design_matrix", "reg_matrices")


def read(run):
    ph = run["phases"]
    if run["traffic"]["op"] != "fit" or not any(p in ph for p in PHASES):
        return None
    return sum(ph.get(p, 0.0) for p in PHASES) / run["ops"]
