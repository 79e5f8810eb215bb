#!/usr/bin/env python
"""Build tests/oracle/day1000_seed1_window64_<tag>.npz, or, for the tag
timeaxis, tests/oracle/day1000_seed1_timeaxis.npz.

The JAX package's CPU float64 fit of the first 64 records of the seed-1
synthetic day (nrec=1000, nan_frac=0.03, bad_frac=0.01, basis-projected
truth at MAXK=4/MAXL=6, QUAD_MODE = gauss, REGULARIZATION_LIST = 0thorder:
scripts/day_check.py's day), in one of four settings:

    tag          REGULARIZATION_METHOD  REGPARAM_MODE
    exact_grid   chi2                   exact_grid
    exact        chi2                   exact
    fast         chi2                   fast
    gcv          gcv                    exact

Stores C [64, 144], chi2 [64] and reg [64, 1].  chip_smoke.py holds the
PyTorch port's fit of the same window in the same setting against it in
the W-weighted field residual (docs/PARITY_NOTES.md #7);
tests/oracle/day1000_seed1_oracle.npz has no coefficients.

timeaxis: the whole seed-1 day through the JAX package's
Interpolate.calc_coeffs in the default exact mode with
REGULARIZATION_PROFILE = chapman,1e11,300,50 and TIME_SMOOTHING = gcv,
then its fit_time_coupled at TIME_COUPLING = 1e-4 on the searched alphas,
as calc_coeffs runs it when TIME_COUPLING is set.  Stores the independent
C [1000, 144], chi2 [1000] and reg [1000, 1], the joint C_joint and
chi2_joint, the /TimeFit payload knots, S and lam, and the day's QC'd
value and error [1000, 600]: the synthetic day's projection of its truth
(a least-squares solve at rcond 1e-10) follows the LAPACK build in its
last bits, and chip_smoke.py phase 4e feeds the joint solve these bytes.

Wall time of one run on an 8-core x86 CPU host (JAX 0.9.0, float64, cold
compile included): exact_grid not recorded; exact 65 s; fast 21 s; gcv
62 s; timeaxis 1,928 s, beside other work on the same 8 cores.

Usage:  JAX_PLATFORMS=cpu python scripts/window_oracle.py [tag]
        (default tag: exact_grid)
"""
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NWIN = 64
SETTINGS = {"exact_grid": ("chi2", "exact_grid"), "exact": ("chi2", "exact"),
            "fast": ("chi2", "fast"), "gcv": ("gcv", "exact")}
CFG = """
[DEFAULT]
REGULARIZATION_LIST = 0thorder
REGULARIZATION_METHOD = chi2
[MODEL]
NAME = sphharmlag
MAXK = 4
MAXL = 6
CAP_LIM = 10
MAX_Z_INT = INF
LATCP = 78
LONCP = 262
[TPU]
QUAD_MODE = gauss
"""


PROFILE = "chapman,1e11,300,50"
TIME_COUPLING = 1e-4


def timeaxis():
    """The timeaxis oracle (see the module docstring)."""
    from volumetricinterp_tpu.config import Config
    from volumetricinterp_tpu.interpolate import Interpolate
    from volumetricinterp_tpu.io.synth import write_synthetic_amisr
    from volumetricinterp_tpu.models.sphharmlag import Model
    from volumetricinterp_tpu.ops.timejoint import fit_time_coupled

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "day.h5")
        text = CFG.replace("[DEFAULT]", f"""[DEFAULT]
FILENAME = {raw}
REGULARIZATION_PROFILE = {PROFILE}
TIME_SMOOTHING = gcv""")
        write_synthetic_amisr(raw, nrec=1000, seed=1,
                              smooth_in_model=Model(Config.from_text(text)),
                              nan_frac=0.03, bad_frac=0.01)
        interp = Interpolate(Config.from_text(text))
        interp.calc_coeffs()
        _, lat, lon, alt, value, error = interp.read_datafile(raw)
    A = np.asarray(interp.model.basis(lat, lon, alt))
    R = np.asarray(interp.model.eval_psi())[None]
    with np.errstate(divide="ignore"):
        la = np.log10(np.where(interp.reg_params > 0, interp.reg_params, 0.0))
    C_joint, chi2_joint = fit_time_coupled(value, error, A, R, la,
                                           TIME_COUPLING)
    tf = interp.timefit
    out = os.path.join(ROOT, "tests", "oracle", "day1000_seed1_timeaxis.npz")
    np.savez_compressed(
        out, C=interp.Coeffs, chi2=interp.chi_sq, reg=interp.reg_params,
        C_joint=C_joint, chi2_joint=chi2_joint, knots=tf["knots"], S=tf["S"],
        lam=tf["lam"], value=value, error=error)
    print(f"{out}: {time.perf_counter() - t0:.1f} s")


def main(tag="exact_grid"):
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    if tag == "timeaxis":
        return timeaxis()
    method, mode = SETTINGS[tag]
    from volumetricinterp_tpu.config import Config
    from volumetricinterp_tpu.io.amisr import read_datafile
    from volumetricinterp_tpu.io.synth import write_synthetic_amisr
    from volumetricinterp_tpu.models.sphharmlag import Model
    from volumetricinterp_tpu.ops.fit import fit_records

    model = Model(Config.from_text(CFG))
    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "day.h5")
        write_synthetic_amisr(raw, nrec=1000, seed=1, smooth_in_model=model,
                              nan_frac=0.03, bad_frac=0.01)
        _, lat, lon, alt, value, error = read_datafile(
            raw, "dens", [1e10, 1e13], [0.1, 10.0], [1, 2, 3, 4])
    A = np.asarray(model.basis(lat, lon, alt))
    R = np.asarray(model.eval_psi())[None]
    t0 = time.perf_counter()
    C, _, chi2, reg = fit_records(value[:NWIN], error[:NWIN], A, R,
                                  method=method, regparam_mode=mode)
    C = np.asarray(C)
    seconds = time.perf_counter() - t0
    out = os.path.join(ROOT, "tests", "oracle",
                       f"day1000_seed1_window64_{tag}.npz")
    np.savez(out, C=C, chi2=np.asarray(chi2), reg=np.asarray(reg))
    print(f"{out}: fit_records {seconds:.1f} s")


if __name__ == "__main__":
    main(*sys.argv[1:])
