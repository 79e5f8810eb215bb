#!/usr/bin/env python
"""Build tests/oracle/day1000_seed1_window64_exact_grid.npz.

The JAX package's CPU float64 fit, REGPARAM_MODE = exact_grid, of the first
64 records of the seed-1 synthetic day (nrec=1000, nan_frac=0.03,
bad_frac=0.01, basis-projected truth at MAXK=4/MAXL=6, QUAD_MODE = gauss:
scripts/day_check.py's day).  Stores C [64, 144], chi2 [64] and reg
[64, 1].  chip_smoke.py holds the PyTorch port's fit of the same window
against it in the W-weighted field residual (docs/PARITY_NOTES.md #7);
tests/oracle/day1000_seed1_oracle.npz has no coefficients.

Usage:  JAX_PLATFORMS=cpu python scripts/window_oracle.py
"""
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NWIN = 64
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


def main():
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
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
    C, _, chi2, reg = fit_records(value[:NWIN], error[:NWIN], A, R,
                                  regparam_mode="exact_grid")
    out = os.path.join(ROOT, "tests", "oracle",
                       "day1000_seed1_window64_exact_grid.npz")
    np.savez(out, C=np.asarray(C), chi2=np.asarray(chi2),
             reg=np.asarray(reg))
    print(out)


if __name__ == "__main__":
    main()
