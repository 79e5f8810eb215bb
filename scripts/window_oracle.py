#!/usr/bin/env python
"""Build tests/oracle/day1000_seed1_window64_<tag>.npz, or, for the tags
timeaxis, radbasfun, lobo and highorder_{exact,fast,exact_tail,gcv,
gcv_tail,manual,exact_grid,lobo}, tests/oracle/day1000_seed1_<tag>.npz
(highorder_sweep: see below).

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

radbasfun: the whole seed-1 day fitted with the radbasfun model at the
JAX package's config defaults (EPS = 1e5, LATRANGE 74,80, LONRANGE
260,285, ALTRANGE 100,600, NUMGRIDPNT = 7: 343 basis functions) and no
regularization (the plain cutoff solve), by fit_records in chunks of 128
records as Interpolate runs it.  Stores C [1000, 343] and chi2 [1000] (NaN
for a failed record); no covariance (940 MB).

lobo: the leave-one-beam-out sweep (sweep.py) on the first 64 records of
the seed-1 day at the production order (MAXK=4, MAXL=6, 0thorder) over
all 20 beams and LOBO_ALPHAS, which bracket the day's fitted alphas
(day1000_seed1_oracle.npz: median log10 -31.1 on those records): the
per-entry held-out chi2 per [64, 20, 9], and order_sweep's score matrix
over LOBO_ORDERS and its argmin.  lobo_cv runs 8 records at a time (its
records are independent), which bounds the vmapped batch's memory.

highorder_exact, highorder_fast: BASELINE config 3, the lmax=10 x 12
radial basis (MAXK=12, MAXL=10, nbasis 1200; QUAD_MODE = gauss,
0thorder: tests/test_highorder.py's HI_CFG) fitted in exact or fast mode
by fit_records, HI_CHUNK records a call, on the first HI_NREC records of
the seed-1 day: the day's geometry, and the QC'd value and error stored
with tests/oracle/day1000_seed1_timeaxis.npz (the bytes chip_smoke.py
feeds the port).  At 580 points against 1200 basis functions every record
is underdetermined.  Stores C [128, 1200], chi2 [128] and reg [128, 1] in
tests/oracle/day1000_seed1_highorder_<mode>.npz; no covariance (1.5 GB).

highorder_exact_tail, highorder_gcv, highorder_gcv_tail, highorder_manual,
highorder_exact_grid: the same at that order on other windows of the same
bytes (HI_WINDOWS): records 896-999 in exact mode (the day's last
128-record chunk, 104 records, which the card pads to 128), the first 32
and the last 32 (968-999, in that padded chunk) with
REGULARIZATION_METHOD = gcv (exact mode), the first 128 with
REGULARIZATION_METHOD = manual (alpha HI_MANUAL_PARAMS, the config's
MANUAL_PARAMS['0thorder']), the first 8 in exact_grid (2 records a call:
a call decomposes 101 matrices a record at once).  Each also stores
``start``, its first record's index in the day.

highorder_lobo: the leave-one-beam-out sweep at that order on the first
HI_LOBO_NREC records (the same bytes), over all 20 beams and
HI_LOBO_ALPHAS, which bracket the highorder_exact oracle's alphas (log10
-25.45 .. -23.65 on the first four records, -29.33 .. -22.72 on all 128,
median -24.90), one record a call (a record's vmapped batch holds 180
matrices of 1200 x 1200).  Stores per [4, 20, 9], the summed scores [9]
and their argmin.

highorder_sweep: tests/test_highorder.py's lambda sweep at that order, as
that test runs it (a fresh model, 800 points from default_rng(7), W =
1e-21, the JAX package's cutoff_chi2 at 15 log10 alphas in [-40, 0]), in
tests/oracle/highorder_lambda_sweep.npz (log10_alphas, chi2).

Wall time of one run on an 8-core x86 CPU host (JAX 0.9.0, float64, cold
compile included): exact_grid not recorded; exact 65 s; fast 21 s; gcv
62 s; timeaxis 1,928 s, beside other work on the same 8 cores; radbasfun
and lobo as printed by the run (CHANGES.md); highorder_exact 1,477 s,
highorder_fast 712 s, highorder_lobo 1,695 s and highorder_sweep 248 s,
each beside other work on the same 8 cores (the JAX package's float64
eigendecompositions at n = 1200 run its deflation ladder);
highorder_exact_tail 301.6 s on 4 of the 8 cores and highorder_exact_grid
335.9 s on 3 of them, side by side, then highorder_gcv 1,277.7 s on the
same 3; highorder_gcv_tail 779.1 s on 4 of them and highorder_manual
87.1 s on 3, side by side.

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


RBF_CFG = """
[DEFAULT]
[MODEL]
NAME = radbasfun
"""
LOBO_NREC = 64
LOBO_ALPHAS = [float(a) for a in range(-35, -26)]
LOBO_ORDERS = [(2, 3), (3, 5), (4, 6)]
HI_CFG = CFG.replace("MAXK = 4", "MAXK = 12").replace("MAXL = 6", "MAXL = 10")
HI_NREC, HI_CHUNK = 128, 16
HI_LOBO_NREC = 4
# tag: (first record, records, REGULARIZATION_METHOD, REGPARAM_MODE,
# records a fit_records call); highorder_exact and highorder_fast are
# (0, HI_NREC, "chi2", mode, HI_CHUNK)
HI_WINDOWS = {"exact_tail": (896, 104, "chi2", "exact", HI_CHUNK),
              "gcv": (0, 32, "gcv", "exact", HI_CHUNK),
              "gcv_tail": (968, 32, "gcv", "exact", HI_CHUNK),
              "manual": (0, 128, "manual", "exact", HI_CHUNK),
              "exact_grid": (0, 8, "chi2", "exact_grid", 2)}
# REGULARIZATION_METHOD = manual's alpha: the config's MANUAL_PARAMS default
# for 0thorder (raw, the reference's units)
HI_MANUAL_PARAMS = [1e-23]
HI_LOBO_ALPHAS = [float(a) for a in range(-29, -20)]
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


def seed1_day(model):
    """The seed-1 day's QC'd (lat, lon, alt, value, error) and beam index,
    the day made with ``model`` as its smooth-in model."""
    from volumetricinterp_tpu.io.amisr import beam_index, read_datafile
    from volumetricinterp_tpu.io.synth import write_synthetic_amisr

    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "day.h5")
        write_synthetic_amisr(raw, nrec=1000, seed=1, smooth_in_model=model,
                              nan_frac=0.03, bad_frac=0.01)
        _, lat, lon, alt, value, error = read_datafile(
            raw, "dens", [1e10, 1e13], [0.1, 10.0], [1, 2, 3, 4])
        return lat, lon, alt, value, error, beam_index(raw)


def radbasfun():
    """The radbasfun oracle (see the module docstring)."""
    from volumetricinterp_tpu.config import Config
    from volumetricinterp_tpu.models.radbasfun import Model as RBF
    from volumetricinterp_tpu.models.sphharmlag import Model
    from volumetricinterp_tpu.ops.fit import fit_records

    t0 = time.perf_counter()
    lat, lon, alt, value, error, _ = seed1_day(Model(Config.from_text(CFG)))
    model = RBF(Config.from_text(RBF_CFG))
    A = np.asarray(model.basis(lat, lon, alt))
    R = np.zeros((0, model.nbasis, model.nbasis))
    C, chi2 = [], []
    for s in range(0, value.shape[0], 128):
        c, _, x2, _ = fit_records(value[s:s + 128], error[s:s + 128], A, R,
                                  method="chi2", regparam_mode="exact")
        C.append(np.asarray(c))
        chi2.append(np.asarray(x2))
    out = os.path.join(ROOT, "tests", "oracle", "day1000_seed1_radbasfun.npz")
    np.savez_compressed(out, C=np.concatenate(C), chi2=np.concatenate(chi2))
    print(f"{out}: {time.perf_counter() - t0:.1f} s")


def lobo():
    """The leave-one-beam-out oracle (see the module docstring)."""
    from volumetricinterp_tpu.config import Config
    from volumetricinterp_tpu.models.sphharmlag import Model
    from volumetricinterp_tpu.sweep import lobo_cv

    t0 = time.perf_counter()
    lat, lon, alt, value, error, bidx = seed1_day(
        Model(Config.from_text(CFG)))
    v, e = value[:LOBO_NREC], error[:LOBO_NREC]

    def per_entry(model):
        A = np.asarray(model.basis(lat, lon, alt))
        R = np.asarray(model.eval_psi())
        return np.concatenate([
            lobo_cv(v[s:s + 8], e[s:s + 8], A, bidx, R, LOBO_ALPHAS)[1]
            for s in range(0, LOBO_NREC, 8)])

    # order_sweep's loop (volumetricinterp_tpu/sweep.py), chunked
    scores, per = [], None
    for maxk, maxl in LOBO_ORDERS:
        cfg = Config.from_text(CFG)
        cfg.model.maxk, cfg.model.maxl = maxk, maxl
        p = per_entry(Model(cfg))
        scores.append(p.sum(axis=(0, 1)))
        if (maxk, maxl) == (4, 6):
            per = p
    scores = np.asarray(scores)
    best = np.unravel_index(np.argmin(scores), scores.shape)
    out = os.path.join(ROOT, "tests", "oracle", "day1000_seed1_lobo.npz")
    np.savez_compressed(out, per=per, scores=scores, alphas=LOBO_ALPHAS,
                        orders=LOBO_ORDERS, best_order=LOBO_ORDERS[best[0]],
                        best_log10_alpha=LOBO_ALPHAS[best[1]])
    print(f"{out}: {time.perf_counter() - t0:.1f} s; best order "
          f"{LOBO_ORDERS[best[0]]}, log10 alpha {LOBO_ALPHAS[best[1]]}")


def highorder_sweep():
    """The highorder_sweep oracle (see the module docstring)."""
    import jax.numpy as jnp

    from volumetricinterp_tpu.config import Config
    from volumetricinterp_tpu.models.sphharmlag import Model
    from volumetricinterp_tpu.ops.solve import cutoff_chi2, suff_stats

    t0 = time.perf_counter()
    model = Model(Config.from_text(HI_CFG))
    rng = np.random.default_rng(7)
    npts = 800
    lat = rng.uniform(74, 82, npts)
    lon = rng.uniform(252, 272, npts)
    alt = rng.uniform(1e5, 6e5, npts)
    A = jnp.asarray(np.asarray(model.basis(lat, lon, alt)))
    v = jnp.asarray(4e11 * np.exp(-(((alt - 3e5) / 1.2e5) ** 2)))
    AtWA, AtWb, btWb, _ = suff_stats(A, v, jnp.full((npts,), 1e-21),
                                     jnp.ones(npts))
    psi = jnp.asarray(np.asarray(model.eval_psi()))
    la = np.linspace(-40, 0, 15)
    chi2 = [float(cutoff_chi2(10.0**a, AtWA, AtWb, btWb, psi)) for a in la]
    out = os.path.join(ROOT, "tests", "oracle", "highorder_lambda_sweep.npz")
    np.savez(out, log10_alphas=la, chi2=np.asarray(chi2))
    print(f"{out}: {time.perf_counter() - t0:.1f} s")


def highorder(mode):
    """The highorder_<mode> oracles (see the module docstring)."""
    from volumetricinterp_tpu.config import Config
    from volumetricinterp_tpu.models.sphharmlag import Model
    from volumetricinterp_tpu.ops.fit import fit_records
    from volumetricinterp_tpu.sweep import lobo_cv

    if mode == "sweep":
        return highorder_sweep()
    t0 = time.perf_counter()
    lat, lon, alt, _, _, bidx = seed1_day(Model(Config.from_text(CFG)))
    o = np.load(os.path.join(ROOT, "tests", "oracle",
                             "day1000_seed1_timeaxis.npz"))
    model = Model(Config.from_text(HI_CFG))
    A = np.asarray(model.basis(lat, lon, alt))
    R = np.asarray(model.eval_psi())
    out = os.path.join(ROOT, "tests", "oracle",
                       f"day1000_seed1_highorder_{mode}.npz")
    if mode == "lobo":
        v, e = o["value"][:HI_LOBO_NREC], o["error"][:HI_LOBO_NREC]
        per = np.concatenate([
            lobo_cv(v[r:r + 1], e[r:r + 1], A, bidx, R, HI_LOBO_ALPHAS)[1]
            for r in range(HI_LOBO_NREC)])
        scores = per.sum(axis=(0, 1))
        np.savez(out, per=per, scores=scores, alphas=HI_LOBO_ALPHAS,
                 best_log10_alpha=HI_LOBO_ALPHAS[int(np.argmin(scores))])
    else:
        start, nrec, method, fmode, chunk = HI_WINDOWS.get(
            mode, (0, HI_NREC, "chi2", mode, HI_CHUNK))
        v = o["value"][start:start + nrec]
        e = o["error"][start:start + nrec]
        C, chi2, reg = [], [], []
        for s in range(0, nrec, chunk):
            c, _, x2, rp = fit_records(
                v[s:s + chunk], e[s:s + chunk], A, R[None], method=method,
                regparam_mode=fmode,
                manual_params=HI_MANUAL_PARAMS if method == "manual" else None)
            C.append(np.asarray(c))
            chi2.append(np.asarray(x2))
            reg.append(np.asarray(rp))
        np.savez(out, C=np.concatenate(C), chi2=np.concatenate(chi2),
                 reg=np.concatenate(reg), start=start)
    print(f"{out}: {time.perf_counter() - t0:.1f} s")


def main(tag="exact_grid"):
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    if tag.startswith("highorder_"):
        return highorder(tag[len("highorder_"):])
    if tag in ("timeaxis", "radbasfun", "lobo"):
        return {"timeaxis": timeaxis, "radbasfun": radbasfun,
                "lobo": lobo}[tag]()
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
