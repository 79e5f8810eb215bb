"""PyTorch port, console entry point: the packaged example configuration,
pointed at a synthetic day, fitted by volumetricinterp_tpu_torch.cli.main
and by the JAX package's cli.main; the coefficient files agree and load in
both Estimates."""

from pathlib import Path

import numpy as np
import pytest

from volumetricinterp_tpu import Estimate as JEstimate
from volumetricinterp_tpu.cli import main as jmain
from volumetricinterp_tpu.config import Config as JConfig
from volumetricinterp_tpu.io.synth import write_synthetic_amisr
from volumetricinterp_tpu.models.sphharmlag import Model as JModel

import volumetricinterp_tpu_torch
from volumetricinterp_tpu_torch import Estimate
from volumetricinterp_tpu_torch import interpolate as tinterpolate
from volumetricinterp_tpu_torch.cli import main, validate_main
from volumetricinterp_tpu_torch.io.coeffs import load_coeff_file
from volumetricinterp_tpu_torch.ops import regparam as tregparam
from volumetricinterp_tpu_torch.ops import solve as tsolve

from test_torch_fit import _check_fit, _wall_records

ROOT = Path(__file__).resolve().parent.parent
EXAMPLE = ROOT / "volumetricinterp_tpu_torch" / "example_config.ini"


def test_example_config_is_the_jax_packages():
    assert EXAMPLE.read_bytes() == (
        ROOT / "volumetricinterp_tpu" / "example_config.ini").read_bytes()


# The record whose roots may differ: its whitened seed lands on chi2 = nu
# itself, and the first anchored evaluation there sits within 3e-7 relative
# of nu.  That evaluation's sign picks the side the bracket closes from, and
# it follows the last bits of the statistics (the port's AtWA of a 20-record
# chunk differs there from one record's, and from the JAX package's).
# Closing from above, the search converges on the root near log10 alpha =
# -32.30, where the JAX command line lands; from below, it ends among the
# curvature matrix's singular poles near -33.44 (CPU float64).
TIES = {0}


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """The example configuration (curvature, chi2, REGPARAM_MODE = exact,
    QUAD_MODE = quad) at MAXK=2 / MAXL=3 on a 20-record synthetic day,
    fitted by both command lines into two files.  The port's fit inputs
    (values, errors, A, R) are kept, and so is its first anchored exact
    chi2 per record with that record's nu (the seed round of the search)."""
    tmp = tmp_path_factory.mktemp("cli_torch")
    raw = tmp / "day.h5"
    text = (EXAMPLE.read_text()
            .replace("20161127.002_lp_1min-fitcal.h5", str(raw))
            .replace("MAXK = 4", "MAXK = 2").replace("MAXL = 6", "MAXL = 3"))
    write_synthetic_amisr(str(raw), nrec=20, seed=5, nan_frac=0.03,
                          bad_frac=0.01,
                          smooth_in_model=JModel(JConfig.from_text(text)))
    out = {}
    fit, defect_round = tinterpolate.fit_records, tregparam._defect_round

    def spy(values, errors, A, R, **kw):
        out["inputs"] = tuple(np.asarray(x) for x in (values, errors, A, R))
        return fit(values, errors, A, R, **kw)

    def seed_round(state, anchor, clip, nu, *rest):
        if "seed_eval" not in out:
            out["seed_eval"] = (
                tsolve.anchor_chi2(anchor, state[2], rest[-1]).numpy(),
                nu.numpy())
        return defect_round(state, anchor, clip, nu, *rest)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tinterpolate, "fit_records", spy)
        mp.setattr(tregparam, "_defect_round", seed_round)
        for tag, run, extra in (("torch", main, ["--device", "cpu"]),
                                ("jax", jmain, [])):
            cfg = tmp / f"{tag}.ini"
            path = tmp / f"coef_{tag}.h5"
            cfg.write_text(text.replace("test_out.h5", str(path)))
            run([str(cfg)] + extra)
            out[tag] = str(path)
    return out


def test_cli_fits_agree(fitted):
    """The bars of test_torch_end2end.test_fits_agree on every record but
    a tie of TIES: same outcome classes, roots within 2e-3 decades, chi2
    within 1e-3, the same hull; Coeffs and Covariance within _check_fit's
    data-determined bars (the roots agree to the search's resolution, not
    to the last digit).  A tie record whose roots differ keeps its outcome
    class and must show the tie: its first anchored chi2 within 1e-6 of nu."""
    t, j = (load_coeff_file(fitted[k]) for k in ("torch", "jax"))
    assert "REGPARAM_MODE = exact\n" in bytes(t["config_file_text"]).decode()
    assert t["reglist"] == j["reglist"] == ["curvature"]
    np.testing.assert_array_equal(t["UnixTime"], j["UnixTime"])
    np.testing.assert_array_equal(t["hull_vert"], j["hull_vert"])
    np.testing.assert_array_equal(np.isnan(t["chi2"]), np.isnan(j["chi2"]))
    rp, rpj = t["reg_params"][:, 0], j["reg_params"][:, 0]
    np.testing.assert_array_equal(rp == 0, rpj == 0)
    ok = rpj > 0
    dla = np.abs(np.log10(np.where(ok, rp, 1.0))
                 - np.log10(np.where(ok, rpj, 1.0)))
    multi = set(np.flatnonzero(dla >= 2e-3).tolist())
    assert multi <= TIES
    c_seed, nu = fitted["seed_eval"]
    for r in multi:
        assert abs(c_seed[r] - nu[r]) <= 1e-6 * nu[r], r
    keep = np.array([r for r in range(len(rp))
                     if r not in multi and np.isfinite(j["chi2"][r])])
    assert (rpj[keep] > 0).sum() >= 15
    keys = ("Coeffs", "Covariance", "chi2", "reg_params")
    got, ref = (tuple(np.asarray(f[k])[keep] for k in keys) for f in (t, j))
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-3)
    values, errors, A, R = fitted["inputs"]
    values, errors = values[keep], errors[keep]
    _check_fit(got, ref, values, errors, A, R,
               _wall_records(values, errors, A, R, ref[3]),
               loose=set(range(len(keep))))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cli_files_interchange(fitted, writer):
    te, je = Estimate(fitted[writer], device="cpu"), JEstimate(fitted[writer])
    np.testing.assert_array_equal(te.Coeffs, je.Coeffs)
    np.testing.assert_array_equal(te.Covariance, je.Covariance)
    assert te.config.raw_text == je.config.raw_text


def test_cli_unported_routes_raise(tmp_path, capsys):
    """--distributed, --validate and validate_main are ported and read the
    configuration first: --distributed joins its world (one process here,
    no VITPU_* or torchrun variables) and says so before the missing file
    raises (tests/test_torch_parallel.py runs a two-process world)."""
    cfg = str(tmp_path / "none.ini")
    with pytest.raises(FileNotFoundError):
        main([cfg, "--distributed", "--device", "cpu"])
    assert "distributed: process 0 / 1" in capsys.readouterr().out
    for run in (lambda: main([cfg, "--validate", "--device", "cpu"]),
                lambda: validate_main([cfg, "--device", "cpu"])):
        with pytest.raises(FileNotFoundError):
            run()
    with pytest.raises(SystemExit):
        main(["--help"])
    assert "REGPARAM_MODE = exact" in capsys.readouterr().out
    assert volumetricinterp_tpu_torch.cli.__doc__
