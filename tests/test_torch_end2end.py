"""PyTorch port, end to end: a synthetic day through Interpolate.calc_coeffs
+ saveh5 and Estimate in both packages; coefficient files interchange both
ways and the products agree."""

import datetime as dt

import numpy as np
import pytest
import torch

from volumetricinterp_tpu import Estimate as JEstimate
from volumetricinterp_tpu import Interpolate as JInterpolate
from volumetricinterp_tpu.io.synth import write_synthetic_amisr
from volumetricinterp_tpu.config import Config as JConfig
from volumetricinterp_tpu.models.sphharmlag import Model as JModel

from volumetricinterp_tpu_torch import Estimate, Interpolate
from volumetricinterp_tpu_torch.config import Config as TConfig
from volumetricinterp_tpu_torch.io.amisr import qc_datasets
from volumetricinterp_tpu_torch.io.synth import synthetic_amisr_datasets
from volumetricinterp_tpu_torch.models.sphharmlag import Model


def _utc(ts):
    return dt.datetime(1970, 1, 1) + dt.timedelta(seconds=float(ts))


@pytest.fixture(scope="module")
def day(tmp_path_factory, small_config_text):
    tmp = tmp_path_factory.mktemp("e2e_torch")
    raw = str(tmp / "synth.h5")
    text = (small_config_text.replace("test_input.h5", raw)
            + "\n[TPU]\nQUAD_MODE = gauss\nREGPARAM_MODE = exact_grid\n"
            "CHUNK_SIZE = 8\n")
    kw = dict(nrec=20, seed=5, nan_frac=0.03, bad_frac=0.01)
    write_synthetic_amisr(raw, smooth_in_model=JModel(JConfig.from_text(text)),
                          **kw)
    out = {}
    for tag, cls, extra in (("jax", JInterpolate, {}),
                            ("torch", Interpolate, {"device": "cpu"})):
        path = str(tmp / f"coef_{tag}.h5")
        interp = cls(text.replace("test_output.h5", path), **extra)
        interp.calc_coeffs()
        interp.saveh5()
        out[tag] = (interp, path)
    grid = np.meshgrid(np.linspace(73.5, 77.0, 10), np.linspace(258.0, 272.0, 12),
                       np.array([200e3, 300e3, 450e3]))
    return dict(out=out, text=text, raw=raw, kw=kw, grid=grid)


def test_fits_agree(day):
    """Same outcome classes and roots; chi2 inside the cutoff-wall
    envelope of this basis (PARITY_NOTES #7, see test_torch_fit)."""
    j, t = day["out"]["jax"][0], day["out"]["torch"][0]
    np.testing.assert_array_equal(t.time, j.time)
    np.testing.assert_array_equal(np.isnan(t.chi_sq), np.isnan(j.chi_sq))
    np.testing.assert_array_equal(t.reg_params == 0, j.reg_params == 0)
    ok = j.reg_params[:, 0] > 0
    assert ok.sum() >= 15
    assert np.max(np.abs(np.log10(t.reg_params[ok])
                         - np.log10(j.reg_params[ok]))) < 2e-3
    f = np.isfinite(j.chi_sq)
    np.testing.assert_allclose(t.chi_sq[f], j.chi_sq[f], rtol=1e-3)
    np.testing.assert_array_equal(t.hull_vert, j.hull_vert)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_coefficient_files_interchange(day, writer):
    interp, path = day["out"][writer]
    te, je = Estimate(path, device="cpu"), JEstimate(path)
    for e in (te, je):
        np.testing.assert_array_equal(e.Coeffs, interp.Coeffs)
        np.testing.assert_array_equal(e.Covariance, interp.Covariance)
        np.testing.assert_array_equal(e.time, interp.time)
    assert te.config.raw_text == je.config.raw_text == interp.config.raw_text
    # the host float64 point API on the same file
    r = int(np.argmax(np.isfinite(interp.chi_sq)))
    lat, lon, alt = (a[:, :, 1] for a in day["grid"])
    P, err = te(_utc(np.mean(te.time[r])), lat, lon, alt, calcerr=True)
    Pj, errj = je(_utc(np.mean(je.time[r])), lat, lon, alt, calcerr=True)
    np.testing.assert_array_equal(np.isnan(P), np.isnan(Pj))
    assert np.isfinite(P).sum() > 10 and np.isnan(P).sum() > 10
    np.testing.assert_allclose(P, Pj, rtol=1e-12, equal_nan=True)
    np.testing.assert_allclose(err, errj, rtol=1e-10, equal_nan=True)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_products_agree(day, writer):
    """evaluate_records of the same file in both packages (float32 fast
    paths): within 5e-5 of the sup, identical FoV NaN sets."""
    interp, path = day["out"][writer]
    te, je = Estimate(path, device="cpu"), JEstimate(path)
    ok = np.isfinite(interp.chi_sq)
    times = [_utc(t) for t in np.mean(interp.time, axis=1)[ok][:3]]
    got = te.evaluate_records(times, *day["grid"])
    ref = np.asarray(je.evaluate_records(times, *day["grid"]))
    assert got.shape == ref.shape == (3,) + day["grid"][0].shape
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    f = np.isfinite(ref)
    assert 0 < f.sum() < f.size
    assert np.max(np.abs(got[f] - ref[f])) <= 5e-5 * np.max(np.abs(ref[f]))
    # grid_eval is the one-record form, against the float64 point API
    one = te.grid_eval(times[1], *day["grid"])
    np.testing.assert_array_equal(one, got[1])
    P = te(times[1], *day["grid"])
    np.testing.assert_array_equal(np.isnan(one), np.isnan(P))
    assert np.nanmax(np.abs(one - P)) <= 5e-5 * np.nanmax(np.abs(P))


def test_empty_times_and_empty_grid(day):
    _, path = day["out"]["torch"]
    te = Estimate(path, device="cpu")
    out = te.evaluate_records([], *day["grid"])
    assert out.shape == (0,) + day["grid"][0].shape
    t0 = _utc(np.mean(te.time[0]))
    empty = np.zeros((0, 4))
    out = te.evaluate_records([t0, t0], empty, empty, empty)
    assert out.shape == (2, 0, 4)


def test_grid_cache_sees_an_edited_grid(day):
    """The prepared-grid cache is keyed on the grid's full content: editing
    one interior point must not reuse the stale coordinates."""
    _, path = day["out"]["torch"]
    te = Estimate(path, device="cpu")
    t0 = _utc(np.mean(te.time[0]))
    lat, lon, alt = (a.copy() for a in day["grid"])
    a = te.evaluate_records([t0], lat, lon, alt)
    alt[4, 5, 1] = 280e3
    b = te.evaluate_records([t0], lat, lon, alt)
    fresh = Estimate(path, device="cpu").evaluate_records([t0], lat, lon, alt)
    np.testing.assert_array_equal(b, fresh)
    assert not np.array_equal(a, b, equal_nan=True)


def test_in_memory_day_without_files(day):
    """The same fit with no file at all: read_datafile overridden to QC an
    in-memory synthetic day, no OUTPUTFILENAME, and Estimate fed the fitted
    arrays through loadh5 (the path chip_smoke.py takes without h5py)."""
    text = day["text"].replace(
        "OUTPUTFILENAME = test_output.h5", "OUTPUTFILENAME =")
    data = synthetic_amisr_datasets(
        smooth_in_model=Model(TConfig.from_text(text)), **day["kw"])

    class MemInterpolate(Interpolate):
        def read_datafile(self, filename):
            return qc_datasets(data, self.param, self.errlim, self.chi2lim,
                               self.goodfitcode)

    interp = MemInterpolate(text, device="cpu")
    interp.calc_coeffs()
    ref = day["out"]["torch"][0]
    np.testing.assert_array_equal(interp.Coeffs, ref.Coeffs)
    np.testing.assert_array_equal(interp.chi_sq, ref.chi_sq)

    class MemEstimate(Estimate):
        def loadh5(self, filename=None):
            self.Coeffs, self.Covariance = interp.Coeffs, interp.Covariance
            self.time, self.hull_vert = interp.time, interp.hull_vert
            self.config_file_text = interp.config.raw_text
            self.chi2, self.raw_filename = interp.chi_sq, None

    est = MemEstimate(None, device="cpu")
    ok = np.isfinite(interp.chi_sq)
    times = [_utc(t) for t in np.mean(interp.time, axis=1)[ok][:2]]
    np.testing.assert_array_equal(
        est.evaluate_records(times, *day["grid"]),
        Estimate(day["out"]["torch"][1], device="cpu").evaluate_records(
            times, *day["grid"]))


def test_resume_of_a_finished_file(day, tmp_path):
    """calc_coeffs(resume=True) on a completed checkpoint refits nothing
    and returns the stored results."""
    import shutil

    ref, path = day["out"]["torch"]
    text = day["text"].replace("test_output.h5", str(tmp_path / "r.h5"))
    first = Interpolate(text, device="cpu")
    first.calc_coeffs()  # checkpoint left unfinalized: nrec_done = nrec
    shutil.copy(str(tmp_path / "r.h5"), str(tmp_path / "r2.h5"))
    again = Interpolate(text.replace("r.h5", "r2.h5"), device="cpu")
    again.calc_coeffs(resume=True)
    np.testing.assert_array_equal(again.Coeffs, ref.Coeffs)
    np.testing.assert_array_equal(again.chi_sq, ref.chi_sq)


def test_unported_options_raise(day):
    """The options the first slices left out now run through Interpolate:
    BASIS_IMPL = series fits the day as the table basis does (the same
    outcome classes, chi2 within the cutoff-wall envelope of
    test_fits_agree), and NAME = radbasfun fits it with no regularization
    (radbasfun has none: 0thorder raises as in the reference).  The port's
    default device, CUDA, raises without a card."""
    ref = day["out"]["torch"][0]
    text = day["text"].replace("OUTPUTFILENAME = test_output.h5",
                               "OUTPUTFILENAME =")
    series = Interpolate(text.replace("[TPU]", "[TPU]\nBASIS_IMPL = series"),
                         device="cpu")
    series.calc_coeffs()
    np.testing.assert_array_equal(np.isnan(series.chi_sq), np.isnan(ref.chi_sq))
    np.testing.assert_array_equal(series.reg_params == 0, ref.reg_params == 0)
    f = np.isfinite(ref.chi_sq)
    np.testing.assert_allclose(series.chi_sq[f], ref.chi_sq[f], rtol=1e-3)
    rbf_text = text.replace("NAME = sphharmlag", "NAME = radbasfun")
    with pytest.raises(KeyError):
        Interpolate(rbf_text, device="cpu").calc_coeffs()
    rbf = Interpolate(rbf_text.replace("REGULARIZATION_LIST = 0thorder",
                                       "REGULARIZATION_LIST ="), device="cpu")
    rbf.calc_coeffs()
    assert rbf.Coeffs.shape == (20, 343) and rbf.reg_params.shape == (20, 0)
    assert np.isfinite(rbf.chi_sq).all() and (rbf.chi_sq >= 0).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Interpolate(day["text"])  # device="cuda" is the default
