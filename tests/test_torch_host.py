"""PyTorch port, host substrate: config, synthetic data, reader QC, hull,
coordinates and coefficient files, held bit for bit against the JAX
package (volumetricinterp_tpu) on the same inputs."""

import dataclasses
import importlib.resources as res

import numpy as np
import pytest

from volumetricinterp_tpu import coords as jcoords
from volumetricinterp_tpu.config import Config as JConfig
from volumetricinterp_tpu.io.amisr import read_datafile as j_read_datafile
from volumetricinterp_tpu.io.synth import write_synthetic_amisr as j_write_synth
from volumetricinterp_tpu.models.sphharmlag import Model as JModel
from volumetricinterp_tpu.utils import hull as jhull

from volumetricinterp_tpu_torch import coords as tcoords
from volumetricinterp_tpu_torch.config import Config as TConfig
from volumetricinterp_tpu_torch.io import coeffs as tcoeffs
from volumetricinterp_tpu_torch.io.amisr import qc_datasets
from volumetricinterp_tpu_torch.io.amisr import read_datafile as t_read_datafile
from volumetricinterp_tpu_torch.io.synth import synthetic_amisr_datasets
from volumetricinterp_tpu_torch.models.sphharmlag import Model as TModel
from volumetricinterp_tpu_torch.utils import hull as thull

QC = ([1e10, 1e13], [0.1, 10.0], [1, 2, 3, 4])


def test_config_round_trips_example_config():
    """The packaged example config, [TPU] section included, parses to the
    same fields in both packages and keeps its text verbatim."""
    text = res.files("volumetricinterp_tpu").joinpath(
        "example_config.ini").read_text()
    t = TConfig.from_text(text)
    j = JConfig.from_text(text)
    for sec in ("fit", "model", "validate", "tpu"):
        assert dataclasses.asdict(getattr(t, sec)) == \
            dataclasses.asdict(getattr(j, sec)), sec
    assert t.raw_text == text
    assert t.tpu.regparam_mode == "exact" and t.tpu.quad_mode == "quad"


@pytest.fixture(scope="module")
def synth_pair(tmp_path_factory, small_config_text):
    """The same synthetic day from both packages: the JAX one written to a
    file, the port's as an in-memory dict (basis-projected truth)."""
    kw = dict(nrec=4, seed=11, nan_frac=0.04, bad_frac=0.05, chi2_offset=True)
    path = str(tmp_path_factory.mktemp("synth") / "synth.h5")
    j_write_synth(path, smooth_in_model=JModel(JConfig.from_text(
        small_config_text)), **kw)
    d = synthetic_amisr_datasets(smooth_in_model=TModel(TConfig.from_text(
        small_config_text)), **kw)
    return path, d


def test_synthetic_day_is_bit_identical(synth_pair):
    import h5py

    path, d = synth_pair
    with h5py.File(path, "r") as f:
        names = []
        f.visit(lambda n: names.append("/" + n)
                if isinstance(f[n], h5py.Dataset) else None)
        assert sorted(names) == sorted(d)
        for name in names:
            a = f[name][()]
            assert a.dtype == d[name].dtype, name
            np.testing.assert_array_equal(a, d[name], err_msg=name)


@pytest.mark.parametrize("param", ["dens", "temp_N2", "frac_O"])
def test_read_datafile_qc_matches(synth_pair, param):
    path, d = synth_pair
    ref = j_read_datafile(path, param, *QC)
    for got in (t_read_datafile(path, param, *QC), qc_datasets(d, param, *QC)):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    if param == "dens":  # temperatures fail ERRLIM, so all of them are NaN
        assert np.isnan(ref[4]).any() and np.isfinite(ref[4]).any()


def test_hull_and_cap_transform_match(synth_pair):
    path, _ = synth_pair
    _, lat, lon, alt, _, _ = j_read_datafile(path, "dens", *QC)
    np.testing.assert_array_equal(thull.compute_hull_vertices(lat, lon, alt),
                                  jhull.compute_hull_vertices(lat, lon, alt))
    for a, b in zip(tcoords.np_geodetic_to_cap(lat, lon, alt, 78.0, 262.0),
                    jcoords.np_geodetic_to_cap(lat, lon, alt, 78.0, 262.0)):
        np.testing.assert_array_equal(a, b)
    hv = thull.compute_hull_vertices(lat, lon, alt)
    eqs = thull.hull_equations(hv)
    np.testing.assert_array_equal(eqs, jhull.hull_equations(hv))
    rng = np.random.default_rng(3)
    q = (rng.uniform(72, 80, 500), rng.uniform(255, 275, 500),
         rng.uniform(1e5, 9e5, 500))
    inside = thull.np_check_hull(eqs, *q)
    np.testing.assert_array_equal(inside, jhull.np_check_hull(eqs, *q))
    assert 0 < inside.sum() < inside.size


def test_torch_cap_transform_matches_host():
    """The torch transform (the grid evaluator's) against the host f64 one:
    theta and cos/sin(phi) to float64 rounding."""
    import torch

    rng = np.random.default_rng(5)
    lat, lon, alt = (rng.uniform(70, 84, 1000), rng.uniform(250, 280, 1000),
                     rng.uniform(8e4, 8e5, 1000))
    z, t, p = tcoords.np_geodetic_to_cap(lat, lon, alt, 78.0, 262.0)
    zt, tt, c1, s1 = tcoords.geodetic_to_cap(
        *(torch.as_tensor(a) for a in (lat, lon, alt)),
        tcoords.cap_rotation(78.0, 262.0))
    np.testing.assert_allclose(zt.numpy(), z, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tt.numpy(), t, rtol=0, atol=1e-12)
    np.testing.assert_allclose(c1.numpy(), np.cos(p), rtol=0, atol=1e-12)
    np.testing.assert_allclose(s1.numpy(), np.sin(p), rtol=0, atol=1e-12)


def test_coeff_files_interchange(tmp_path):
    """A file the port writes reads back through both packages' loaders,
    and the chunked writer + in-place finalize gives the same file."""
    from volumetricinterp_tpu.io.coeffs import load_coeff_file as j_load

    rng = np.random.default_rng(2)
    nrec, nb = 5, 6
    args = dict(utime=rng.uniform(size=(nrec, 2)), coeffs=rng.normal(size=(nrec, nb)),
                covariance=rng.normal(size=(nrec, nb, nb)),
                chi2=rng.uniform(size=nrec), hull_vert=rng.normal(size=(9, 3)),
                reg_list=["0thorder"], reg_method="chi2", raw_filename="raw.h5",
                config_name="c.ini", config_path="/x", config_contents="[MODEL]\n",
                reg_params=rng.uniform(size=(nrec, 1)))
    whole = str(tmp_path / "whole.h5")
    tcoeffs.save_coeff_file(whole, *args.values())
    chunked = str(tmp_path / "chunked.h5")
    meta = dict(reg_list=args["reg_list"], reg_method="chi2",
                hull_vert=args["hull_vert"], raw_filename="raw.h5",
                config_name="c.ini", config_path="/x",
                config_contents="[MODEL]\n")
    w = tcoeffs.IncrementalCoeffWriter(chunked, nrec, nb, meta, fresh=True)
    for s in (0, 3):
        e = min(s + 3, nrec)
        w.write_chunk(s, args["utime"][s:e], args["coeffs"][s:e],
                      args["covariance"][s:e], args["chi2"][s:e],
                      args["reg_params"][s:e])
    assert w.nrec_done == nrec
    w.close()
    tcoeffs.finalize_checkpoint(chunked)
    ref = j_load(whole)
    for got in (tcoeffs.load_coeff_file(whole), tcoeffs.load_coeff_file(chunked),
                j_load(chunked)):
        assert set(got) == set(ref)
        for k in ref:
            if isinstance(ref[k], np.ndarray):
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            else:
                assert got[k] == ref[k], k


def test_phase_timer_and_quality_report():
    from volumetricinterp_tpu.utils.logging import fit_quality_report as jrep
    from volumetricinterp_tpu_torch.utils.logging import (PhaseTimer,
                                                          fit_quality_report)

    t = PhaseTimer()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    assert set(t.report()) == {"a"} and t.report()["a"] >= 0.0
    chi2 = np.array([10.0, np.nan, 30.0, 12.0])
    nvalid = np.array([10, 10, 20, 10])
    rp = np.array([[1e-20], [np.nan], [0.0], [1e-22]])
    assert fit_quality_report(chi2, nvalid, rp, ["0thorder"]) == \
        jrep(chi2, nvalid, rp, ["0thorder"])
