"""PyTorch port: basis gradients and inverse_transform, Estimate's calcgrad
and calcerr outputs, the Validate workflow with its command-line routes
(after tests/test_validate_cli.py), and the fit's host route of every
eigendecomposition (solve.host_eigh), against the JAX package and
torch.linalg.eigh (CPU float64, MAXK=2, MAXL=3)."""

import datetime as dt
import os

import numpy as np
import pytest
import torch

from volumetricinterp_tpu import Estimate as JEstimate
from volumetricinterp_tpu import Interpolate as JInterpolate
from volumetricinterp_tpu.config import Config as JConfig
from volumetricinterp_tpu.io.synth import write_synthetic_amisr
from volumetricinterp_tpu.models.sphharmlag import Model as JModel

from volumetricinterp_tpu_torch import Estimate
from volumetricinterp_tpu_torch.cli import main, validate_main
from volumetricinterp_tpu_torch.config import Config as TConfig
from volumetricinterp_tpu_torch.models.sphharmlag import Model as TModel
from volumetricinterp_tpu_torch.ops import fit as tfit
from volumetricinterp_tpu_torch.ops import solve as tsolve
from volumetricinterp_tpu_torch.validate import Validate

from test_torch_fit import make_records


def _points(shape=(5, 7)):
    rng = np.random.default_rng(0)
    return (rng.uniform(74, 80, shape), rng.uniform(255, 270, shape),
            rng.uniform(1e5, 6e5, shape))


@pytest.mark.parametrize("quad_mode", ["quad", "gauss"])
def test_grad_basis_and_inverse_transform_match_jax(small_config_text,
                                                    quad_mode):
    """rtol 1e-12 of each array's sup: the same host float64 recurrences."""
    text = small_config_text + f"\n[TPU]\nQUAD_MODE = {quad_mode}\n"
    tm, jm = TModel(TConfig.from_text(text)), JModel(JConfig.from_text(text))
    lat, lon, alt = _points()
    G, Gj = tm.grad_basis(lat, lon, alt), np.asarray(jm.grad_basis(lat, lon, alt))
    assert G.shape == (5, 7, 3, 18)
    assert np.max(np.abs(G - Gj)) <= 1e-12 * np.max(np.abs(Gj))
    vec = np.random.default_rng(1).normal(size=(5, 7, 3))
    V = tm.inverse_transform(lat, lon, alt, vec)
    Vj = np.asarray(jm.inverse_transform(lat, lon, alt, vec))
    assert V.shape == (5, 7, 3)
    assert np.max(np.abs(V - Vj)) <= 1e-12 * np.max(np.abs(Vj))
    # a rotation: lengths are kept
    np.testing.assert_allclose(np.linalg.norm(V, axis=-1),
                               np.linalg.norm(vec, axis=-1), rtol=1e-12)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory, small_config_text):
    """tests/test_validate_cli.py's workspace: a 6-record synthetic day, a
    configuration file with its [VALIDATE] window, and the JAX package's
    coefficient file of the day."""
    tmp = tmp_path_factory.mktemp("grad_val")
    raw, out, png = (str(tmp / n) for n in ("synth.h5", "coef.h5", "fig.png"))
    write_synthetic_amisr(raw, nrec=6, t0=1480286700.0, seed=21,
                          smooth_in_model=JModel(JConfig.from_text(
                              small_config_text)))
    text = (small_config_text.replace("test_input.h5", raw)
            .replace("test_output.h5", out).replace("test_fig.png", png))
    cfg = str(tmp / "config.ini")
    with open(cfg, "w") as f:
        f.write(text)
    jpath = str(tmp / "coef_jax.h5")
    interp = JInterpolate(JConfig.from_text(text.replace(out, jpath)))
    interp.calc_coeffs()
    interp.saveh5()
    return dict(tmp=tmp, cfg=cfg, out=out, png=png, jpath=jpath, text=text)


def test_estimate_gradients_match_jax(workspace):
    """Estimate(...)(calcgrad, calcerr) of the port and of the JAX package
    on one file: P, dP, err and graderr within 1e-10 (the same host float64
    sums); the FoV NaN sets equal; dP rotated to ECEF through
    Estimate.inverse_transform as Model.inverse_transform does."""
    te, je = Estimate(workspace["jpath"], device="cpu"), JEstimate(workspace["jpath"])
    when = dt.datetime(1970, 1, 1) + dt.timedelta(
        seconds=float(np.mean(te.time[2])))
    lat, lon, alt = np.meshgrid(np.linspace(71.0, 79.0, 6),
                                np.linspace(250.0, 280.0, 5), [250e3, 300e3])
    for kw, n in ((dict(calcgrad=True), 2), (dict(calcerr=True), 2),
                  (dict(calcgrad=True, calcerr=True), 4)):
        got, ref = te(when, lat, lon, alt, **kw), je(when, lat, lon, alt, **kw)
        assert len(got) == len(ref) == n
        for a, b in zip(got, ref):
            b = np.asarray(b)
            assert a.shape == b.shape
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            assert np.isfinite(a).any() and np.isnan(a).any()
            np.testing.assert_allclose(a, b, rtol=1e-10, equal_nan=True)
    P, dP = te(when, lat, lon, alt, calcgrad=True, check_hull=False)
    assert dP.shape == lat.shape + (3,) and np.isfinite(dP).all()
    np.testing.assert_array_equal(
        te.inverse_transform(lat, lon, alt, dP),
        te.model.inverse_transform(lat, lon, alt, dP))


def test_validate_workflow(workspace):
    """Validate on the CPU: the windowed fit through the port's Interpolate
    and a PNG from its Estimate (plain axes: no cartopy here)."""
    png = workspace["png"] + ".torch.png"
    v = Validate(workspace["cfg"], device="cpu")
    v.outputpng = png
    v.interpolate()
    assert v.outputfilename == workspace["out"]
    v.create_plots()
    assert os.path.getsize(png) > 10_000
    assert Estimate(workspace["out"], device="cpu").Coeffs.shape == (5, 18)


def test_validate_cartopy_branch(workspace):
    """The map-projection branch of create_plots against the repository's
    cartopy stub (tests/cartopy_stub.py), as the JAX package's test runs."""
    from tests import cartopy_stub

    png = workspace["png"] + ".cartopy.png"
    v = Validate(workspace["cfg"], device="cpu")
    v.outputfilename, v.outputpng = workspace["jpath"], png
    names = cartopy_stub.install()
    try:
        v.create_plots()
    finally:
        cartopy_stub.uninstall(names)
    assert os.path.getsize(png) > 10_000
    assert cartopy_stub._StubGeoAxes.coastlines_calls > 0


@pytest.mark.parametrize("route", ["main", "validate_main"])
def test_cli_validate_routes(workspace, route, tmp_path):
    """volumetricinterp-torch --validate and validate_main write the PNG."""
    png = str(tmp_path / f"{route}.png")
    cfg = str(tmp_path / "c.ini")
    with open(cfg, "w") as f:
        f.write(workspace["text"].replace(workspace["png"], png)
                .replace(workspace["out"], str(tmp_path / "coef.h5")))
    if route == "main":
        main([cfg, "--validate", "--device", "cpu"])
    else:
        validate_main([cfg, "--device", "cpu"])
    assert os.path.getsize(png) > 10_000


def gram_batch(nrec=6):
    """Near-singular Gram matrices AtWA of make_records' MAXL=3 records
    (a dense cluster of modes at the gelsd cutoff), trace-normalized."""
    values, errors, A, _ = make_records(3)
    AtWA = tsolve.suff_stats(*(torch.as_tensor(x) for x in (
        A, values[:nrec], errors[:nrec])))[0]
    return AtWA / tsolve.norm_scale(AtWA)[:, None, None]


def test_host_eigh_matches_torch_eigh():
    """The repair's CPU half: host_eigh on near-singular Gram matrices
    against one torch.linalg.eigh call: eigenvalues within 1e-15 of the
    largest (LAPACK's backward error) and V's columns of the well-separated
    top modes equal up to sign (1e-10); counted in both counters."""
    X = gram_batch()
    w_ref, V_ref = torch.linalg.eigh(X)
    e0, h0 = tsolve.eigh_matrices, tsolve.host_eigh_matrices
    w, V = tsolve.host_eigh(X)
    assert (tsolve.eigh_matrices - e0, tsolve.host_eigh_matrices - h0) == (6, 6)
    assert w.shape == w_ref.shape and V.shape == V_ref.shape
    assert (w - w_ref).abs().max() <= 1e-15 * w_ref.abs().max()
    top = slice(-8, None)  # the largest modes are well separated
    dots = (V[..., top] * V_ref[..., top]).sum(-2).abs()
    assert (dots - 1.0).abs().max() <= 1e-10
    # a batch the size of one thread slice, and a single matrix
    for x in (X[:1], X[0]):
        wx, Vx = tsolve.host_eigh(x)
        assert wx.shape == x.shape[:-1] and Vx.shape == x.shape
        assert (wx - torch.linalg.eigh(x)[0]).abs().max() <= 1e-15


def test_exact_fit_takes_atwa_eig_on_the_host():
    """fit_records decomposes every matrix through host_eigh: exact mode
    AtWA's, the whitened pencil's and two anchors' a record and R's once;
    fast mode AtWA's, the pencil's and the final solve's; exact_grid 101
    grid points, 40 bisection rounds for a record with a root and the
    final solve."""
    values, errors, A, R = make_records(2)
    for mode in ("exact", "fast", "exact_grid"):
        h0 = tsolve.host_eigh_matrices
        rp = tfit.fit_records(values, errors, A, R, regparam_mode=mode,
                              device="cpu")[3].numpy()[:, 0]
        roots = int((np.isfinite(rp) & (rp > 0)).sum())
        want = {"exact": 4 * 12 + 1, "fast": 3 * 12,
                "exact_grid": 102 * 12 + 40 * roots}[mode]
        assert tsolve.host_eigh_matrices - h0 == want, mode
