"""PyTorch port, the parallel layer (parallel/): gloo worlds of CPU child
processes fit a small problem through fit_records_sharded in every mode
and evaluate a grid through grid_eval_sharded, against the single-process
port; a layout larger than the world raises; the CLI's --distributed runs
a two-process fit with the VITPU_* variables.

Bars (the JAX package's tests/test_sharding.py:72-95 and
tests/test_distributed.py:134-142): chi2 within rtol 1e-3, log10 alpha
within 1e-3 (fast mode: the alphas within rtol 1e-6), the field A C within
1e-3 of its sup, the sharded grid equal to the local one.  The statistics
are summed over point shards in another order than on one process, and the
gelsd cutoff of this ill-conditioned basis turns that into ~1e-4 noise.
log10 alpha is held where alpha is data-determined: where the penalty
alpha C'RC is above 1e-12 of chi2.  Below it (one GCV record here, at
1e-16) the objective is flat to rounding and either fit is unregularized
in effect, which is what is held there.  Every child has its own
timeout."""

import contextlib
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from volumetricinterp_tpu_torch import Interpolate
from volumetricinterp_tpu_torch.config import Config
from volumetricinterp_tpu_torch.io.coeffs import load_coeff_file
from volumetricinterp_tpu_torch.io.synth import write_synthetic_amisr
from volumetricinterp_tpu_torch.models.sphharmlag import Model
from volumetricinterp_tpu_torch.ops.fit import fit_records
from volumetricinterp_tpu_torch.ops.grid_eval import GridEvaluator
from volumetricinterp_tpu_torch.parallel import make_mesh

ROOT = Path(__file__).resolve().parent.parent
CHILD_TIMEOUT = 180  # seconds, each child process
# (tag, method, REGPARAM_MODE, manual alphas)
SETTINGS = (("exact", "chi2", "exact", None), ("fast", "chi2", "fast", None),
            ("manual", "manual", "exact", [1e-23]),
            ("gcv", "gcv", "exact", None))

CHILD = r"""
import sys
import numpy as np
import torch

torch.set_num_threads(1)
rank, n, port, r, p, data, out = sys.argv[1:]
rank, n, r, p = int(rank), int(n), int(r), int(p)
from volumetricinterp_tpu_torch.config import Config
from volumetricinterp_tpu_torch.models.sphharmlag import Model
from volumetricinterp_tpu_torch.ops.grid_eval import GridEvaluator
from volumetricinterp_tpu_torch.parallel import (
    fit_records_sharded, grid_eval_sharded, make_mesh)
from volumetricinterp_tpu_torch.parallel.distributed import (
    fit_records_distributed, initialize_distributed)

assert initialize_distributed(coordinator=f"localhost:{port}",
                              num_processes=n, process_id=rank,
                              device="cpu") == (rank, n)
d = np.load(data)
res = {}
try:
    make_mesh(2 * r, p)
except ValueError:
    res["too_large_raised"] = True
mesh = make_mesh(r, p)
assert (mesh.records, mesh.points, mesh.row, mesh.col) == (r, p, rank // p,
                                                           rank % p)
for tag, method, mode, manual in SETTINGS:
    out_ = fit_records_sharded(d["values"], d["errors"], d["A"], d["R"], mesh,
                               method=method, manual_params=manual,
                               regparam_mode=mode, device="cpu")
    for k, x in zip(("C", "dC", "chi2", "rp"), out_):
        res[f"{tag}_{k}"] = x.numpy()
# a resumed fit needs one process: process 0 alone holds the file
from volumetricinterp_tpu_torch import Interpolate
try:
    Interpolate(str(d["cfg"]), device="cpu").calc_coeffs(resume=True)
except ValueError as err:
    res["resume_raised"] = "one-process run" in str(err)
# the default global layout: every process on the records axis
for k, x in zip(("C", "dC", "chi2", "rp"), fit_records_distributed(
        d["values"], d["errors"], d["A"], d["R"], regparam_mode="fast",
        device="cpu")):
    res[f"global_fast_{k}"] = x.numpy()
model = Model(Config.from_text(str(d["cfg"])))
ev = GridEvaluator(model, tuple(d["band"]), device="cpu")
res["grid"] = grid_eval_sharded(ev, d["Cg"], d["glat"], d["glon"], d["galt"],
                                mesh).numpy()
np.savez(out + f".{rank}.npz", **res)
# gloo's threads joined before the interpreter exits: without this a child
# could abort at exit ("terminate called without an active exception")
torch.distributed.destroy_process_group()
print("child", rank, "ok", flush=True)
""".replace("SETTINGS", repr(SETTINGS))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(argv_of, env_of, n):
    """Start n child processes (argv_of(rank), env_of(rank)) and wait for
    each within CHILD_TIMEOUT; returns their outputs."""
    procs = [subprocess.Popen(argv_of(i), cwd=str(ROOT), env=env_of(i),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(n)]
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    for pr, o in zip(procs, outs):
        assert pr.returncode == 0, o[-3000:]
    return outs


@contextlib.contextmanager
def _one_thread():
    """The children's thread count (one) for the single-process fits they
    are held against: BLAS sums in another order on more threads, and on
    this ill-conditioned basis that moves an exact root by ~2e-3 decades
    of alpha, which is not what these tests measure."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="",
                OMP_NUM_THREADS="1", **extra)


@pytest.fixture(scope="module")
def problem(tmp_path_factory, small_config_text):
    """tests/test_sharding.py's problem: 437 points, 10 records (neither
    divisible by the layouts), 5% dropouts; a 6,000-point grid."""
    model = Model(Config.from_text(small_config_text))
    rng = np.random.default_rng(17)
    npts, nrec = 437, 10
    lat = rng.uniform(74, 82, npts)
    lon = rng.uniform(252, 272, npts)
    alt = rng.uniform(1e5, 6e5, npts)
    A = model.basis(lat, lon, alt)
    target = 4e11 * np.exp(-((alt - 3e5) / 1.2e5) ** 2)
    C_true = np.linalg.lstsq(A, target, rcond=1e-10)[0]
    values = np.zeros((nrec, npts))
    errors = np.zeros((nrec, npts))
    for r in range(nrec):
        ne = A @ C_true * (1.0 + 0.02 * r)
        noise = 2e10 + 0.05 * np.abs(ne)
        values[r] = ne + rng.normal(0, 1, npts) * noise
        errors[r] = 1.15 * noise
        drop = rng.random(npts) < 0.05
        values[r, drop] = np.nan
        errors[r, drop] = np.nan
    R = model.eval_psi()[None]
    glat, glon, galt = np.meshgrid(np.linspace(74.5, 81.0, 40),
                                   np.linspace(254.0, 270.0, 30),
                                   np.linspace(1.5e5, 5e5, 5))
    _, t, _ = model.transform_coord(glat, glon, galt)
    band = (float(t.min()), float(t.max()))
    Cg = rng.normal(size=model.nbasis) * 1e11
    data = tmp_path_factory.mktemp("parallel") / "data.npz"
    np.savez(data, values=values, errors=errors, A=A, R=R, cfg=small_config_text,
             band=band, Cg=Cg, glat=glat, glon=glon, galt=galt)
    single = {}
    with _one_thread():
        for tag, method, mode, manual in SETTINGS:
            res = fit_records(values, errors, A, R, method=method,
                              manual_params=manual, regparam_mode=mode,
                              device="cpu")
            single[tag] = [x.numpy() for x in res]
    ev = GridEvaluator(model, band, device="cpu")
    local = ev(Cg, glat, glon, galt).numpy()
    return dict(data=data, A=A, R=R[0], single=single, local=local)


def _penalty_share(C, chi2, rp, R):
    """alpha C'RC / chi2 per record (one regularization matrix)."""
    return rp[:, 0] * np.einsum("ri,ij,rj->r", C, R, C) / chi2


def _held(got, ref, A, R, tag):
    """The bars of the module docstring, got/ref (C, dC, chi2, rp)."""
    C, _, chi2, rp = got
    Cr, _, chi2r, rpr = ref
    np.testing.assert_array_equal(np.isnan(chi2), np.isnan(chi2r))
    np.testing.assert_allclose(chi2, chi2r, rtol=1e-3)
    ok = np.isfinite(rpr) & (rpr > 0)
    np.testing.assert_array_equal(np.isfinite(rp) & (rp > 0), ok)
    if tag == "fast":
        np.testing.assert_allclose(rp[ok], rpr[ok], rtol=1e-6)
    else:
        flat = ok[:, 0] & (_penalty_share(Cr, chi2r, rpr, R) <= 1e-12)
        assert (_penalty_share(C, chi2, rp, R)[flat] <= 1e-12).all(), tag
        ok = ok & ~flat[:, None]
        assert np.max(np.abs(np.log10(rp[ok]) - np.log10(rpr[ok])),
                      initial=0.0) <= 1e-3, tag
    f, fr = C @ A.T, Cr @ A.T
    assert np.nanmax(np.abs(f - fr)) <= 1e-3 * np.nanmax(np.abs(fr)), tag


@pytest.mark.parametrize("layout", [(2, 1), (1, 2), (2, 2)],
                         ids=["2x1", "1x2", "2x2"])
def test_sharded_world_matches_single_process(problem, layout):
    r, p = layout
    n = r * p
    port = _free_port()
    out = str(problem["data"]) + f".{r}x{p}"
    _run_world(lambda i: [sys.executable, "-c", CHILD, str(i), str(n),
                          str(port), str(r), str(p), str(problem["data"]),
                          out],
               lambda i: _env(), n)
    res = [np.load(f"{out}.{i}.npz") for i in range(n)]
    for k in res[0].files:  # every rank returns the full results
        for other in res[1:]:
            np.testing.assert_array_equal(other[k], res[0][k], err_msg=k)
    got = res[0]
    assert got["too_large_raised"] and got["resume_raised"]
    for tag, *_ in SETTINGS:
        g = [got[f"{tag}_{k}"] for k in ("C", "dC", "chi2", "rp")]
        assert g[0].shape == (10, 18) and g[1].shape == (10, 18, 18)
        _held(g, problem["single"][tag], problem["A"], problem["R"], tag)
    _held([got[f"global_fast_{k}"] for k in ("C", "dC", "chi2", "rp")],
          problem["single"]["fast"], problem["A"], problem["R"], "fast")
    np.testing.assert_array_equal(got["grid"], problem["local"])


def test_layout_larger_than_world_raises(small_config_text, tmp_path):
    """One process: a 1x1 mesh is the whole world; MESH_RECORDS = 2 or
    MESH_POINTS = 2 needs two processes and raises instead of running on
    one."""
    mesh = make_mesh()
    assert (mesh.records, mesh.points, mesh.size, mesh.group) == (1, 1, 1,
                                                                  None)
    for r, p in ((2, 1), (1, 2), (0, 2)):
        with pytest.raises(ValueError, match="needs 2 processes"):
            make_mesh(r, p)
    raw = str(tmp_path / "day.h5")
    write_synthetic_amisr(raw, nrec=2, seed=5)
    text = (small_config_text.replace("test_input.h5", raw)
            .replace("OUTPUTFILENAME = test_output.h5", "OUTPUTFILENAME =")
            + "\n[TPU]\nMESH_POINTS = 2\n")
    with pytest.raises(ValueError, match="MESH_RECORDS x MESH_POINTS"):
        Interpolate(text, device="cpu").calc_coeffs()


def test_cli_distributed(small_config_text, tmp_path):
    """volumetricinterp-torch --distributed in two processes (VITPU_*
    variables, gloo on the CPU, MESH_POINTS = 2): each prints its place,
    process 0 writes the file, and the fit holds the bars against the
    one-process fit."""
    raw = str(tmp_path / "day.h5")
    write_synthetic_amisr(raw, nrec=6, seed=5, nan_frac=0.03, bad_frac=0.01,
                          smooth_in_model=Model(Config.from_text(
                              small_config_text)))
    text = (small_config_text.replace("test_input.h5", raw)
            .replace("test_output.h5", str(tmp_path / "dist.h5"))
            + "\n[TPU]\nQUAD_MODE = gauss\nMESH_POINTS = 2\n")
    cfg = tmp_path / "dist.ini"
    cfg.write_text(text)
    port = _free_port()
    code = ("import sys; from volumetricinterp_tpu_torch.cli import main; "
            "main(sys.argv[1:])")
    outs = _run_world(
        lambda i: [sys.executable, "-c", code, str(cfg), "--distributed",
                   "--device", "cpu"],
        lambda i: _env(VITPU_COORDINATOR=f"localhost:{port}",
                       VITPU_NUM_PROCESSES="2", VITPU_PROCESS_ID=str(i)), 2)
    for i, o in enumerate(outs):
        assert f"distributed: process {i} / 2" in o, o[-2000:]
    got = load_coeff_file(str(tmp_path / "dist.h5"))
    one = Interpolate(text.replace("MESH_POINTS = 2", "MESH_POINTS = 1")
                      .replace("dist.h5", "one.h5"), device="cpu")
    with _one_thread():
        one.calc_coeffs()
    _, lat, lon, alt, *_ = one.read_datafile(raw)
    _held((got["Coeffs"], None, got["chi2"], got["reg_params"]),
          (one.Coeffs, None, one.chi_sq, one.reg_params),
          one.model.basis(lat, lon, alt), one.model.eval_psi(), "exact")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Interpolate(text)  # device="cuda" is the default
