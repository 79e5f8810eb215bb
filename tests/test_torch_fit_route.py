"""PyTorch port, the fit engine's one decomposition route: every
eigendecomposition whose result becomes a fit's C, dC, chi^2 or alpha runs
through solve.host_eigh (LAPACK float64 on the host), in every
REGPARAM_MODE and method, in Interpolate's chunk pipeline, in the sharded
layer and in Interpolate's reference-API methods, and so does every one of
the leave-one-beam-out sweep's.

What is held here is the count of matrices each fit path decomposes
through solve.host_eigh (ROUTES and each test's own).  The fits
themselves are held against the JAX package by tests/test_torch_fit*.py."""

import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from volumetricinterp_tpu_torch import Interpolate, sweep
from volumetricinterp_tpu_torch.config import Config
from volumetricinterp_tpu_torch.io.amisr import qc_datasets
from volumetricinterp_tpu_torch.io.synth import synthetic_amisr_datasets
from volumetricinterp_tpu_torch.models.sphharmlag import Model
from volumetricinterp_tpu_torch.ops import fit as ops_fit
from volumetricinterp_tpu_torch.ops import solve
from volumetricinterp_tpu_torch.ops.fit import fit_records

from test_torch_fit import make_records
from test_torch_parallel import _env, _free_port, _run_world

NREC = 12  # make_records' records


class Counted:
    """``host``: the decompositions made through solve.host_eigh inside
    the block."""

    def __enter__(self):
        self.h0 = solve.host_eigh_matrices
        return self

    def __exit__(self, *exc):
        self.host = solve.host_eigh_matrices - self.h0


def _roots(rp):
    """Records whose search returned a root (a finite positive alpha)."""
    return int((np.isfinite(rp) & (rp > 0)).sum())


# (method, REGPARAM_MODE, nreg): the host eighs of a fit_records call of
# NREC records as a function of its alphas [nrec, nreg]; R's normalized
# basis (one matrix a regularization matrix) is taken once a call by the
# exact chi2 and exact GCV searches
ROUTES = {
    # AtWA's, the whitened pencil's, the seed and endgame anchors'
    ("chi2", "exact", 1): lambda rp: 4 * NREC + 1,
    # AtWA's, per matrix the pencil's and two anchors', the final solve's
    ("chi2", "exact", 2): lambda rp: (1 + 3 * 2 + 1) * NREC + 2,
    # 101 grid points (make_records' records all have points), 40
    # bisection rounds a root, the final solve's
    ("chi2", "exact_grid", 1): lambda rp: 102 * NREC + 40 * _roots(rp[:, 0]),
    # AtWA's, the pencil's, the final solve's
    ("chi2", "fast", 1): lambda rp: 3 * NREC,
    ("gcv", "fast", 1): lambda rp: 3 * NREC,
    # AtWA's and the final solve's
    ("gcv", "exact", 1): lambda rp: 2 * NREC + 1,
    # the final solve's
    ("manual", "exact", 1): lambda rp: NREC,
    # AtWA's, which is the cutoff solve itself
    ("chi2", "exact", 0): lambda rp: NREC,
    ("gcv", "fast", 0): lambda rp: NREC,
}


@pytest.mark.parametrize("route", list(ROUTES),
                         ids=["-".join(map(str, r)) for r in ROUTES])
def test_fit_records_decomposes_on_the_host(route):
    method, mode, nreg = route
    values, errors, A, R = make_records(2)
    R = np.concatenate([R, 3.0 * R])[:nreg]
    with Counted() as n:
        rp = fit_records(values, errors, A, R, method=method,
                         manual_params=[1e-23] * nreg, regparam_mode=mode,
                         device="cpu")[3].numpy()
    assert n.host == ROUTES[route](rp)
    assert _roots(rp[:, 0] if nreg else rp) > 0 or nreg == 0


def test_interpolate_pipeline_decomposes_on_the_host(small_config_text):
    """calc_coeffs in exact mode (its default) over three chunks: each
    chunk's AtWA, pencil and seed anchor prepared a chunk ahead on the
    pipeline's worker thread, its endgame anchor in the search; R's basis
    once a run."""
    nrec = 20
    text = (small_config_text.replace("OUTPUTFILENAME = test_output.h5",
                                      "OUTPUTFILENAME =")
            + "\n[TPU]\nCHUNK_SIZE = 8\n")
    data = synthetic_amisr_datasets(
        nrec=nrec, seed=3, smooth_in_model=Model(Config.from_text(text)))

    class MemInterpolate(Interpolate):
        def read_datafile(self, filename):
            return qc_datasets(data, self.param, self.errlim, self.chi2lim,
                               self.goodfitcode)

    interp = MemInterpolate(text, device="cpu")
    with Counted() as n:
        interp.calc_coeffs()
    assert np.isfinite(interp.chi_sq).sum() > nrec // 2
    assert n.host == 4 * nrec + 1


CHILD = r"""
import sys
import numpy as np
import torch

torch.set_num_threads(1)
rank, port, data, out = sys.argv[1:]
from volumetricinterp_tpu_torch.ops import fit as ops_fit
from volumetricinterp_tpu_torch.ops import solve
from volumetricinterp_tpu_torch.parallel import fit_records_sharded, make_mesh
from volumetricinterp_tpu_torch.parallel.distributed import (
    initialize_distributed)

initialize_distributed(coordinator=f"localhost:{port}", num_processes=2,
                       process_id=int(rank), device="cpu")
d = np.load(data)
res = {}
for method, mode in (("chi2", "exact"), ("chi2", "fast"), ("gcv", "exact"),
                     ("manual", "exact")):
    h0 = solve.host_eigh_matrices
    fit_records_sharded(d["values"], d["errors"], d["A"], d["R"],
                        make_mesh(1, 2), method=method,
                        manual_params=[1e-23], regparam_mode=mode,
                        device="cpu")
    res[f"{method}_{mode}"] = solve.host_eigh_matrices - h0
np.save(out + f".{rank}.npy", res)
print("child", rank, "ok", flush=True)
"""


def test_sharded_fit_decomposes_on_the_host(tmp_path):
    """fit_records_sharded in a 1x2 layout (a gloo world of two CPU
    processes): each rank takes prepare_stats of the reduced statistics,
    the single-process route.  chi2 and manual: a rank fits its 6 of the
    12 records; GCV: every rank fits the row's 12, each objective summed
    over the two point shards."""
    values, errors, A, R = make_records(2)
    data = tmp_path / "data.npz"
    np.savez(data, values=values, errors=errors, A=A, R=R)
    out = str(tmp_path / "counts")
    port = _free_port()
    _run_world(lambda i: [sys.executable, "-c", CHILD, str(i), str(port),
                          str(data), out], lambda i: _env(), 2)
    half = NREC // 2
    want = {"chi2_exact": 4 * half + 1, "chi2_fast": 3 * half,
            "gcv_exact": 2 * NREC + 1, "manual_exact": half}
    for rank in range(2):
        got = np.load(f"{out}.{rank}.npy", allow_pickle=True).item()
        assert got == want, rank


def test_reference_api_decomposes_on_the_host(small_config_text):
    """Interpolate's eval_C (one solve), find_reg_param's exact chi2 search
    (AtWA's, R's basis, the pencil's and two anchors'), its GCV search
    (one solve an objective evaluation) and chi2objfunct (one solve)."""
    values, errors, A, R = make_records(3)
    b, W, regs = values[0], errors[0] ** -2.0, {"0thorder": R[0]}
    interp = Interpolate(Config.from_text(small_config_text), device="cpu")
    calls = {"eval_C": (lambda: interp.eval_C(A, b, W, regs,
                                              {"0thorder": 1e-20},
                                              calccov=True), 1),
             "chi2": (lambda: interp.find_reg_param(A, b, W, regs), 5),
             "gcv": (lambda: interp.find_reg_param(A, b, W, regs, "gcv"),
                     None),
             "chi2objfunct": (lambda: interp.chi2objfunct(
                 -20.0, A, b, W, regs, 300.0, "0thorder"), 1)}
    for name, (call, want) in calls.items():
        with Counted() as n:
            call()
        assert n.host == want if want else n.host > 2, name


def test_sweep_decomposes_on_the_host():
    """lobo_cv's one decomposition a (record, beam, alpha) takes the fit's
    host route (tests/test_torch_sweep.py holds order_sweep's too)."""
    values, errors, A, R = make_records(2)
    beam = np.arange(A.shape[0]) % 4
    with Counted() as n:
        sweep.lobo_cv(values[:2], errors[:2], A, beam, R[0], [-20.0, -18.0],
                      device="cpu")
    assert n.host == 2 * 4 * 2


def test_card_statistics_do_not_follow_the_batch():
    """solve.padded_stats, the statistics as the card forms them: the
    plain product's values (within 1e-13 of each statistic's sup: another
    summation order), and each record's bits the same alone, in a short
    batch and in a long one, at any place in it."""
    values, errors, A, _ = make_records(2)
    t = [torch.as_tensor(x) for x in (A, values, errors)]
    ref = solve.suff_stats(*t)
    whole = solve.padded_stats(*t, batch=8)
    for got, want in zip(whole, ref):
        assert got.shape == want.shape
        assert (got - want).abs().max() <= 1e-13 * want.abs().max()
    for sl in (slice(5, 6), slice(3, 10), slice(9, 12)):
        part = solve.padded_stats(t[0], t[1][sl], t[2][sl], batch=8)
        for got, want in zip(part, whole):
            assert torch.equal(got, want[sl])


@pytest.mark.parametrize("route", [("chi2", "exact"), ("chi2", "fast"),
                                   ("gcv", "exact"), ("manual", "exact")],
                         ids=lambda r: "-".join(r))
def test_card_padding_is_dropped(route, monkeypatch):
    """prepare_stats pads a chunk with empty records on the card (none on
    the CPU); with that padding forced here (12 records to 16), fit_records
    returns the 12 records' fits, the padded ones' failures neither
    returned nor reported: the outcome classes of the plain fit, and
    where the fit is smooth in the statistics (fast, manual, GCV's
    objective) its values to 1e-9."""
    method, mode = route
    values, errors, A, R = make_records(2)
    kw = dict(method=method, manual_params=[1e-23], regparam_mode=mode,
              device="cpu")
    plain = [x.numpy() for x in fit_records(values, errors, A, R, **kw)]
    monkeypatch.setattr(ops_fit, "_padding", lambda v: -v.shape[0] % 8)
    neg0 = ops_fit.negative_chi2_reports
    with Counted() as n:
        padded = [x.numpy() for x in fit_records(values, errors, A, R, **kw)]
    assert ops_fit.negative_chi2_reports == neg0
    for got, want in zip(padded, plain):
        assert got.shape == want.shape
    C, _, chi2, rp = padded
    np.testing.assert_array_equal(np.isnan(chi2), np.isnan(plain[2]))
    np.testing.assert_array_equal(rp > 0, plain[3] > 0)
    if mode == "fast" or method != "chi2":
        np.testing.assert_allclose(chi2, plain[2], rtol=1e-9)
        np.testing.assert_allclose(C, plain[0], rtol=1e-9,
                                   atol=1e-9 * np.nanmax(np.abs(plain[0])))


def test_exact_grid_decomposes_no_empty_grid(monkeypatch):
    """exact_grid with an empty record (every value NaN) and the card's
    padding forced (12 records to 16): the empty and the padded records,
    whose chi^2 is 0 at every alpha, take no grid and fail as in the
    plain fit; every record with points keeps the plain fit's alpha and
    chi^2 bits (the same grid batches); host eighs 101 a record with
    points, 40 a root, one final solve a record, the padding's too."""
    values, errors, A, R = make_records(2)
    values[4] = np.nan
    kw = dict(regparam_mode="exact_grid", device="cpu")
    plain = [x.numpy() for x in fit_records(values, errors, A, R, **kw)]
    monkeypatch.setattr(ops_fit, "_padding", lambda v: -v.shape[0] % 8)
    with Counted() as n:
        padded = [x.numpy() for x in fit_records(values, errors, A, R, **kw)]
    rp = padded[3][:, 0]
    assert np.isnan(rp[4]) and np.isnan(plain[3][4, 0])
    np.testing.assert_array_equal(rp, plain[3][:, 0])
    np.testing.assert_array_equal(padded[2], plain[2])
    assert n.host == 101 * (NREC - 1) + 16 + 40 * _roots(rp)


def test_host_eigh_slices_keep_the_bits(monkeypatch):
    """solve.host_eigh under a bound lowered to three matrices a slice
    (HOST_EIGH_SLICE_BYTES): ten matrices in slices of 3, 3, 3 and 1, and
    the bits of the unsplit call, each matrix counted once."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(2, 5, 40, 40))
    X = torch.as_tensor(X + X.swapaxes(-1, -2))
    w0, V0 = solve.host_eigh(X)
    monkeypatch.setattr(solve, "HOST_EIGH_SLICE_BYTES", 3 * 40 * 40 * 8 + 8)
    assert solve.eigh_slices(X.reshape(10, 40, 40)) == [
        slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 12)]
    with Counted() as n:
        w, V = solve.host_eigh(X)
    assert n.host == 10
    assert w.shape == (2, 5, 40) and V.shape == X.shape
    assert torch.equal(w, w0) and torch.equal(V, V0)


FIT_TWICE = """
import sys
import numpy as np
from volumetricinterp_tpu_torch import Interpolate
from volumetricinterp_tpu_torch.config import Config
from volumetricinterp_tpu_torch.io.amisr import qc_datasets
from volumetricinterp_tpu_torch.io.synth import synthetic_amisr_datasets
from volumetricinterp_tpu_torch.models.sphharmlag import Model

text = sys.stdin.read()
data = synthetic_amisr_datasets(smooth_in_model=Model(Config.from_text(text)),
                                nrec=20, seed=5, nan_frac=0.03, bad_frac=0.01)


class MemInterpolate(Interpolate):
    def read_datafile(self, filename):
        return qc_datasets(data, self.param, self.errlim, self.chi2lim,
                           self.goodfitcode)


fits = []
for _ in range(2):
    interp = MemInterpolate(text, device="cpu")
    interp.calc_coeffs()
    fits.append((interp.Coeffs, interp.chi_sq))
print("EQUAL" if all(np.array_equal(a, b, equal_nan=True)
                     for a, b in zip(*fits)) else "DIFFER")
"""


def test_fit_bits_do_not_follow_the_host_pools(small_config_text):
    """The first fit of a fresh process, made before any host pool exists,
    and a second one after: the same bits.  A pool worker's one-thread
    limit must not reach Interpolate's chunk worker, started after the
    first fit's pools, since a CPU product's bits follow its thread count
    (8 threads here, where the statistics of tests/test_torch_end2end.py's
    day come out in other bits than on one thread)."""
    text = (small_config_text.replace("OUTPUTFILENAME = test_output.h5",
                                      "OUTPUTFILENAME =")
            + "\n[TPU]\nQUAD_MODE = gauss\nREGPARAM_MODE = exact_grid\n"
            "CHUNK_SIZE = 8\n")
    env = dict(_env(), OMP_NUM_THREADS="8")
    res = subprocess.run([sys.executable, "-c", FIT_TWICE], input=text,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split()[-1] == "EQUAL"


def test_host_pool_keeps_the_thread_count():
    """A host pool's workers run on one intra-op thread each; the thread
    that made the pool, and a thread started after it, keep the count they
    had."""
    counts = {}

    def make_pool():
        counts["caller"] = torch.get_num_threads()
        pool = solve._host_pool()
        counts["workers"] = {pool.submit(torch.get_num_threads).result()
                             for _ in range(4 * solve.HOST_EIGH_THREADS)}
        counts["caller after"] = torch.get_num_threads()

    def later():
        counts["later"] = torch.get_num_threads()

    for target in (make_pool, later):
        t = threading.Thread(target=target)
        t.start()
        t.join()
    n = torch.get_num_threads()
    assert counts == {"caller": n, "workers": {1}, "caller after": n,
                      "later": n}
