"""PyTorch port, GCV: fit_records with method='gcv' in 'exact' and 'fast'
mode against the JAX package's fit_records on the same records, the
batched Nelder-Mead against the JAX one on a quadratic, and the anchored
objective's record slices against the whole batch; CPU float64."""

import threading

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from volumetricinterp_tpu.ops import regparam as jregparam

from volumetricinterp_tpu_torch.config import Config as TConfig
from volumetricinterp_tpu_torch.models.sphharmlag import Model as TModel
from volumetricinterp_tpu_torch.ops import regparam as tregparam
from volumetricinterp_tpu_torch.ops.fit import (atwa_eig, fit_records,
                                                reg_mats_eig)
from volumetricinterp_tpu_torch.ops.solve import masked_points, suff_stats

from test_torch_fit import CFG, _check_fit, _jax_fit, make_records
from test_torch_fit_chi2 import REGS, reg_mats


@pytest.fixture(scope="module", params=[2, 3], ids=["maxl2", "maxl3"])
def records(request):
    maxl = request.param
    values, errors, A, _ = make_records(maxl)
    return maxl, values, errors, A, {r: reg_mats(maxl, r) for r in REGS}


@pytest.mark.parametrize("regs", REGS)
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_gcv_matches_jax(records, mode, regs):
    """Same converged records, log10 alpha within 1e-3 decades (Nelder-
    Mead's xatol is 1e-4), C, dC and chi2 within 1e-6 of the sup: at the
    GCV alphas no record of this set keeps a mode at the cutoff wall."""
    maxl, values, errors, A, mats = records
    R = mats[regs]
    kw = dict(method="gcv", regparam_mode=mode)
    ref = _jax_fit(values, errors, A, R, **kw)
    got = tuple(t.numpy() for t in fit_records(values, errors, A, R,
                                               device="cpu", **kw))
    rp, rpj = got[3], ref[3]
    np.testing.assert_array_equal(np.isnan(rp), np.isnan(rpj))
    ok = np.isfinite(rpj)
    assert ok.sum() >= 10 * R.shape[0] and (rpj[ok] > 0).all()
    assert np.max(np.abs(np.log10(rp[ok]) - np.log10(rpj[ok]))) < 1e-3
    _check_fit(got, ref, values, errors, A, R, set())


def test_nelder_mead_matches_jax():
    """The batched minimizer takes scipy's trajectory: a batch of 1-D
    problems (three quadratics, one started at 0, and a slope that runs the
    evaluation budget out) against the JAX replica, record by record."""
    centres = np.array([-23.7, 3.1, 0.0, np.nan])
    x0 = np.array([-20.0, -20.0, 0.0, -20.0])

    def f_np(x, c):
        return x if np.isnan(c) else (x - c) ** 2 + 0.5

    def f_t(x):
        c = torch.as_tensor(centres)[:, None]
        return torch.where(torch.isnan(c), x, (x - c) ** 2 + 0.5)

    got_x, got_ok = tregparam.nelder_mead_1d(f_t, torch.as_tensor(x0))
    for i, c in enumerate(centres):
        xj, okj = jregparam.nelder_mead_1d(lambda x: f_np(x, c),
                                           jnp.asarray(x0[i]))
        assert float(got_x[i]) == float(xj) and bool(got_ok[i]) == bool(okj)
    assert got_ok[:3].all() and not got_ok[3]
    np.testing.assert_allclose(got_x[:3].numpy(), centres[:3], atol=1e-3)


def _production_batch(nrec=16, npts=400):
    """nrec records at the production order (MAXK=4, MAXL=6, nbasis 144)
    on npts random points of the FoV's box, 5% of each record's points
    dropped, and the inputs gcv_reg_param_x takes: (AtWA, AtWb, R, A, b,
    W, mask, eigA, eigR) as fit_records forms them."""
    model = TModel(TConfig.from_text(
        CFG.replace("MAXK = 2", "MAXK = 4").replace("MAXL = 3", "MAXL = 6")))
    rng = np.random.default_rng(23)
    lat, lon = rng.uniform(74.0, 82.0, npts), rng.uniform(252.0, 272.0, npts)
    alt = rng.uniform(1.0e5, 6.0e5, npts)
    A = torch.as_tensor(model.basis(lat, lon, alt))
    ne = 4e11 * np.exp(-(((alt - 3e5) / 1.2e5) ** 2))
    noise = 2e10 + 0.05 * ne
    values = ne + rng.normal(0, 1, (nrec, npts)) * noise
    values[rng.random((nrec, npts)) < 0.05] = np.nan
    values = torch.as_tensor(values)
    errors = torch.as_tensor(np.tile(1.15 * noise, (nrec, 1)))
    AtWA, AtWb, _, _ = suff_stats(A, values, errors)
    R = torch.as_tensor(model.eval_psi())
    VR, sR = reg_mats_eig(R[None])
    b, W, mask = masked_points(values, errors)
    return (AtWA, AtWb, R, A, b, W, mask, atwa_eig(AtWA), (VR[0], sR[0]))


@pytest.fixture
def one_thread():
    """One intra-op thread for the test, the caller's count put back: with
    six test processes of eight threads each on an 8-core host, the
    16-record search's elementwise passes ran five times slower (113 s
    against 22 s a search)."""
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(nthreads)


def _sliced(monkeypatch, npts):
    """GCV_SLICE_BYTES lowered to four records of five candidates at
    nbasis 144 on npts points (the [b, K, npts, n] tensors are the larger
    here): a 16-record batch in four slices (two at the first evaluation's
    two candidates)."""
    monkeypatch.setattr(tregparam, "GCV_SLICE_BYTES",
                        4 * 5 * npts * 144 * 8)
    assert len(tregparam.gcv_slices(16, 5, 144, npts)) == 4
    assert len(tregparam.gcv_slices(16, 2, 144, npts)) == 2


def test_gcv_sliced_objective_is_the_whole_batch(monkeypatch, one_thread):
    """The anchored GCV objective of a 16-record production-order batch in
    record slices (GCV_SLICE_BYTES lowered to four records) gives the bits
    of the whole batch in one slice, on both basis bundles, and so does
    the Nelder-Mead search over it (gcv_reg_param_x): every step of the
    objective treats its records independently, and on the CPU the batched
    inverse runs a matrix at a time on the host pool's workers.  At the
    shipped GCV_SLICE_BYTES a 128-record batch on the day's 580 points is
    one slice at the production order, four of 32 records at nbasis 1200."""
    AtWA, AtWb, R, A, b, W, mask, eigA, eigR = _production_batch()
    assert len(tregparam.gcv_slices(128, 5, 144, 580)) == 1
    assert [sl.stop - sl.start for sl in
            tregparam.gcv_slices(128, 5, 1200, 580)] == [32] * 4
    x = torch.as_tensor(np.linspace(-24.0, -16.0, 16 * 5)).reshape(16, 5)
    bundles = [tregparam.gcv_basis_bundle(V, AtWA, R, AtWb, A)
               for V in (eigA[1], eigR[0])]
    whole = [tregparam.gcv_objective_anchored(x, bun, b, W, mask)
             for bun in bundles]
    root = tregparam.gcv_reg_param_x(AtWA, AtWb, R, A, b, W, mask, eigA,
                                     eigR)
    assert torch.isfinite(root).all()
    _sliced(monkeypatch, A.shape[0])
    for bun, ref in zip(bundles, whole):
        got = tregparam.gcv_objective_anchored(x, bun, b, W, mask)
        assert got.shape == (16, 5) and torch.equal(got, ref)
    assert torch.equal(tregparam.gcv_reg_param_x(
        AtWA, AtWb, R, A, b, W, mask, eigA, eigR), root)


def _two_halves(inputs):
    """gcv_reg_param_x of the batch with its points in two halves, one a
    thread, each thread's objective summed over both by a point_sum (as
    the sharded layer's all_reduce, parallel/fit.py: the statistics are
    the whole batch's, A, b, W and mask the half's).  Returns each
    thread's roots and the shapes its point_sum was handed."""
    AtWA, AtWb, R, A, b, W, mask, eigA, eigR = inputs
    half = A.shape[0] // 2
    parts = (slice(0, half), slice(half, A.shape[0]))
    barrier, box = threading.Barrier(2), [None, None]
    roots, shapes = [None, None], [[], []]

    def run(i):
        def point_sum(obj):
            shapes[i].append(tuple(obj.shape))
            box[i] = obj
            barrier.wait()
            total = box[0] + box[1]
            barrier.wait()
            return total

        sl = parts[i]
        roots[i] = tregparam.gcv_reg_param_x(
            AtWA, AtWb, R, A[sl], b[:, sl], W[:, sl], mask[:, sl], eigA,
            eigR, point_sum=point_sum)

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return roots, shapes


def test_gcv_sliced_objective_under_a_point_sum(monkeypatch, one_thread):
    """With its points in two halves whose objectives a point_sum adds
    (the sharded layer's GCV layout), the search in record slices
    (GCV_SLICE_BYTES lowered to four records) gives the bits of the
    unsliced one: the slices are joined before the point_sum, which takes
    the whole [16, K] objective once an evaluation."""
    inputs = _production_batch()
    ref, ref_shapes = _two_halves(inputs)
    assert torch.equal(ref[0], ref[1]) and torch.isfinite(ref[0]).all()
    _sliced(monkeypatch, inputs[3].shape[0] // 2)
    got, shapes = _two_halves(inputs)
    assert shapes == ref_shapes
    assert all(sh[0] == 16 for sh in shapes[0])
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[0])
