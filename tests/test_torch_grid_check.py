"""PyTorch port, Estimate's check that its cached grid is the caller's
grid: ``estimate.same_grid`` against the copy the cache keeps, shape,
dtype and every byte, counted by ``estimate.grid_hits`` and
``grid_misses``.  Every case runs with torch's intra-op thread count at 1
(one slice an array, on a pool of one thread) and at 7 (uneven slices on
7 threads), and every result after a miss is the bits of a fresh
Estimate's.  CPU only."""

import datetime as dt

import numpy as np
import pytest
import torch

from volumetricinterp_tpu_torch import Estimate, estimate
from volumetricinterp_tpu_torch.utils.hull import compute_hull_vertices

TEXT = """
[DEFAULT]
PARAM = dens

[MODEL]
NAME = sphharmlag
MAXK = 2
MAXL = 3
CAP_LIM = 10
MAX_Z_INT = INF
LATCP = 78
LONCP = 262
"""
NREC, NBASIS = 3, 18
UTIME = 1.6e9 + 60.0 * np.array([[0, 1], [1, 2], [2, 3]])
TIMES = [dt.datetime(1970, 1, 1) + dt.timedelta(seconds=float(u))
         for u in UTIME.mean(axis=1)]
THREADS = {"one_thread": 1, "slices": 7}


class MemEstimate(Estimate):
    """Seeded coefficients on a seeded FoV: no file, no fit."""

    def loadh5(self, filename=None):
        rng = np.random.default_rng(7)
        self.Coeffs = rng.normal(size=(NREC, NBASIS)) * 1e11
        self.Covariance = np.zeros((NREC, NBASIS, NBASIS))
        self.time = UTIME
        self.hull_vert = compute_hull_vertices(
            rng.uniform(75.0, 81.0, 200), rng.uniform(255.0, 270.0, 200),
            rng.uniform(150e3, 500e3, 200))
        self.config_file_text = TEXT
        self.chi2, self.raw_filename, self.timefit = None, None, None


@pytest.fixture(scope="module")
def shared():
    return MemEstimate(None, device="cpu")


@pytest.fixture(params=THREADS)
def est(shared, request):
    """The module's Estimate with an empty cache, under torch's intra-op
    thread count THREADS[param], which same_grid's slices follow."""
    nthreads = torch.get_num_threads()
    torch.set_num_threads(THREADS[request.param])
    shared._prepared_grid = shared._grid_ev = None
    yield shared
    torch.set_num_threads(nthreads)


def grid():
    return [a.copy() for a in np.meshgrid(np.linspace(74.0, 82.0, 12),
                                          np.linspace(252.0, 272.0, 10),
                                          np.linspace(1e5, 6e5, 6),
                                          indexing="ij")]


def counted(est, arrays):
    """est.evaluate_records over TIMES: (result, hits, misses) of the call."""
    hits, misses = estimate.grid_hits, estimate.grid_misses
    out = est.evaluate_records(TIMES, *arrays)
    return out, estimate.grid_hits - hits, estimate.grid_misses - misses


def assert_fresh(out, arrays):
    """``out`` is the bits of a fresh Estimate's result on ``arrays``."""
    want = MemEstimate(None, device="cpu").evaluate_records(TIMES, *arrays)
    assert out.shape == want.shape
    assert np.array_equal(out.view(np.uint32), want.view(np.uint32))


def test_the_same_grid_twice_misses_then_hits(est):
    arrays = grid()
    first, hits, misses = counted(est, arrays)
    assert (hits, misses) == (0, 1)
    nan = np.isnan(first)
    assert nan.any() and not nan.all()
    again, hits, misses = counted(est, arrays)
    assert (hits, misses) == (1, 0)
    assert np.array_equal(again.view(np.uint32), first.view(np.uint32))
    # a copy of the caller's arrays hits too: bytes, not identity
    _, hits, misses = counted(est, [a.copy() for a in arrays])
    assert (hits, misses) == (1, 0)


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("byte", [0, -1])
def test_an_edited_byte_misses(est, which, byte):
    """One byte of one array edited in place, the first byte (the lowest
    of the first value's mantissa) or the last (the last value's sign and
    exponent)."""
    arrays = grid()
    counted(est, arrays)
    arrays[which].reshape(-1).view(np.uint8)[byte] ^= 1
    out, hits, misses = counted(est, arrays)
    assert (hits, misses) == (0, 1)
    assert_fresh(out, arrays)


@pytest.mark.parametrize("change", ["shape", "dtype"])
def test_the_same_bytes_in_another_shape_or_dtype_miss(est, change):
    arrays = grid()
    counted(est, arrays)
    kept = est._prepared_grid["kept"]
    if change == "shape":
        other = [a.reshape(a.shape[1], a.shape[0], a.shape[2])
                 for a in arrays]
    else:
        other = [a.view(np.int64) for a in arrays]
    assert all(np.array_equal(o.reshape(-1).view(np.uint8),
                              k.reshape(-1).view(np.uint8))
               for o, k in zip(other, kept))
    assert not estimate.same_grid(kept, other)
    assert not estimate.same_grid(kept, arrays[:2] + other[2:])
    if change == "shape":
        out, hits, misses = counted(est, other)
        assert (hits, misses) == (0, 1)
        assert_fresh(out, other)


def test_a_grid_with_nan_hits_on_the_same_bytes(est):
    arrays = grid()
    arrays[2][3, 4, 5] = np.nan
    first, _, misses = counted(est, arrays)
    assert misses == 1
    again, hits, misses = counted(est, [a.copy() for a in arrays])
    assert (hits, misses) == (1, 0)
    assert np.array_equal(again.view(np.uint32), first.view(np.uint32))


def test_zero_and_negative_zero_differ(est):
    arrays = grid()
    arrays[2][3, 4, 5] = 0.0
    counted(est, arrays)
    arrays[2][3, 4, 5] = -0.0
    out, hits, misses = counted(est, arrays)
    assert (hits, misses) == (0, 1)
    assert_fresh(out, arrays)


def test_editing_the_callers_arrays_leaves_the_kept_copy(est):
    arrays = grid()
    before = [a.copy() for a in arrays]
    counted(est, arrays)
    kept = est._prepared_grid["kept"]
    assert not any(np.shares_memory(k, a) for k, a in zip(kept, arrays))
    for a in arrays:
        a[...] += 1.0
    assert all(np.array_equal(k, b) for k, b in zip(kept, before))
    out, hits, misses = counted(est, arrays)
    assert (hits, misses) == (0, 1)
    assert_fresh(out, arrays)
    _, hits, misses = counted(est, before)
    assert (hits, misses) == (0, 1)


def test_the_check_runs_on_torchs_thread_count(est, monkeypatch):
    """same_grid cuts each array into torch.get_num_threads() slices and
    compares them on a pool of as many threads, down to the last word."""
    pools = []

    class Pool(estimate.ThreadPoolExecutor):
        def __init__(self, n):
            pools.append(n)
            super().__init__(n)

    monkeypatch.setattr(estimate, "ThreadPoolExecutor", Pool)
    arrays = grid()
    counted(est, arrays)
    kept = est._prepared_grid["kept"]
    assert estimate.same_grid(kept, arrays)
    arrays[2].reshape(-1).view(np.uint64)[-1] ^= 1 << 63
    assert not estimate.same_grid(kept, arrays)
    assert pools == [torch.get_num_threads()] * 2
