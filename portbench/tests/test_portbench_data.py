"""The frozen generator, QC and reference model: determinism per seed, the
same sizes for every seed, agreement with the program's own reader and
basis (at the shipped order, where scipy resolves every function), and the
0th-order matrix against the program's."""

import numpy as np
import pytest

from portbench import harness
from portbench.reference import data, fit, model
from volumetricinterp_tpu_torch.config import Config
from volumetricinterp_tpu_torch.io.amisr import qc_datasets
from volumetricinterp_tpu_torch.models.sphharmlag import Model

_, CFG, _, _ = harness.cell_files("l6k4.day_fit")
DAY = dict(CFG["day"], nrec=12)
SEED = 2**31 + 17  # seeds may pass 32 bits


def test_same_seed_same_day_other_seed_other_day():
    a = data.make_day(DAY, CFG["MODEL"], SEED)
    b = data.make_day(DAY, CFG["MODEL"], SEED)
    c = data.make_day(DAY, CFG["MODEL"], SEED + 1)
    d = data.make_day(DAY, CFG["MODEL"], SEED, index=1)
    for k in data.PATHS:
        assert np.array_equal(a[k], b[k], equal_nan=True), k
        assert a[k].shape == c[k].shape == d[k].shape, k
    assert not np.array_equal(a["/FittedParams/Ne"], c["/FittedParams/Ne"],
                              equal_nan=True)
    assert not np.array_equal(a["/FittedParams/Ne"], d["/FittedParams/Ne"],
                              equal_nan=True)
    assert d["/Time/UnixTime"][0, 0] == a["/Time/UnixTime"][-1, 1]


def test_a_negative_seed_draws_a_day_of_its_own():
    neg = harness.seed_words(-SEED)
    assert harness.seed_words(SEED) == SEED and 0 <= neg < 2**64
    a = data.make_day(DAY, CFG["MODEL"], neg)
    b = data.make_day(DAY, CFG["MODEL"], SEED)
    assert a["/FittedParams/Ne"].shape == b["/FittedParams/Ne"].shape
    assert not np.array_equal(a["/FittedParams/Ne"], b["/FittedParams/Ne"],
                              equal_nan=True)


def test_qc_is_the_readers():
    src = data.make_day(DAY, CFG["MODEL"], SEED)
    f = CFG["DEFAULT"]
    mine = data.qc(src, f)
    theirs = qc_datasets(src, f["PARAM"], f["ERRLIM"], f["CHI2LIM"],
                         f["GOODFITCODE"])
    for a, b in zip(mine, theirs):
        assert np.array_equal(a, b, equal_nan=True)
    assert 0.0 < np.isnan(mine[4]).mean() < 0.1


@pytest.mark.parametrize("cell", ["l6k4.day_fit", "l10k12.window_fit"])
def test_reference_basis_and_psi_against_the_program(cell):
    _, cfg, _, _ = harness.cell_files(cell)
    m = Model(Config.from_text(harness.ini_text(cfg)))
    _, lat, lon, alt, _, _ = data.qc(data.make_day(DAY, cfg["MODEL"], SEED),
                                     cfg["DEFAULT"])
    B, Bp = model.basis(cfg["MODEL"], lat, lon, alt), m.basis(lat, lon, alt)
    # scipy's lpmv underflows to 0 where P_nu^{-m} is ~1e-41 (l = 9, m <=
    # -5): those columns are nothing against the others
    assert np.abs(B - Bp).max() <= 1e-10 * np.abs(Bp).max()
    P, Pp = model.psi(cfg["MODEL"]), m.eval_psi()
    assert np.abs(P - Pp).max() <= 1e-10 * np.abs(Pp).max()


def test_fixed_alpha_fit_is_the_regularized_solve():
    """On a well-posed problem (the day's own matrices sit at the cutoff,
    where the order of a sum moves the answer) every record's solve is
    (AtWA + alpha R)^-1 AtWb, NaN points left out."""
    rng = np.random.default_rng(5)
    A, R = rng.normal(size=(40, 6)), np.eye(6)
    v, e = rng.normal(size=(3, 40)), rng.uniform(1, 2, size=(3, 40))
    v[1, ::7] = np.nan
    C = fit.fixed_alpha_fit(v, e, A, R, 0.3)
    for i in range(3):
        ok = np.isfinite(v[i])
        W = e[i][ok] ** -2.0
        want = np.linalg.solve(A[ok].T @ (W[:, None] * A[ok]) + 0.3 * R,
                               A[ok].T @ (W * v[i][ok]))
        assert np.allclose(C[i], want, rtol=1e-12, atol=1e-12)


def test_tf32_rounding():
    from portbench.reference.product import tf32

    x = np.array([1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-12, -3.0],
                 np.float32)
    assert tf32(x).tolist() == [1.0 + 2.0**-10, 1.0 + 2.0**-10, -3.0]
