"""PyTorch port, the reference-API surface: Interpolate's regularization
methods, the single-record and plain-GCV library functions, the sphharmlag
Model's helpers and its device design path (tensor points), radbasfun's
design_from_ecef, the Legendre tables' torch evaluation, the device hull
test and Estimate.check_hull, and the model registry's module lookup; each
held against the JAX package's function on the same seeded inputs (float64
on the CPU) and, where one exists, against tests/oracle."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from volumetricinterp_tpu import Interpolate as JInterpolate
from volumetricinterp_tpu.config import Config as JConfig
from volumetricinterp_tpu.models.sphharmlag import Model as JModel
from volumetricinterp_tpu.models.radbasfun import Model as JRBF
from volumetricinterp_tpu.ops import fit as jfit
from volumetricinterp_tpu.ops import regparam as jregparam
from volumetricinterp_tpu.ops.solve import suff_stats as jsuff_stats
from volumetricinterp_tpu import tables as jtables
from volumetricinterp_tpu.utils import hull as jhull
from volumetricinterp_tpu_torch import Estimate, Interpolate
from volumetricinterp_tpu_torch.config import Config
from volumetricinterp_tpu_torch.models.sphharmlag import Model
from volumetricinterp_tpu_torch.models.radbasfun import Model as RBF
from volumetricinterp_tpu_torch.ops import fit, regparam
from volumetricinterp_tpu_torch import tables
from volumetricinterp_tpu_torch.utils import hull
from tests.oracle import oracle_chi2_param, oracle_eval_C
from tests.oracle.ref_impl import _chi2_of, oracle_gcv_param

REG = "0thorder"  # small_config_text's REGULARIZATION_LIST


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _col_err(a, ref):
    """Largest |a - ref| in any column (last axis, and the component axis
    of a gradient) over that column's sup."""
    a, ref = _np(a), _np(ref)
    axes = tuple(range(ref.ndim - 1 if ref.ndim == 2 else ref.ndim - 2))
    sup = np.abs(ref).max(axis=axes)
    return float(np.max(np.abs(a - ref).max(axis=axes)
                        / np.where(sup > 0, sup, 1.0)))


# ---------------------------------------------------------------------------
# Interpolate: eval_C, find_reg_param, chi2objfunct, manual, prompt
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def problem(small_config_text):
    """The well-conditioned random design of tests/test_api_surface.py
    (sub-cutoff directions of the real basis carry O(1) noise in any
    solver, docs/PARITY_NOTES.md #7), with the noise and the matrix's
    scale set so that chi2 = nu has a root inside (1e-100, 1): the floor
    chi^2 (~187) lies below 0.6 N and chi^2(alpha = 1) above it."""
    ti = Interpolate(Config.from_text(small_config_text), device="cpu")
    ji = JInterpolate(JConfig.from_text(small_config_text))
    nb = ti.model.nbasis
    rng = np.random.default_rng(12)
    npts = 400
    A = rng.normal(size=(npts, nb))
    b = A @ rng.normal(size=nb) + 0.07 * rng.normal(size=npts)
    W = np.full(npts, 100.0)
    psi = 1e4 * (np.eye(nb) + 0.1 * np.ones((nb, nb)))
    return ti, ji, A, b, W, {REG: psi}


@pytest.mark.parametrize("ref", ["jax", "oracle"])
def test_eval_C(problem, ref):
    ti, ji, A, b, W, regs = problem
    params = {REG: 1e-23}
    C, dC = ti.eval_C(A, b, W, regs, params, calccov=True)
    assert C.dtype == torch.float64 and C.device.type == "cpu"
    if ref == "jax":
        C_ref, dC_ref = (np.asarray(q) for q in ji.eval_C(
            A, b, W, regs, params, calccov=True))
    else:
        C_ref, dC_ref = oracle_eval_C(A, b, W, [regs[REG]], [1e-23],
                                      calccov=True)
    np.testing.assert_allclose(C.numpy(), C_ref, rtol=1e-9,
                               atol=1e-12 * np.abs(C_ref).max())
    np.testing.assert_allclose(dC.numpy(), dC_ref, rtol=1e-8,
                               atol=1e-11 * np.abs(dC_ref).max())
    np.testing.assert_array_equal(ti.eval_C(A, b, W, regs, params).numpy(),
                                  C.numpy())


@pytest.mark.parametrize("ref", ["jax", "oracle"])
def test_find_reg_param_chi2(problem, ref):
    """rtol 1e-5 against the JAX package.  Against the oracle's brentq
    root the JAX package's own exact search lands 1.56e-5 low in alpha
    here (its root solves chi2 = nu to 3.6e-6), so that leg holds the
    root's equation, chi2(alpha) = nu, to 1e-5 and alpha to 2e-5."""
    ti, ji, A, b, W, regs = problem
    out = ti.find_reg_param(A, b, W, regs, method="chi2")
    assert isinstance(out[REG], float)
    assert ti.chi2(A, b, W, regs, REG) == out[REG]
    if ref == "jax":
        want = ji.find_reg_param(A, b, W, regs, method="chi2")[REG]
        assert np.isfinite(want) and np.isclose(out[REG], want, rtol=1e-5)
        return
    want = oracle_chi2_param(A, b, W, [regs[REG]], 0)
    nu = 0.6 * len(b)  # the rung the oracle's root sits on
    assert np.isclose(_chi2_of(np.log10(want), A, b, W, [regs[REG]], 0), nu,
                      rtol=1e-12)
    assert np.isclose(_chi2_of(np.log10(out[REG]), A, b, W, [regs[REG]], 0),
                      nu, rtol=1e-5)
    assert np.isclose(out[REG], want, rtol=2e-5)


@pytest.mark.parametrize("ref", ["jax", "oracle"])
def test_find_reg_param_gcv(problem, gcv_problem, ref):
    """|dlog10 alpha| within the Nelder-Mead xatol (5e-4), on the small
    problem of tests/test_gcv.py (the oracle refits every point for every
    objective call), R scaled so that the minimum lies two decades from
    the search's start."""
    ti, ji = problem[:2]
    A, b, W, R = gcv_problem
    R = GCV_SCALE * R
    regs = {REG: R}
    want = (ji.find_reg_param(A, b, W, regs, method="gcv")[REG]
            if ref == "jax" else oracle_gcv_param(A, b, W, [R], 0))
    out = ti.find_reg_param(A, b, W, regs, method="gcv")
    assert isinstance(out[REG], float) and np.isfinite(want)
    assert abs(np.log10(out[REG]) - np.log10(want)) < 5e-4
    assert ti.gcv(A, b, W, regs, REG) == out[REG]


@pytest.mark.parametrize("ref", ["jax", "oracle"])
def test_chi2objfunct(problem, ref):
    ti, ji, A, b, W, regs = problem
    for a in [-6.0, -2.0, 0.0]:
        ours = ti.chi2objfunct(a, A, b, W, regs, nu=400.0, reg=REG)
        assert isinstance(ours, float)
        want = (ji.chi2objfunct(a, A, b, W, regs, nu=400.0, reg=REG)
                if ref == "jax" else _chi2_of(a, A, b, W, [regs[REG]], 0)
                - 400.0)
        assert np.isclose(ours, want, rtol=1e-7), a


def test_manual_prompt_and_unknown_method(problem, monkeypatch):
    ti, ji, A, b, W, regs = problem
    assert ti.manual(A, b, W, {}, "curvature") == 1.0e-28
    assert ti.manual(A, b, W, {}, "0thorder") == 1.0e-23
    with pytest.raises(ValueError):
        ti.manual(A, b, W, {}, "unknown_reg")
    assert ti.find_reg_param(A, b, W, regs, method="manual") == \
        ji.find_reg_param(A, b, W, regs, method="manual") == {REG: 1.0e-23}
    asked = []
    monkeypatch.setattr("builtins.input",
                        lambda msg: asked.append(msg) or "2.5e-20")
    assert ti.prompt(A, b, W, regs, REG) == 2.5e-20
    assert ti.find_reg_param(A, b, W, regs, method="prompt") == {REG: 2.5e-20}
    assert asked == [f"Enter {REG} regularization parameter: "] * 2
    with pytest.raises(ValueError):
        ti.find_reg_param(A, b, W, regs, method="lcurve")


def test_find_reg_param_nan_warns(problem, caplog):
    """A record whose floor chi^2 lies above N at every rung has no root:
    NaN and the reference's warning, as in the JAX package."""
    ti, ji, A, b, W, regs = problem
    W = np.full_like(W, 1e6)
    with caplog.at_level("WARNING"):
        out = ti.find_reg_param(A, b, W, regs, method="chi2")
    assert np.isnan(out[REG])
    assert np.isnan(ji.find_reg_param(A, b, W, regs, method="chi2")[REG])
    assert "Could not find any roots" in caplog.text


def test_find_reg_param_too_smooth_is_zero(problem):
    """chi^2 below nu already at alpha = 1: the too-smooth outcome reads
    0.0 (-inf in log10), as the JAX package and the oracle give."""
    ti, ji, A, b, W, regs = problem
    W = np.full_like(W, 1e-4)
    assert ti.find_reg_param(A, b, W, regs, method="chi2") == {REG: 0.0}
    assert ji.find_reg_param(A, b, W, regs, method="chi2") == {REG: 0.0}
    assert oracle_chi2_param(A, b, W, [regs[REG]], 0) == 0.0


# ---------------------------------------------------------------------------
# ops: gcv_objective, gcv_reg_param, record_stats, fit_one_record
# ---------------------------------------------------------------------------

# GCV searches start at log10 alpha = -20, where the objective of
# gcv_problem is flat to its last bits (its minimum is near alpha = 1): a
# search there walks near-ties.  R scaled by GCV_SCALE moves the minimum to
# -17.6 (-18.4 with two points masked), inside the search's reach.
GCV_SCALE = 1e18


@pytest.fixture(scope="module")
def gcv_problem():
    """tests/test_gcv.py's small problem."""
    rng = np.random.default_rng(8)
    npts, nb = 60, 8
    A = rng.normal(size=(npts, nb))
    R = np.eye(nb) + 0.1 * np.ones((nb, nb))
    b = A @ rng.normal(size=nb) + 0.3 * rng.normal(size=npts)
    W = np.full(npts, 1.0 / 0.09)
    return A, b, W, R


def _brute_force_gcv(A, b, W, R, a_log):
    """Delete each point, refit (scipy lstsq), score it
    (tests/test_gcv.py:30-58)."""
    import scipy.linalg

    total = 0.0
    for i in range(len(b)):
        Ai, bi, Wi = (np.delete(x, i, 0) for x in (A, b, W))
        X = np.einsum("ji,j,jk->ik", Ai, Wi, Ai) + 10.0**a_log * R
        y = np.einsum("ji,j,j->i", Ai, Wi, bi)
        C = scipy.linalg.lstsq(X, y)[0]
        total += (A[i] @ C - b[i]) ** 2 * W[i]
    return total


@pytest.mark.parametrize("a_log", [-3.0, -1.0, 0.5, 2.0])
def test_gcv_objective(gcv_problem, a_log):
    A, b, W, R = gcv_problem
    mask = np.ones_like(b)
    stats = jsuff_stats(*(jnp.asarray(x) for x in (A, b, W, mask)))
    want = float(jregparam.gcv_objective(
        a_log, stats[0], stats[1], jnp.asarray(R), jnp.asarray(A),
        jnp.asarray(b), jnp.asarray(W), jnp.asarray(mask)))
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    AtWA = t(A).T @ (t(A) * t(W)[:, None])
    AtWb = (t(A) * t(W)[:, None]).T @ t(b)
    ours = regparam.gcv_objective(a_log, AtWA, AtWb, t(R), t(A), t(b), t(W),
                                  t(mask))
    assert ours.shape == ()
    assert np.isclose(float(ours), want, rtol=1e-9)
    assert np.isclose(float(ours), _brute_force_gcv(A, b, W, R, a_log),
                      rtol=1e-9)


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_gcv_reg_param(gcv_problem, mode):
    """The single-record GCV search against the JAX package's in each
    mode (masked points included), to the Nelder-Mead xatol."""
    A, b, W, R = gcv_problem
    R = GCV_SCALE * R
    b = b.copy()
    b[[3, 40]] = np.nan
    mask = np.isfinite(b)
    Wm = np.where(mask, W, 0.0)
    stats = jsuff_stats(*(jnp.asarray(x) for x in (A, b, W, mask * 1.0)))
    want = float(jregparam.gcv_reg_param(
        stats[0], stats[1], jnp.asarray(R), jnp.asarray(A), jnp.asarray(b),
        jnp.asarray(Wm), jnp.asarray(mask * 1.0), regparam_mode=mode))
    AtWA, AtWb, _, _ = fit.record_stats(b, W ** -0.5, A, device="cpu")
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    ours = regparam.gcv_reg_param(AtWA, AtWb, t(R), t(A), t(b), t(Wm),
                                  torch.as_tensor(mask), regparam_mode=mode)
    assert np.isfinite(want) and abs(float(ours) - want) < 5e-4


def test_record_stats(gcv_problem):
    A, b, W, R = gcv_problem
    b = b.copy()
    b[[3, 40]] = np.nan
    err = W ** -0.5
    want = [np.asarray(q) for q in jfit.record_stats(
        jnp.asarray(b), jnp.asarray(err), jnp.asarray(A))]
    ours = fit.record_stats(b, err, A, device="cpu")
    assert [tuple(q.shape) for q in ours] == [(8, 8), (8,), (), ()]
    for o, w in zip(ours, want):
        np.testing.assert_allclose(o.numpy(), w, rtol=1e-12,
                                   atol=1e-13 * np.abs(w).max())
    assert float(ours[3]) == 58.0


@pytest.mark.parametrize("method", ["chi2", "gcv", "manual"])
def test_fit_one_record(gcv_problem, method):
    """One record (two points masked) through the port's fit_records and
    the JAX package's: coefficients, covariance, chi^2, alpha."""
    A, b, W, R = gcv_problem
    b = b.copy()
    b[[3, 40]] = np.nan
    err = W ** -0.5
    R = GCV_SCALE * R[None]
    manual = [1e-18] if method == "manual" else None
    C, dC, chi2, rp = fit.fit_one_record(b, err, A, R, method,
                                         manual_params=manual, device="cpu")
    jC, jdC, jchi2, jrp = (np.asarray(q) for q in jfit.fit_one_record(
        b, err, A, R, method, manual_params=manual))
    jdC = jfit.cov_to_f64(jdC[None])[0]
    assert C.shape == (8,) and dC.shape == (8, 8) and rp.shape == (1,)
    assert abs(np.log10(float(rp[0])) - np.log10(float(jrp[0]))) < 1e-9
    np.testing.assert_allclose(C.numpy(), jC, rtol=1e-9,
                               atol=1e-12 * np.abs(jC).max())
    np.testing.assert_allclose(dC.numpy(), jdC, rtol=1e-8,
                               atol=1e-11 * np.abs(jdC).max())
    assert np.isclose(float(chi2), float(jchi2), rtol=1e-9)


# ---------------------------------------------------------------------------
# Model helpers, tables, the device design path
# ---------------------------------------------------------------------------

def _models(text, impl="table"):
    text = text + f"\n[TPU]\nQUAD_MODE = gauss\nBASIS_IMPL = {impl}\n"
    return Model(Config.from_text(text)), JModel(JConfig.from_text(text))


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(7)
    return (rng.uniform(74, 82, (4, 50)), rng.uniform(252, 272, (4, 50)),
            rng.uniform(1e5, 6e5, (4, 50)))


def test_basis_numbers_and_nu(small_config_text):
    tm, jm = _models(small_config_text)
    n = np.arange(tm.nbasis)
    for a, b in zip(tm.basis_numbers(n), jm.basis_numbers(n)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tm.nu(n), jm.nu(n))
    # scipy's log-gamma here, jax.scipy's there
    assert np.isclose(tm.Kvm(22.25, -2), float(jm.Kvm(22.25, -2)),
                      rtol=1e-12, atol=0)


@pytest.mark.parametrize("m", [0, 2, -2])
def test_az_daz(small_config_text, m):
    import scipy.special as sp

    tm, jm = _models(small_config_text)
    phi = np.linspace(0, 2 * np.pi, 17)
    v = 22.25
    kv = np.sqrt((2 * v + 1) / (4 * np.pi) * sp.gamma(v - abs(m) + 1)
                 / sp.gamma(v + abs(m) + 1)) * (np.sqrt(2) if m else 1.0)
    ref = kv * (np.sin(abs(m) * phi) if m < 0 else np.cos(abs(m) * phi))
    dref = (abs(m) * kv * np.cos(abs(m) * phi) if m < 0
            else -m * kv * np.sin(abs(m) * phi))
    for ours, want in [(tm.Az(v, m, phi), ref), (tm.dAz(v, m, phi), dref),
                       (tm.Az(v, m, phi), np.asarray(jm.Az(v, m, phi))),
                       (tm.dAz(v, m, phi), np.asarray(jm.dAz(v, m, phi)))]:
        assert ours.dtype == torch.float64
        np.testing.assert_allclose(ours.numpy(), want, rtol=1e-10,
                                   atol=1e-12)


def test_tables_torch_evaluation(small_config_text):
    tm, jm = _models(small_config_text)
    tt, jt = tm.tables, jm.tables
    theta = np.linspace(0.0, tt.theta_max, 301)
    u = tt.theta_to_u(theta)
    np.testing.assert_array_equal(u, np.asarray(jt.theta_to_u(theta)))
    # u beyond [-1, 1] is clipped, as in the JAX version
    uu = np.concatenate([u, [-1.5, 1.5]])
    ours = tables.cheb_clenshaw(torch.as_tensor(uu), tt.coef_np)
    want = np.asarray(jtables.cheb_clenshaw(jnp.asarray(uu),
                                            jnp.asarray(jt.coef_np)))
    assert _col_err(ours, want) < 1e-13
    np.testing.assert_allclose(ours.numpy(),
                               tables.np_cheb_clenshaw(uu, tt.coef_np),
                               rtol=0, atol=1e-13 * np.abs(want).max())
    ev = tt.eval_all(torch.as_tensor(theta))
    assert ev.shape == (301, 3 * tt.npairs) and ev.dtype == torch.float64
    assert _col_err(ev, np.asarray(jt.eval_all(theta))) < 1e-13
    for l, mbar, shift in [(0, 0, 0), (2, 1, -1), (2, 2, 1)]:
        assert tt.pair_index(l, mbar) == jt.pair_index(l, mbar)
        assert tt.column(l, mbar, shift) == jt.column(l, mbar, shift)


@pytest.mark.parametrize("impl", ["table", "series"])
def test_design_from_ztp(small_config_text, points, impl):
    """design_from_ztp at the same cap coordinates: the JAX package's and
    the port's host route (_design_np), within 1e-12 of each column's
    sup."""
    tm, jm = _models(small_config_text, impl)
    z, t, p = tm.transform_coord(*(a.ravel() for a in points))
    A = tm.design_from_ztp(torch.as_tensor(z), torch.as_tensor(t),
                           torch.as_tensor(p))
    assert A.dtype == torch.float64 and A.shape == (200, tm.nbasis)
    assert _col_err(A, np.asarray(jm.design_from_ztp(z, t, p))) < 1e-12
    assert _col_err(A, tm._design_np(z, t, p)) < 1e-12


def test_cap_transform_on_tensors(small_config_text, points):
    """The device route's cap coordinates against the host float64
    transform: theta and phi within 1e-14 rad, z within 1e-13."""
    tm, _ = _models(small_config_text)
    z, t, p = tm._coords_t(*(torch.as_tensor(a) for a in points))
    zh, th, ph = tm.transform_coord(*(a.ravel() for a in points))
    assert np.abs(z.numpy() - zh).max() < 1e-13
    assert np.abs(t.numpy() - th).max() < 1e-14
    assert np.abs(p.numpy() - ph).max() < 1e-14


@pytest.mark.parametrize("impl", ["table", "series"])
def test_tensor_basis_routes(small_config_text, points, impl):
    """basis / grad_basis of tensor points: tensors of the input shape,
    against the JAX package's design_from_ztp and the port's host route
    within 1e-12 of each column's sup.  The series' Legendre sum cancels
    ~1e8-fold at these colatitudes (the table path exists for that,
    special.py), so one ulp of theta moves it by ~1e-9: in series mode the
    tensor route is held at its own cap coordinates (themselves held to
    1e-14 rad above), and the end-to-end route at the series' bar,
    1e-5 of the table basis' sup (tests/test_model_sphharmlag.py)."""
    tm, jm = _models(small_config_text, impl)
    pts_t = tuple(torch.as_tensor(a) for a in points)
    A = tm.basis(*pts_t)
    G = tm.grad_basis(*pts_t)
    assert A.shape == (4, 50, tm.nbasis) and G.shape == (4, 50, 3, tm.nbasis)
    assert A.dtype == G.dtype == torch.float64
    A, G = A.reshape(200, -1), G.reshape(200, 3, -1)
    flat = tuple(a.ravel() for a in points)
    Ah, Gh = tm.basis(*flat), tm.grad_basis(*flat)
    assert _col_err(G, Gh) < 1e-12  # always the tables
    assert _col_err(G, np.asarray(jm.grad_basis(*flat))) < 1e-12
    if impl == "table":
        assert _col_err(A, Ah) < 1e-12
        assert _col_err(A, np.asarray(jm.basis(*flat))) < 1e-12
        return
    z, t, p = (x.numpy() for x in tm._coords_t(*pts_t))
    assert _col_err(A, tm._design_np(z, t, p)) < 1e-12
    assert _col_err(A, np.asarray(jm.design_from_ztp(z, t, p))) < 1e-12
    table = _models(small_config_text)[0].basis(*flat)
    assert np.max(np.abs(A.numpy() - Ah)) < 1e-5 * np.max(np.abs(table))


def test_grad_core_matches_finite_differences(small_config_text):
    """The device gradient against central differences of the port's
    design_from_ztp in cap coordinates (tests/test_model_sphharmlag.py:
    64-94)."""
    from volumetricinterp_tpu_torch.constants import RE

    tm, _ = _models(small_config_text)
    pts = (torch.tensor([78.5, 77.0, 79.0], dtype=torch.float64),
           torch.tensor([261.0, 263.0, 265.0], dtype=torch.float64),
           torch.tensor([3e5, 2.5e5, 4e5], dtype=torch.float64))
    G = tm.grad_basis(*pts).numpy()
    assert G.shape == (3, 3, tm.nbasis)
    z, t, p = tm._coords_t(*pts)
    r = ((z / 100.0 + 1.0) * RE)[:, None]

    def design(z_, t_, p_):
        return tm.design_from_ztp(z_, t_, p_)

    hz, ht, hp = 1e-6, 1e-8, 1e-8
    dz = (design(z + hz, t, p) - design(z - hz, t, p)) / (2 * hz) * 100.0 / RE
    dt = (design(z, t + ht, p) - design(z, t - ht, p)) / (2 * ht) / r
    dp = (design(z, t, p + hp) - design(z, t, p - hp)) / (2 * hp) / (
        r * torch.sin(t)[:, None])
    for comp, ref in [(0, dz), (1, dt), (2, dp)]:
        ref = ref.numpy()
        err = np.max(np.abs(G[:, comp, :] - ref)) / np.max(np.abs(ref))
        assert err < 1e-4, (comp, err)


def test_design_from_ecef(points):
    text = "[MODEL]\nNAME = radbasfun\nNUMGRIDPNT = 4\n"
    tm, jm = RBF(Config.from_text(text)), JRBF(JConfig.from_text(text))
    flat = tuple(a.ravel() for a in points)
    R = np.stack(tm.transform_coords(*flat), axis=-1)
    A = tm.design_from_ecef(torch.as_tensor(R))
    assert A.dtype == torch.float64 and A.shape == (200, 64)
    assert _col_err(A, np.asarray(jm.design_from_ecef(jnp.asarray(R)))) < 1e-12
    pts_t = tuple(torch.as_tensor(a) for a in points)
    At, Gt = tm.basis(*pts_t), tm.grad_basis(*pts_t)
    assert At.shape == (4, 50, 64) and Gt.shape == (4, 50, 3, 64)
    # ||R||^2 - 2 R.c + ||c||^2 cancels ~4e13 m^2 down to the exponent's
    # EPS^2 = 1e10 m^2 scale: one ulp there is ~1e-12 of a column, so the
    # two routes' orders of summation differ at that level
    assert _col_err(At.reshape(200, -1), tm.basis(*flat)) < 1e-11
    assert _col_err(Gt.reshape(200, 3, -1), tm.grad_basis(*flat)) < 1e-11


def test_get_model_module():
    from volumetricinterp_tpu_torch import models
    from volumetricinterp_tpu_torch.models import radbasfun, sphharmlag

    assert models.get_model_module("sphharmlag") is sphharmlag
    assert models.get_model_module("radbasfun") is radbasfun
    with pytest.raises(ValueError):
        models.get_model_module("nosuchmodel")


# ---------------------------------------------------------------------------
# the device hull test
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fov():
    """A beam-cone-like hull (a fan of rays from the radar at 100-600 km)
    and 60 points over its box, some inside, some outside."""
    rng = np.random.default_rng(4)
    nbeam = 11
    az = np.linspace(0.0, 2 * np.pi, nbeam, endpoint=False)
    el = np.radians(np.r_[90.0, np.full(nbeam - 1, 65.0)])
    rng_km = np.linspace(100.0, 600.0, 6)
    lat = 74.73 + np.outer(np.cos(az) / np.tan(el), rng_km) / 111.0
    lon = 265.09 + np.outer(np.sin(az) / np.tan(el), rng_km) / 30.0
    alt = np.outer(np.ones(nbeam), rng_km) * 1e3
    vert = hull.compute_hull_vertices(lat.ravel(), lon.ravel(), alt.ravel())
    q = (rng.uniform(lat.min() - 1, lat.max() + 1, (6, 10)),
         rng.uniform(lon.min() - 3, lon.max() + 3, (6, 10)),
         rng.uniform(5e4, 6.5e5, (6, 10)))
    return vert, q


@pytest.mark.parametrize("chunk", [None, 7])
def test_check_hull(fov, chunk):
    vert, q = fov
    eqs = hull.hull_equations(vert)
    mask = hull.check_hull(eqs, *q, device="cpu", chunk=chunk)
    assert mask.dtype == torch.bool and mask.shape == (6, 10)
    mask = mask.numpy()
    assert 5 < mask.sum() < 55
    np.testing.assert_array_equal(mask, np.asarray(jhull.check_hull(eqs, *q)))
    np.testing.assert_array_equal(mask, hull.np_check_hull(eqs, *q))
    np.testing.assert_array_equal(mask, hull.check_hull_reference(vert, *q))
    np.testing.assert_array_equal(mask,
                                  jhull.check_hull_reference(vert, *q))


def test_estimate_check_hull(fov, small_config_text):
    vert, q = fov

    class MemEstimate(Estimate):
        def loadh5(self, filename=None):
            self.Coeffs = np.zeros((1, 18))
            self.Covariance = np.zeros((1, 18, 18))
            self.time = np.array([[0.0, 60.0]])
            self.hull_vert = vert
            self.config_file_text = small_config_text
            self.chi2, self.raw_filename, self.timefit = None, None, None

    est = MemEstimate(None, device="cpu")
    mask = est.check_hull(*q)
    assert isinstance(mask, np.ndarray) and mask.dtype == bool
    np.testing.assert_array_equal(
        mask, hull.check_hull_reference(vert, *q))
    np.testing.assert_array_equal(
        mask, np.asarray(jhull.check_hull(jhull.hull_equations(vert), *q)))
