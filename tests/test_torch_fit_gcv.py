"""PyTorch port, GCV: fit_records with method='gcv' in 'exact' and 'fast'
mode against the JAX package's fit_records on the same records, and the
batched Nelder-Mead against the JAX one on a quadratic; CPU float64."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from volumetricinterp_tpu.ops import regparam as jregparam

from volumetricinterp_tpu_torch.ops import regparam as tregparam
from volumetricinterp_tpu_torch.ops.fit import fit_records

from test_torch_fit import _check_fit, _jax_fit, make_records
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
