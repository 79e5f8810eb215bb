"""PyTorch port at BASELINE config 3 (lmax=10 x 12 radial, nbasis 1200)
in the two regularization methods beside chi2: GCV on a record of the
day's last chunk and REGULARIZATION_METHOD = manual on the day's first
records, against the JAX package's CPU float64 fits of the same bytes
(scripts/window_oracle.py highorder_gcv_tail and highorder_manual, stored
under tests/oracle).  The fixtures and the bars' helper are
tests/test_torch_highorder.py's."""

import numpy as np

from volumetricinterp_tpu_torch.ops.fit import fit_records
from volumetricinterp_tpu_torch.ops.regparam import manual_reg_param

from tests.test_torch_highorder import ORACLE, _held, _pair, day  # noqa: F401

GCV_TAIL = 968  # the first record of the highorder_gcv_tail oracle


def test_gcv_tail_fit_matches_jax(day):
    """REGULARIZATION_METHOD = gcv in its exact mode on record 968, the
    first of the JAX package's GCV fit of records 968-999
    (highorder_gcv_tail: the day's last chunk, 104 records that the card
    pads to 128), held to test_gcv_fit_matches_jax's bars: the NaN set,
    no negative chi2, chi2 within 2e-2 relative and the W-weighted field
    within 1e-2 (measured 1.9e-4 and 6.2e-5, the minima 2.5e-3 decades
    apart).  One record: each Nelder-Mead evaluation inverts ten kept
    blocks of 1200 x 1200 a record (~20 s on 8 idle cores)."""
    o = np.load(ORACLE / "day1000_seed1_timeaxis.npz")
    values = o["value"][GCV_TAIL:GCV_TAIL + 1]
    errors = o["error"][GCV_TAIL:GCV_TAIL + 1]
    assert np.isfinite(values).any()
    _, tm = _pair()
    A = tm.basis(day["lat"], day["lon"], day["alt"])
    C, _, chi2, rp = (x.numpy() for x in fit_records(
        values, errors, A, tm.eval_psi()[None], method="gcv",
        regparam_mode="exact", device="cpu"))
    _held(C, chi2, rp, "gcv_tail", A, values, errors, 2e-2, 1e-2,
          start=GCV_TAIL)


def test_manual_fit_matches_jax(day):
    """REGULARIZATION_METHOD = manual (alpha MANUAL_PARAMS['0thorder'] =
    1e-23 for every record) on the day's first four records against the
    JAX package's manual fit of its first 128 (highorder_manual): the NaN
    set, no negative chi2, chi2 within 2e-2 relative and the W-weighted
    field within 1e-2, the fast fit's bars (measured 2.1e-5 and 4.7e-5
    at most: the same alpha, the final solve's cutoff the only freedom),
    and the alpha itself the config's within 1e-12."""
    alpha = manual_reg_param("0thorder")
    assert alpha == 1e-23
    _, tm = _pair()
    A = tm.basis(day["lat"], day["lon"], day["alt"])
    C, _, chi2, rp = (x.numpy() for x in fit_records(
        day["values"], day["errors"], A, tm.eval_psi()[None],
        method="manual", manual_params=[alpha], regparam_mode="exact",
        device="cpu"))
    dla = _held(C, chi2, rp, "manual", A, day["values"], day["errors"],
                2e-2, 1e-2)
    assert len(dla) == 4 and dla.max() <= 1e-12
    np.testing.assert_allclose(rp[:, 0], alpha, rtol=1e-12, atol=0.0)
