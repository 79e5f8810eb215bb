"""The operations found by name: each refuses a configuration its
reference does not model, the fit's every-record numbers catch a fault in
any record of the window without a reference search, and the window holds
at least the mix's ``min_calls`` calls."""

import copy

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.operations import fit as op_fit
from portbench.tests.test_portbench_cpu_run import SEED, fit_fault
from portbench.tests.tiny import tiny
from volumetricinterp_tpu_torch import interpolate

UNMODELLED = [("DEFAULT", "REGULARIZATION_METHOD", "gcv"),
              ("DEFAULT", "REGULARIZATION_LIST", "curvature"),
              ("MODEL", "NAME", "radbasfun"),
              ("TPU", "REGPARAM_MODE", "fast"),
              ("DEFAULT", "TIME_COUPLING", "1")]


@pytest.mark.parametrize("sec,key,value", UNMODELLED)
@pytest.mark.parametrize("cell", ["l6k4.day_fit", "l6k4.volume"])
def test_an_unmodelled_configuration_is_refused(cell, sec, key, value):
    _, cfg, traffic, _ = harness.cell_files(cell)
    cfg = copy.deepcopy(cfg)
    cfg[sec][key] = value
    Runner = harness.operation(traffic["op"])
    fit_only = key in ("REGULARIZATION_METHOD", "REGULARIZATION_LIST",
                       "REGPARAM_MODE")
    if traffic["op"] == "product" and fit_only:
        return  # the product's reference reads no fit key
    with pytest.raises(ValueError, match=key):
        Runner(cfg, traffic, torch.device("cpu"))


def test_an_unknown_operation_is_refused():
    with pytest.raises(ValueError, match="no operation"):
        harness.operation("keogram")
    with pytest.raises(ValueError, match="no operation"):
        harness.operation("../harness")


def window_numbers(kind, monkeypatch):
    cfg, traffic, limits = tiny("l10k12.window_fit")
    if kind:
        monkeypatch.setattr(interpolate.Interpolate, "_run_fit_pipeline",
                            fit_fault(kind))
    drv = op_fit.Runner(cfg, traffic, torch.device("cpu"))
    drv.load(SEED)
    drv.call(0, keep=False)
    drv.call(1)
    drv.call(2)
    return drv.check(np.random.default_rng(3), 0), limits["compared"]


@pytest.mark.parametrize("kind", [None, "altered", "half", "half_nan",
                                  "stale"])
def test_every_record_numbers_catch_a_fault_without_samples(kind,
                                                            monkeypatch):
    got, lim = window_numbers(kind, monkeypatch)
    assert set(got) == {"window_no_fit_mismatch", "window_chi2_self_gap_max"}
    over = [k for k in lim if k in got and got[k] > lim[k]["limit"]]
    assert bool(over) == (kind is not None), (got, over)


def test_the_window_holds_min_calls():
    cfg, traffic, limits = tiny("l6k4.day_fit")
    traffic = dict(traffic, min_calls=3)
    res = harness.run_cell("l6k4.day_fit", cfg, traffic, limits, SEED, 0.0,
                           False, "cpu", log=lambda *a, **k: None)
    assert res["attempted"] == 3 * traffic["records_per_call"]
    assert res["correct"], res["checks"]
