"""Whole runs of each cell on the CPU at a size the tests can hold: the
program against the reference (correct), the control in the program's
place (not correct), the run with each fault the cell can have planted in
the timed path (not correct), and the command's refusal without a card."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests.tiny import tiny
from volumetricinterp_tpu_torch import estimate, interpolate

SEED = 2**31 + 101
CELLS = ["l6k4.day_fit", "l10k12.window_fit", "l6k4.volume"]


def run(cell, trace=False):
    cfg, traffic, limits = tiny(cell)
    return harness.run_cell(cell, cfg, traffic, limits, SEED, 0.5, trace,
                            "cpu", log=lambda *a, **k: None)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["device"]["platform"] == "cpu"
    assert set(res["metrics"]) == {
        "setup_s", "product_point_records_per_s" if "volume" in cell
        else "fit_records_per_s"}


@pytest.mark.parametrize("cell", ["l6k4.day_fit", "l6k4.volume"])
def test_the_traced_run_reads_its_layers(cell):
    from portbench.run import cell_metrics

    cfg, traffic, limits = tiny(cell)
    _, per_layer = cell_metrics(harness.manifest(), cell)
    res = harness.run_cell(cell, cfg, traffic, limits, SEED, 0.2, True,
                           "cpu", per_layer=per_layer,
                           log=lambda *a, **k: None)
    assert res["correct"]
    # the CPU has no device trace: only the host's spans and counters read
    host = {m["name"] for m in per_layer if m["source"] != "device_trace"}
    assert set(res["metrics"]) == host
    assert res["device"]["busy_s"] == 0.0 and "breakdown" in res


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """At the shipped order for every cell: the float32 search at nbasis
    1200 takes minutes on a CPU, so the control at that order is read on
    the card only."""
    cfg, traffic, limits = tiny(cell, order=(4, 6))
    drv = harness.operation(traffic["op"])(cfg, traffic, torch.device("cpu"))
    drv.load(SEED)
    drv.call(0, keep=False)
    drv.call(1)
    got = drv.check(np.random.default_rng(3), int(traffic["check_samples"]),
                    control=True)
    assert any(got[k] > lim["limit"] for k, lim in limits["compared"].items())


def stale(cls, name):
    """The patched method returns its first result ever after: a step that
    leaves its state unchanged."""
    orig = getattr(cls, name)
    first = {}

    def patched(self, *a, **k):
        if "r" not in first:
            first["r"] = orig(self, *a, **k)
        return first["r"]
    return patched


def fit_fault(kind):
    orig = interpolate.Interpolate._run_fit_pipeline

    def patched(self, value, *a, **k):
        C, dC, c2, rp = orig(self, value, *a, **k)
        if kind == "altered":
            C = 2.0 * C
        elif kind == "half":
            h = len(C) // 2
            C[h:], c2[h:] = 0.0, 0.0
        elif kind == "half_nan":
            h = len(C) // 2
            C[h:], c2[h:] = np.nan, np.nan
        return C, dC, c2, rp
    if kind == "stale":
        return stale(interpolate.Interpolate, "_run_fit_pipeline")
    return patched


def product_fault(kind):
    orig = estimate.Estimate.evaluate_records

    def patched(self, times, *a, **k):
        out = orig(self, times, *a, **k)
        if kind == "altered":
            out *= np.float32(1.01)
        elif kind == "half":
            out[len(out) // 2:] = 0.0
        return out
    if kind == "stale":
        return stale(estimate.Estimate, "evaluate_records")
    return patched


@pytest.mark.parametrize("kind", ["altered", "half", "stale"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_the_timed_path_is_not_correct(cell, kind, monkeypatch):
    if "volume" in cell:
        monkeypatch.setattr(estimate.Estimate, "evaluate_records",
                            product_fault(kind))
    else:
        monkeypatch.setattr(interpolate.Interpolate, "_run_fit_pipeline",
                            fit_fault(kind))
    assert not run(cell)["correct"]


def test_the_command_refuses_without_a_card():
    res = subprocess.run([sys.executable, str(harness.ROOT / "run.py"),
                          "--workload", "l6k4.day_fit", "--seed", "1",
                          "--seconds", "1"], capture_output=True, text=True,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert res.returncode != 0 and res.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run([sys.executable, str(harness.ROOT / "run.py"),
                          "--workload", cell, "--seed", str(SEED),
                          "--seconds", "1"], capture_output=True, text=True,
                         timeout=1200)
    assert res.returncode == 0, res.stderr[-2000:]
    import json

    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
