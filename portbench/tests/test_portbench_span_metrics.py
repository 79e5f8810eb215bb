"""The readers of the program's spans (portbench/metrics/fit.*_s_per_record
and estimate.grid_*_s_per_request that read ``program_span``s new with the
spans inside Interpolate's chunk pipeline and Estimate's grid_eval): on a
tiny CPU window of each cell, each reads a finite value in the cells the
manifest lists it for and nothing in the others."""

import math

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import tiny

SEED = 2**31 + 101
CELLS = ["l6k4.day_fit", "l10k12.window_fit", "l6k4.volume"]
SPAN_METRICS = ["fit.prepare_s_per_record", "fit.lookahead_wait_s_per_record",
                "fit.search_solve_s_per_record",
                "fit.device_wait_s_per_record",
                "estimate.grid_to_host_s_per_request",
                "estimate.grid_store_s_per_request"]


def window(cell):
    """The run a reader takes (its traffic, phases and operations) of a
    warm-up call and one timed call of the tiny cell; no check."""
    cfg, traffic, _ = tiny(cell)
    drv = harness.operation(traffic["op"])(cfg, traffic, torch.device("cpu"))
    drv.load(SEED)
    drv.call(0, keep=False)
    phases0 = harness.phase_totals(drv.timers())
    ops = drv.call(1)
    phases = {k: v - phases0.get(k, 0.0)
              for k, v in harness.phase_totals(drv.timers()).items()}
    return {"workload": cell, "config": cfg, "traffic": traffic, "ops": ops,
            "phases": phases, "trace": None, "runner": drv}


@pytest.fixture(scope="module")
def runs():
    return {cell: window(cell) for cell in CELLS}


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_span_reader_reads_its_own_cells(name, runs):
    entry = {m["name"]: m for m in harness.manifest()["per_layer"]}[name]
    assert entry["source"] == "program_span"
    read = harness.load_reader(name)
    for cell in CELLS:
        v = read(runs[cell])
        if cell in entry["workloads"]:
            assert v is not None and math.isfinite(v) and v >= 0.0, cell
        else:
            assert v is None, cell


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_program_without_the_span_reads_nothing(name, runs):
    """The parent of these spans has none of them: its readers give
    nothing and raise nothing."""
    read = harness.load_reader(name)
    for run in runs.values():
        bare = dict(run, phases={k: v for k, v in run["phases"].items()
                                 if k in ("fit_records", "copy_to_host",
                                          "grid_hash", "grid_eval")})
        assert read(bare) is None
