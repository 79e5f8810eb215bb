"""The frozen metric arithmetic on hand-made profiler intervals, and each
per-layer reader on a hand-made run."""

import pytest

from portbench import harness
from portbench.metrics import kernel_work, trace_math


def test_union_merges_overlaps_and_keeps_gaps():
    busy, merged = trace_math.union([(5, 8), (0, 2), (1, 3), (8, 9), (12, 13)])
    assert busy == 3 + 4 + 1
    assert merged == [[0, 3], [5, 9], [12, 13]]
    assert trace_math.gaps(merged) == [(3, 5), (9, 12)]


def test_summarize_labels_gaps_by_the_innermost_phase():
    events = [("fit_records", False, 0, 100), ("copy_to_host", False, 60, 90),
              ("k1", True, 0, 20), ("k1", True, 30, 50), ("k2", True, 95, 99),
              ("fit_records", True, 0, 100)]  # a device-side annotation
    names = {"fit_records", "copy_to_host"}
    # the harness drops device-side annotations before summarize
    s = trace_math.summarize([e for e in events if not (e[1] and e[0] in names)],
                             1e-4, names)
    assert s["busy_s"] == pytest.approx(44e-6)
    assert s["ops"] == {"k1": pytest.approx(40e-6), "k2": pytest.approx(4e-6)}
    assert s["idle"] == [("fit_records", pytest.approx(10e-6)),
                         ("copy_to_host", pytest.approx(45e-6))]
    both = trace_math.merge(s, s)
    assert both["busy_s"] == pytest.approx(88e-6)
    bd = trace_math.breakdown(both)
    assert bd["device_ops"][0] == ["k1", pytest.approx(80e-6)]
    assert bd["idle_gaps"][0][0] == "copy_to_host"
    assert len(bd["idle_gaps"]) == 4


def test_label_outside_every_phase():
    assert trace_math.label(5, [("a", 0, 1)]) == "outside_phases"


def test_kernel_work_counts_from_sizes():
    flop, nbytes = kernel_work.grid_eval_work(npts=1000, live=300, nrec=8,
                                              nbasis=144)
    assert flop == 300 * 144 + 2 * 300 * 8 * 144
    assert nbytes == 1000 * 13 + 8 * 144 * 4 + 1000 * 8 * 4
    assert kernel_work.bound_s(67e12, 0) == pytest.approx(1.0)
    assert kernel_work.bound_s(0, 3.35e12) == pytest.approx(1.0)


class Drv:
    npts, live_points, nrec = 33554432, 9425000, 8


def run(op, **kw):
    base = {"traffic": {"op": op, "trace_calls": 3},
            "config": {"MODEL": {"MAXK": 4, "MAXL": 6}}, "ops": 10,
            "phases": {}, "counts": {}, "trace": None, "runner": Drv()}
    base.update(kw)
    return base


def test_fit_readers():
    r = run("fit", phases={"read_datafile": 1.0, "design_matrix": 1.0,
                           "fit_records": 50.0},
            counts={"host_eigh_matrices": 41, "host_eigh_seconds": 2.0},
            trace={"busy_s": 1.0, "window_s": 4.0, "ops": {}, "idle": []})
    read = harness.load_reader
    assert read("interpolate.host_prep_s_per_record")(r) == 0.2
    assert read("fit.host_eighs_per_record")(r) == 4.1
    assert read("fit.host_eigh_s_per_record")(r) == 0.2
    assert read("device.idle_share.fit")(r) == 0.75
    assert read("device.idle_share.product")(r) is None
    assert read("grid_eval_roofline")(r) is None


def test_product_readers():
    t = 3 * 2e-3
    r = run("product", phases={"grid_hash": 6.0, "grid_eval": 9.0},
            trace={"busy_s": 0.5, "window_s": 5.0, "idle": [],
                   "ops": {"(anonymous namespace)::grid_eval_kernel(Args)": t,
                           "Memcpy DtoH": 1.0}})
    read = harness.load_reader
    assert read("estimate.grid_hash_s_per_request")(r) == 0.6
    assert read("estimate.grid_eval_s_per_request")(r) == 0.9
    assert read("device.idle_share.product")(r) == pytest.approx(0.9)
    flop, nbytes = kernel_work.grid_eval_work(Drv.npts, Drv.live_points, 8,
                                              144)
    want = 100 * 3 * kernel_work.bound_s(flop, nbytes) / t
    assert read("grid_eval_roofline")(r) == pytest.approx(want)
    assert read("fit.host_eighs_per_record")(r) is None


def test_a_reader_that_finds_nothing_returns_nothing():
    r = run("product", trace={"busy_s": 0.0, "window_s": 5.0, "idle": [],
                              "ops": {}})
    assert harness.load_reader("grid_eval_roofline")(r) is None
    assert harness.load_reader("device.idle_share.product")(r) is None
