"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files found by name, and which cells report which metrics."""

import json
import re

import pytest

from portbench import harness
from portbench.run import cell_metrics

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}
CELLS = [w["name"] for w in BENCH["workloads"]]


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"][0] == "python3" and len(BENCH["command"]) <= 32
    assert all(one_line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (harness.REPO / p).is_dir()
    for kind, entries in (("config", BENCH["configs"]),
                          ("workload", BENCH["workloads"]),
                          ("end_to_end", BENCH["end_to_end"]),
                          ("per_layer", BENCH["per_layer"])):
        for e in entries:
            assert set(e) <= KEYS[kind], e
            assert set(e) >= KEYS[kind] - {"workloads"}, e


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(set(names)) == len(names)
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert one_line(e[key]), e[key]


def test_configs_are_files_under_paths():
    files = set()
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((harness.REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_cells_find_their_files():
    pairs = set()
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        _, cfg, traffic, limits = harness.cell_files(w["name"])
        assert callable(harness.operation(traffic["op"]))
        assert limits["compared"]
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])


def test_run_seconds_fit_a_full_check():
    """2 + 14 x 24 runs of run_seconds + 60 s, 180 s of compiling a cell,
    1200 s spare: within 43200 s with the full 24 cells."""
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_it_must(cell):
    e2e, per_layer = cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert per_layer
    for m in per_layer:
        assert m["moves"] in names, (m["name"], cell)


def test_per_layer_metrics_have_readers_and_move_one_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert callable(harness.load_reader(m["name"]))
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        for w in m.get("workloads", []):
            assert w in CELLS
    if "grid_eval_roofline" in {m["name"] for m in BENCH["per_layer"]}:
        roof = [m for m in BENCH["per_layer"]
                if m["name"].endswith("_roofline")]
        assert all(m["unit"] == "%" for m in roof)
