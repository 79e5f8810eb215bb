"""PyTorch port, the span recorder (utils/logging): the spans inside
Interpolate's chunk pipeline and Estimate's grid_eval phase, the span log
of every thread on the profiler's clock, and the Chrome trace of
utils/profiling.trace that carries it.  CPU only: what is held is which
spans a run reports, on which thread, under which parent, and that their
seconds and stamps agree with the counters and the profiler."""

import datetime as dt
import json
import logging
import sys
import threading
import time
import types

import numpy as np
import pytest

from volumetricinterp_tpu_torch import Estimate, Interpolate
from volumetricinterp_tpu_torch.config import Config
from volumetricinterp_tpu_torch.io.amisr import qc_datasets
from volumetricinterp_tpu_torch.io.synth import synthetic_amisr_datasets
from volumetricinterp_tpu_torch.models.sphharmlag import Model
from volumetricinterp_tpu_torch.ops import solve
from volumetricinterp_tpu_torch.utils import logging as vlog
from volumetricinterp_tpu_torch.utils.profiling import SPAN_PID, trace

NREC, CHUNK = 16, 8  # two chunks: the look-ahead prepares the second
FIT_SPANS = ("prepare_chunk", "lookahead_wait", "search_solve",
             "device_wait", "host_eigh")
GRID_SPANS = ("grid_launch", "grid_to_host", "grid_store")
EPOCH = dt.datetime(1970, 1, 1)


def config_text():
    return f"""
[DEFAULT]
PARAM = dens
FILENAME = in.h5
OUTPUTFILENAME =
REGULARIZATION_LIST = 0thorder
REGULARIZATION_METHOD = chi2
ERRLIM = 1e10,1e13
GOODFITCODE = 1,2,3,4
CHI2LIM = 0.1,10

[MODEL]
NAME = sphharmlag
MAXK = 2
MAXL = 3
CAP_LIM = 10
MAX_Z_INT = INF
LATCP = 78
LONCP = 262

[TPU]
CHUNK_SIZE = {CHUNK}
"""


def spans_in(doc):
    """The span log that utils/profiling.trace wrote into trace.json's
    document, as Span records."""
    base = doc.get("baseTimeNanoseconds", 0)
    out = []
    for e in doc["traceEvents"]:
        if e.get("pid") == SPAN_PID and e.get("ph") == "X":
            start = base + round(e["ts"] * 1e3)
            out.append(vlog.Span(e["name"], e["tid"], e["args"]["parent"],
                                 start, start + round(e["dur"] * 1e3)))
    return out


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """A two-chunk exact fit on the CPU under utils/profiling.trace:
    (interp, the span log read back from trace.json, the profile,
    trace.json's document, the host_eigh_seconds counter's increment)."""
    text = config_text()
    data = synthetic_amisr_datasets(
        nrec=NREC, seed=4, smooth_in_model=Model(Config.from_text(text)))

    class MemInterpolate(Interpolate):
        def read_datafile(self, filename):
            return qc_datasets(data, self.param, self.errlim, self.chi2lim,
                               self.goodfitcode)

    interp = MemInterpolate(text, device="cpu")
    logdir = tmp_path_factory.mktemp("trace")
    s0 = solve.host_eigh_seconds
    with trace(str(logdir)) as prof:
        interp.calc_coeffs()
    ds = solve.host_eigh_seconds - s0
    doc = json.loads((logdir / "trace.json").read_text())
    return interp, spans_in(doc), prof, doc, ds


def test_the_fit_reports_its_spans(fitted):
    interp, spans, *_ = fitted
    rep = interp.timer.report()
    assert set(FIT_SPANS + ("fit_records", "copy_to_host")) <= set(rep)
    assert all(rep[k] >= 0.0 for k in FIT_SPANS)
    # one look-ahead, wait, search and synchronize a chunk
    for name in ("prepare_chunk", "lookahead_wait", "search_solve",
                 "device_wait", "copy_to_host"):
        assert sum(s.name == name for s in spans) == NREC // CHUNK, name
    assert np.isfinite(interp.chi_sq).sum() > NREC // 2


def test_prepare_chunk_runs_on_the_worker_under_fit_records(fitted):
    _, spans, *_ = fitted
    main = threading.main_thread().native_id
    prep = [s for s in spans if s.name == "prepare_chunk"]
    assert prep and all(s.thread != main and s.parent == "fit_records"
                        for s in prep)
    # the worker's eighs are the prepare's, the main thread's the search's
    eighs = {(s.thread == main, s.parent) for s in spans
             if s.name == "host_eigh"}
    assert {(False, "prepare_chunk"), (True, "search_solve")} <= eighs
    for s in spans:
        if s.name in ("lookahead_wait", "search_solve", "device_wait"):
            assert s.thread == main and s.parent == "fit_records", s
        assert s.start_ns <= s.end_ns


def test_host_eigh_span_total_is_its_counter(fitted):
    interp, _, _, _, ds = fitted
    span_s = interp.timer.report()["host_eigh"]
    # the counter keeps its own clock, inside the span around its body
    assert 0.0 < ds <= span_s
    assert span_s == pytest.approx(ds, rel=1e-2)


def test_span_stamps_are_on_the_profilers_clock(fitted):
    _, spans, prof, _, _ = fitted
    main = threading.main_thread().native_id
    events = {}
    for ev in prof.profiler.kineto_results.events():
        events.setdefault(ev.name(), []).append(ev.start_ns())
    for name in ("fit_records", "lookahead_wait", "search_solve"):
        mine = sorted(s.start_ns for s in spans
                      if s.name == name and s.thread == main)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs) > 0, name
        assert max(abs(a - b) for a, b in zip(mine, theirs)) < 1_000_000


def test_the_trace_holds_every_threads_spans(fitted):
    _, spans, _, doc, _ = fitted
    main = threading.main_thread().native_id
    ours = [e for e in doc["traceEvents"]
            if e.get("pid") == SPAN_PID and e.get("ph") == "X"]
    rows = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
            if e.get("pid") == SPAN_PID and e.get("name") == "thread_name"}
    assert set(rows) == {s.thread for s in spans} and len(rows) >= 2
    assert rows[main] == "main thread"
    prep = [e for e in ours if e["name"] == "prepare_chunk"]
    assert len(prep) == NREC // CHUNK
    assert all(e["tid"] != main and e["args"]["parent"] == "fit_records"
               for e in prep)
    # on the trace's own time base: the span row's fit_records starts
    # where the profiler's does
    prof_fit = [e for e in doc["traceEvents"]
                if e.get("name") == "fit_records" and e.get("pid") != SPAN_PID
                and e.get("ph") == "X"]
    span_fit = [e for e in ours if e["name"] == "fit_records"]
    assert len(prof_fit) == len(span_fit) == 1
    assert abs(prof_fit[0]["ts"] - span_fit[0]["ts"]) < 1000.0  # us
    assert abs(prof_fit[0]["dur"] - span_fit[0]["dur"]) < 1000.0


def test_the_product_reports_its_spans(fitted):
    interp = fitted[0]

    class MemEstimate(Estimate):
        def loadh5(self, filename=None):
            self.Coeffs, self.Covariance = interp.Coeffs, interp.Covariance
            self.time, self.hull_vert = interp.time, interp.hull_vert
            self.config_file_text = config_text()
            self.chi2, self.raw_filename, self.timefit = None, None, None

    est = MemEstimate(None, device="cpu")
    lat, lon, alt = np.meshgrid(np.linspace(74.0, 82.0, 40),
                                np.linspace(252.0, 272.0, 40),
                                np.linspace(1e5, 6e5, 16), indexing="ij")
    times = [EPOCH + dt.timedelta(seconds=float(u))
             for u in interp.time[:4].mean(axis=1)]
    with vlog.span_log() as spans:
        out = est.evaluate_records(times, lat, lon, alt)
    assert out.shape == (4,) + lat.shape and np.isfinite(out).any()
    rep = est.timer.report()
    assert set(GRID_SPANS) <= set(rep)
    assert sum(rep[k] for k in GRID_SPANS) >= 0.95 * rep["grid_eval"]
    assert {s.parent for s in spans if s.name in GRID_SPANS} == {"grid_eval"}


def test_timer_totals_stay_exact_under_threads(monkeypatch):
    """Threads, more than the cores, time spans into one timer.  Each span
    reads a clock of its own thread that steps 1 s a read, so every span
    lasts exactly 1 s: a lost update of the totals shows."""
    clock = threading.local()

    def perf_counter():
        clock.t = getattr(clock, "t", 0.0) + 1.0
        return clock.t

    monkeypatch.setattr(vlog, "time", types.SimpleNamespace(
        perf_counter=perf_counter, time_ns=time.time_ns))
    timer, n, nthreads = vlog.PhaseTimer(), 4000, 16

    def work():
        with timer.phase("outer"):
            for _ in range(n):
                with vlog.span("inner"):
                    pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=vlog.carry(work))
                   for _ in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    assert timer.report()["inner"] == float(nthreads * n)
    # each outer phase read the clock at its ends around n inner spans
    assert timer.report()["outer"] == float(nthreads * (2 * n + 1))


def test_a_span_without_a_timer_is_only_a_range():
    with vlog.span_log() as spans:
        with vlog.span("alone") as sp:
            pass
    assert spans == [] and sp.seconds >= 0.0


def test_only_the_outermost_phase_logs(caplog):
    timer = vlog.PhaseTimer()
    with caplog.at_level(logging.INFO, logger=vlog.logger.name):
        with timer.phase("outer"):
            with timer.phase("inner"), vlog.span("leaf"):
                pass
    said = [r.getMessage().split()[1] for r in caplog.records
            if r.getMessage().startswith("phase ")]
    assert said == ["outer"]
    assert set(timer.report()) == {"outer", "inner", "leaf"}


def test_one_span_log_at_a_time():
    with vlog.span_log():
        with pytest.raises(RuntimeError):
            with vlog.span_log():
                pass
    with vlog.span_log() as spans:  # the first one's exit turned it off
        with vlog.PhaseTimer().phase("p"):
            pass
    assert [s.name for s in spans] == ["p"]
