"""The port's span recorder (``utils/tictoc.py``) and the spans the streamed
executor books with it.

- A span books its wall time as ``add`` does, and where asked the thread's
  CPU time beside it; the ring keeps the newest ``RING_RECORDS`` records and
  counts the rest; reads fold the queue while threads append to it; the
  module ``span`` books into the timers bound to its thread and does
  nothing on a thread with none.
- With no profiler session, no profiler range is entered; under one, a
  span's record brackets the profiler's event of its range (same clock),
  the range stays off the device timeline, and with ``profile_all_threads``
  a worker thread's ranges reach the trace. (Sessions run in a process of
  their own: this one has imported jax, whose profiler shares the tracing
  library.)
- A CPU drive of ``run_streamed`` on the benchmark's lo and full
  configurations books ``predict`` / ``register`` / ``chain`` once per
  registration inside ``dispatch``, ``sc_ingest`` / ``sc_query`` once per
  backend event on the worker's thread, every stage it booked before, and
  each registration's GN iterations and K1 phases.
- ``_batch_body`` and ``register_kind`` still run wrapped as
  ``f(ds_stack, *args)`` and ``f(pc, target, init, *args)``.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from simpleslam_tpu_torch.pipeline import app as tapp
from simpleslam_tpu_torch.pipeline import simulate as tsim
from simpleslam_tpu_torch.pipeline import streamed as tst
from simpleslam_tpu_torch.utils import tictoc
from simpleslam_tpu_torch.utils.config import Params as TParams
from simpleslam_tpu_torch.utils.logging import Logger as TLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SCANS = 32
SYNC_EVERY = 8
# the benchmark's two configurations (slambench/configs/*.json "program")
LO = {"mode": "lo", "backend": {"enable": False}, "frontend": {"pcr": "loam"},
      "torch": {"device": "cpu"}}
FULL = {"mode": "lo", "backend": {"enable": True, "lc": {"enable": True}},
        "frontend": {"pcr": "loam"}, "torch": {"device": "cpu"}}
# the stages run_streamed booked before the inner spans came
LO_STAGES = {"bootstrap", "prep", "upload", "dispatch", "map_update", "fetch",
             "bookkeep"}
FULL_STAGES = LO_STAGES | {"backend", "backend_lag", "lc"}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs several workers on a few cores: two torch threads a
    worker keeps them from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    TParams.reset()
    yield
    TParams.reset()
    TLogger.reset()


def _child(code: str) -> dict:
    """Run ``code`` in a fresh interpreter; its last stdout line is JSON."""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_span_books_what_add_books():
    a, b = tictoc.StageTimers(), tictoc.StageTimers()
    for _ in range(3):
        with a.span("stage", cpu=True):
            time.sleep(0.002)
    for s in a.series["stage"]:
        b.add("stage", s)
    assert a.count["stage"] == b.count["stage"] == 3
    assert a.total["stage"] == pytest.approx(b.total["stage"])
    assert a.series["stage"] == b.series["stage"]
    assert all(s >= 0.002 for s in a.series["stage"])
    assert "stage" in a.cpu and "stage" not in b.cpu
    assert [r[0] for r in a.records] == ["stage"] * 3 and not b.records
    name, thread, start_ns, dur_ns, cpu_ns = a.records[-1]
    assert thread == threading.current_thread().name
    assert dur_ns == pytest.approx(1e9 * a.series["stage"][-1], abs=1)
    assert 0 <= cpu_ns <= dur_ns
    assert abs(start_ns - time.time_ns()) < 10e9


def _burn(cpu_seconds):
    """Spin until this thread has used ``cpu_seconds`` of CPU (however long
    that takes on a loaded host)."""
    t_end = time.thread_time() + cpu_seconds
    while time.thread_time() < t_end:
        pass


@pytest.mark.parametrize("work,cpu_s", [
    (lambda: time.sleep(0.05), 0.0),
    (lambda: _burn(0.05), 0.05),
], ids=["sleeping", "busy"])
def test_span_books_the_threads_cpu_time(work, cpu_s):
    t = tictoc.StageTimers()
    with t.span("s", cpu=True):
        work()
    assert t.total["s"] >= 0.05
    assert t.cpu["s"] == pytest.approx(cpu_s, abs=0.005)
    assert t.cpu["s"] <= t.total["s"]


def test_ring_keeps_the_newest_and_counts_the_dropped():
    t = tictoc.StageTimers()
    n = tictoc.RING_RECORDS + 10
    for i in range(n):
        with t.span(f"s{i}"):
            pass
    assert len(t.records) == tictoc.RING_RECORDS == 65536
    assert t.dropped == 10
    assert t.records[0][0] == "s10" and t.records[-1][0] == f"s{n - 1}"
    assert sum(t.count.values()) == n


def test_spans_from_many_threads_lose_nothing():
    """Threads book into one timers while another reads it, under a short
    switch interval, so the reads fold the queue while spans are appended to
    it: no span is lost or counted twice."""
    t = tictoc.StageTimers()
    n_threads, per = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def book(i):
            with tictoc.bound(t):
                for _ in range(per):
                    with tictoc.span(f"s{i % 4}"):
                        pass
                t.add("lag", 1.0)

        threads = [threading.Thread(target=book, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        folds = 0
        while any(th.is_alive() for th in threads):
            sum(t.count.values())
            folds += 1
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert folds > 1
    assert sum(t.count[f"s{k}"] for k in range(4)) == n_threads * per
    assert sum(len(t.series[f"s{k}"]) for k in range(4)) == n_threads * per
    assert t.count["lag"] == n_threads and t.total["lag"] == n_threads
    assert len(t.records) + t.dropped == n_threads * per


def test_module_span_books_into_the_bound_timers_only():
    t, inner = tictoc.StageTimers(), tictoc.StageTimers()
    with tictoc.span("unbound"):
        pass
    with tictoc.bound(t):
        with tictoc.span("a"):
            pass
        with tictoc.bound(inner):
            with tictoc.span("b"):
                pass
        with tictoc.span("a"):
            pass
        other = threading.Thread(target=lambda: tictoc.span("c").__enter__())
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
    with tictoc.span("unbound"):
        pass
    assert dict(t.count) == {"a": 2}
    assert dict(inner.count) == {"b": 1}


def test_span_without_cpu_time():
    t = tictoc.StageTimers()
    with t.span("a"):
        _burn(0.01)
    assert t.count["a"] == 1 and t.total["a"] >= 0.01
    assert "a" not in t.cpu and t.records[-1][4] is None


def _counting(entered):
    real = tictoc.profiler_range

    def counting(name):
        entered.append(name)
        return real(name)

    return counting


def test_no_range_without_a_profiler(monkeypatch):
    entered = []
    monkeypatch.setattr(tictoc, "profiler_range", _counting(entered))
    assert not tictoc.profiler_active()
    t = tictoc.StageTimers()
    with tictoc.bound(t):
        for _ in range(5):
            with t.span("x"), tictoc.span("y"):
                pass
    assert t.count["x"] == t.count["y"] == 5
    assert entered == []


_BRACKET = r"""
import json, os, tempfile, time, torch
from torch.profiler import ProfilerActivity, profile
from simpleslam_tpu_torch.utils import tictoc
t = tictoc.StageTimers()
with profile(activities=[ProfilerActivity.CPU]) as prof:
    active = tictoc.profiler_active()
    for i in range(10):
        with t.span(f"s{i}"):
            torch.ones(64) + 1
            time.sleep(0.002)
ev = {e.name(): e for e in prof.profiler.kineto_results.events()}
out = []
for name, _, start_ns, dur_ns, _ in list(t.records)[1:]:  # s0 warms up
    e = ev[name]
    out.append([e.start_ns() - start_ns,
                e.start_ns() + e.duration_ns() - (start_ns + dur_ns)])
with tempfile.TemporaryDirectory() as d:
    prof.export_chrome_trace(os.path.join(d, "t.json"))
    trace = json.load(open(os.path.join(d, "t.json")))["traceEvents"]
cats = sorted({e.get("cat") for e in trace if e.get("name") in ev})
print(json.dumps({"active": active, "after": tictoc.profiler_active(),
                  "gaps": out, "cats": cats}))
"""


def test_span_record_brackets_its_profiler_event():
    """The range is entered after the span's stamps and left before its
    end, on the clock the profiler stamps with: the event lies inside the
    record, its start within 50 us of the record's (the range's own entry
    cost). It is not a user annotation, the kind the profiler mirrors onto
    the device timeline over the kernels launched inside it."""
    got = _child(_BRACKET)
    assert got["active"] and not got["after"]
    assert "user_annotation" not in got["cats"], got["cats"]
    gaps = np.array(got["gaps"], np.float64)
    assert len(gaps) == 9
    assert (gaps[:, 0] >= 0).all(), gaps
    assert (gaps[:, 1] <= 0).all(), gaps
    assert np.median(gaps[:, 0]) < 50e3, gaps


_THREADS = r"""
import json, threading, torch
from torch.profiler import ProfilerActivity, profile
from simpleslam_tpu_torch.utils import tictoc
from torch._C._profiler import _ExperimentalConfig
t = tictoc.StageTimers()
def work():
    with tictoc.bound(t):
        with tictoc.span("on_worker"):
            torch.ones(64) + 1
seen = {}
for every in (True, False):
    cfg = _ExperimentalConfig(profile_all_threads=True) if every else None
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=cfg) as prof:
        with tictoc.bound(t), tictoc.span("on_main"):
            th = threading.Thread(target=work, name="w")
            th.start()
            th.join()
    seen[str(every)] = sorted({(e.name(), e.start_thread_id())
                               for e in prof.profiler.kineto_results.events()
                               if e.name() in ("on_main", "on_worker")})
print(json.dumps({"seen": seen}))
"""


def test_profile_all_threads_puts_a_worker_thread_on_the_trace():
    got = _child(_THREADS)
    every = got["seen"]["True"]
    assert {n for n, _ in every} == {"on_main", "on_worker"}
    assert len({tid for _, tid in every}) == 2


# ---------------------------------------------------------------------------
# the streamed executor's spans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def streams():
    world = tsim.make_world(seed=3)
    return tsim.simulate_sequence(world, n_scans=N_SCANS, seed=3, n_az=720,
                                  n_el=16)


def _drive(cfg, streams):
    """One drive, counting the profiler ranges it enters."""
    entered = []
    TParams.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tictoc, "profiler_range", _counting(entered))
        r = tst.run_streamed(tapp.SlamSystem(dict(cfg)), streams,
                             sync_every=SYNC_EVERY)
    TParams.reset()
    TLogger.reset()
    return r, entered


@pytest.fixture(scope="module")
def lo_drive(streams):
    return _drive(LO, streams)


@pytest.fixture(scope="module")
def full_drive(streams):
    return _drive(FULL, streams)


@pytest.mark.parametrize("which", ["lo", "full"])
def test_drive_books_every_stage_and_the_per_scan_spans(which, lo_drive,
                                                        full_drive):
    r, entered = lo_drive if which == "lo" else full_drive
    t = r.timers
    assert entered == []          # no profiler: no range entered
    assert (LO_STAGES if which == "lo" else FULL_STAGES) <= set(t.count)
    n_reg = N_SCANS - 1           # scan 0 seeds the map
    nb = r.extras["n_batches"]
    for name in ("predict", "register", "chain"):
        assert t.count[name] == n_reg, (name, dict(t.count))
    for name in ("prep", "upload", "dispatch", "fetch", "bookkeep"):
        assert t.count[name] == nb
    # the per-scan spans nest inside dispatch, on its thread
    inner = sum(t.total[n] for n in ("predict", "register", "chain"))
    assert inner <= t.total["dispatch"]
    threads = {rec[0]: rec[1] for rec in t.records}
    main = threading.current_thread().name
    assert {threads[n] for n in ("dispatch", "predict", "register",
                                 "chain")} == {main}
    assert threads["prep_chunk"] == "scanprep"
    for name, cpu in t.cpu.items():
        assert 0 <= cpu <= t.total[name], name
    # only the spans a metric reads the CPU time of pay for reading it
    assert set(t.cpu) == ({"dispatch"} if which == "lo"
                          else {"dispatch", "backend"})
    assert t.dropped == 0 and len(t.records) == sum(
        t.count[n] for n in {rec[0] for rec in t.records})


def test_full_drive_books_scancontext_in_each_backend_event(full_drive):
    r, _ = full_drive
    t = r.timers
    n = t.count["backend"]
    assert n >= 2 and t.count["sc_ingest"] == t.count["sc_query"] == n
    assert t.cpu["dispatch"] <= t.total["dispatch"]
    assert t.cpu["backend"] <= t.total["backend"]
    assert (t.total["sc_ingest"] + t.total["sc_query"]
            <= t.total["backend"])
    threads = {rec[1] for rec in t.records
               if rec[0] in ("backend", "sc_ingest", "sc_query", "lc")}
    assert threads == {"backend"}


@pytest.mark.parametrize("which", ["lo", "full"])
def test_counters_hold_each_registration(which, lo_drive, full_drive):
    r, _ = lo_drive if which == "lo" else full_drive
    c = r.timers.counters
    assert len(c["gn_iters"]) == len(c["k1_phases"]) == N_SCANS - 1
    assert round(float(np.mean(c["gn_iters"])), 3) == r.extras[
        "gn_iters_mean"]
    assert round(float(np.mean(c["k1_phases"])), 3) == r.extras[
        "gn_gathers_mean"]
    assert all(v >= 1 for v in c["gn_iters"])


def test_wrapped_batch_body_and_register_still_run(streams, monkeypatch):
    """The benchmark's fault tests wrap both with positional arguments
    only; the spans inside come along."""
    calls = {"batch": 0, "register": 0}
    body, reg = tst._batch_body, tst.register_kind

    def batch(ds_stack, *args):
        calls["batch"] += 1
        return body(ds_stack, *args)

    def register(pc, target, init, *args):
        calls["register"] += 1
        return reg(pc, target, init, *args)

    monkeypatch.setattr(tst, "_batch_body", batch)
    monkeypatch.setattr(tst, "register_kind", register)
    short = tsim.SensorStreams(
        streams.scan_stamps[:9], streams.scans[:9], streams.gt_poses[:9],
        streams.wheel_stamps[:0], streams.wheel_poses[:0],
        streams.imu_stamps[:0], streams.imu_quats[:0])
    r = tst.run_streamed(tapp.SlamSystem(dict(LO)), short, sync_every=4)
    assert calls == {"batch": 2, "register": 8}
    assert r.timers.count["register"] == 8
    assert np.isfinite(r.poses).all()


def test_offline_run_books_its_spans(streams):
    short = tsim.SensorStreams(
        streams.scan_stamps[:6], streams.scans[:6], streams.gt_poses[:6],
        streams.wheel_stamps[:0], streams.wheel_poses[:0],
        streams.imu_stamps[:0], streams.imu_quats[:0])
    r = tapp.run_offline(tapp.SlamSystem(dict(FULL)), short)
    t = r.timers
    assert t.count["odometry"] == 6
    assert t.count["backend"] >= 1
    assert t.count["sc_ingest"] == t.count["backend"]
    assert t.count["loop_closure"] == t.count["backend"]
    assert not t.cpu
