"""The readers of the program's thread-CPU and inner spans, its span
records and its per-registration counters, on hand-made timers: off-CPU
time in ``dispatch`` per scan, ``register`` per scan, the backend worker's
CPU time and ScanContext's spans per keyframe event, the share of
``dispatch`` beside a backend pass, and the p90 of each registration's GN
iterations and K1 phases; the span readers read only the drives without the
profiler, and a drive whose timers lack what a reader reads (a program that
books none of it) reads None, not 0."""

import types

import numpy as np
import pytest

from slambench import run, trace


class _Timers:
    def __init__(self, total, count, cpu=None, records=None, counters=None):
        self.total, self.count, self.series = total, count, {}
        if cpu is not None:
            self.cpu = cpu
        if records is not None:
            self.records, self.dropped = records, 0
        if counters is not None:
            self.counters = counters


def _record(n_scans, total=None, count=None, cpu=None, session=None,
            records=None, counters=None):
    result = types.SimpleNamespace(
        timers=_Timers(total or {}, count or {}, cpu, records, counters),
        wall_time=1.0,
        extras={"scan_capacity": 100, "gn_iters_mean": 3.0,
                "gn_gathers_mean": 1.0})
    return run.DriveRecord(result, n_scans, np.full(n_scans, 80), session)


def _read(name, records, cell="vlp16_full.city_drive"):
    ctx = run.Context(run.Cell(cell), records, 2.0, 5.0, 24)
    return run.load_reader({"name": name}).read(ctx)


PROFILED = trace.Session(1.0, 0, busy_s=0.1)


def test_dispatch_offcpu_is_wall_less_cpu_per_scan():
    recs = [_record(100, total={"dispatch": 0.5}, cpu={"dispatch": 0.3}),
            _record(300, total={"dispatch": 1.0}, cpu={"dispatch": 0.4}),
            _record(100, total={"dispatch": 9.0}, cpu={"dispatch": 0.0},
                    session=PROFILED)]
    # (0.2 + 0.6) s over 400 scans
    assert _read("dispatch_offcpu_ms_per_scan", recs) == pytest.approx(2.0)


def test_register_per_scan():
    recs = [_record(200, total={"register": 0.06},
                    count={"register": 199}),
            _record(200, total={"register": 5.0}, count={"register": 199},
                    session=PROFILED)]
    assert _read("register_ms_per_scan", recs,
                 "vlp16_lo.city_drive") == pytest.approx(0.3)


def test_backend_cpu_and_sc_per_event():
    rec = _record(100, total={"backend": 0.25, "sc_ingest": 0.03,
                              "sc_query": 0.02},
                  count={"backend": 10, "sc_ingest": 10, "sc_query": 10},
                  cpu={"backend": 0.12, "sc_ingest": 0.01, "sc_query": 0.01})
    assert _read("backend_cpu_ms_per_event", [rec]) == pytest.approx(12.0)
    assert _read("sc_ms_per_event", [rec]) == pytest.approx(5.0)


@pytest.mark.parametrize("name", ["dispatch_offcpu_ms_per_scan",
                                  "register_ms_per_scan",
                                  "backend_cpu_ms_per_event",
                                  "sc_ms_per_event",
                                  "dispatch_backend_overlap_share",
                                  "gn_iters_p90", "k1_phases_p90"])
def test_a_drive_without_the_spans_reads_none(name):
    """The timers of a program that books wall times only, and none of the
    inner spans: the readers give None, not 0."""
    old = _record(100, total={"dispatch": 0.5, "backend": 0.2},
                  count={"dispatch": 4, "backend": 8})
    assert _read(name, [old]) is None
    # one drive without the CPU times is enough to read nothing
    new = _record(100, total={"dispatch": 0.5, "backend": 0.2},
                  count={"dispatch": 4, "backend": 8},
                  cpu={"dispatch": 0.4, "backend": 0.1})
    if name in ("dispatch_offcpu_ms_per_scan", "backend_cpu_ms_per_event"):
        assert _read(name, [new, old]) is None
        assert _read(name, [new]) is not None


def _span(name, start_ms, dur_ms, thread="MainThread"):
    return (name, thread, int(start_ms * 1e6), int(dur_ms * 1e6), None)


def test_overlap_share_is_dispatch_time_beside_a_backend_pass(capsys):
    # dispatches [0, 10), [20, 30), [40, 50) ms; passes [5, 25), [45, 46)
    recs = [_span("dispatch", 0, 10), _span("predict", 1, 2),
            _span("backend", 5, 20, "backend"), _span("dispatch", 20, 10),
            _span("dispatch", 40, 10), _span("backend", 45, 1, "backend")]
    # the profiled drive's records are not read
    traced = [_span("dispatch", 0, 10), _span("backend", 0, 10, "backend")]
    drives = [_record(30, records=recs),
              _record(30, records=traced, session=PROFILED)]
    # (5 + 5 + 1) ms of 30
    assert _read("dispatch_backend_overlap_share", drives) == pytest.approx(
        100.0 * 11 / 30)
    err = capsys.readouterr().err
    assert "0 batches beside a pass" in err and "3 batches alone" in err


def test_overlap_share_needs_whole_records_and_a_backend_pass():
    recs = [_span("dispatch", 0, 10), _span("backend", 5, 20, "backend")]
    dropped = _record(30, records=recs)
    dropped.timers.dropped = 1
    assert _read("dispatch_backend_overlap_share", [dropped]) is None
    lo = _record(30, records=[_span("dispatch", 0, 10)])
    assert _read("dispatch_backend_overlap_share", [lo]) is None
    assert _read("dispatch_backend_overlap_share",
                 [_record(30, records=recs), _record(30)]) is None


@pytest.mark.parametrize("name,counter", [("gn_iters_p90", "gn_iters"),
                                          ("k1_phases_p90", "k1_phases")])
def test_counter_p90_over_every_registration(name, counter):
    a = [float(v) for v in range(1, 11)]
    b = [20.0, 30.0]
    drives = [_record(11, counters={counter: a}),
              _record(3, counters={counter: b}, session=PROFILED)]
    assert _read(name, drives) == pytest.approx(np.percentile(a + b, 90))
    # a program without the counter, in any one drive, reads None
    assert _read(name, [_record(11, counters={counter: a}),
                        _record(11)]) is None
    assert _read(name, [_record(11, counters={})]) is None
