"""The metric arithmetic on hand-made inputs: the rate over the window, the
p90 with its sample count, the device's busy union and idle gaps, the K3
count check, and the frozen K3 bound against hand-worked counts."""

import types

import numpy as np
import pytest

from slambench import roofline, run, trace


class _Timers:
    def __init__(self, total, count, series):
        self.total, self.count, self.series = total, count, series


def _record(n_scans, total=None, count=None, series=None, session=None,
            iters=3.0, gathers=1.0, capacity=100):
    result = types.SimpleNamespace(
        timers=_Timers(total or {}, count or {}, series or {}), wall_time=1.0,
        extras={"scan_capacity": capacity, "gn_iters_mean": iters,
                "gn_gathers_mean": gathers})
    return run.DriveRecord(result, n_scans, np.full(n_scans, 80), session)


def _ctx(records, window_s=2.0, name="vlp16_full.city_drive"):
    return run.Context(run.Cell(name), records, window_s, 5.0, 24)


def _read(name, ctx):
    metric = {"name": name}
    return run.load_reader(metric).read(ctx)


def test_rate_is_all_scans_over_the_window():
    ctx = _ctx([_record(300), _record(300), _record(300)], window_s=4.5)
    assert _read("scans_per_s", ctx) == pytest.approx(200.0)


def test_p90_over_every_burst(capsys):
    lags = [[0.1 * k for k in range(1, 11)], [1.1, 1.2, 1.3, 1.4, 1.5]]
    ctx = _ctx([_record(10, series={"backend_lag": s}) for s in lags])
    v = _read("kf_lag_p90_ms", ctx)
    assert v == pytest.approx(1e3 * np.percentile(
        [x for s in lags for x in s], 90))
    assert "15 keyframe-event bursts" in capsys.readouterr().err


def test_p90_needs_ten_samples():
    ctx = _ctx([_record(10, series={"backend_lag": [0.1] * 9})])
    assert _read("kf_lag_p90_ms", ctx) is None


def test_span_metrics_skip_profiled_drives():
    sess = trace.Session(1.0, 0, busy_s=0.1)
    recs = [_record(100, total={"dispatch": 0.5}),
            _record(100, total={"dispatch": 9.0}, session=sess)]
    assert _read("dispatch_ms_per_scan", _ctx(recs)) == pytest.approx(5.0)
    ev = _record(100, total={"backend": 0.3, "lc": 2.0},
                 count={"backend": 3, "lc": 4})
    assert _read("backend_ms_per_event", _ctx([ev])) == pytest.approx(100.0)
    assert _read("lc_ms_per_event", _ctx([ev])) == pytest.approx(500.0)


def test_busy_union_gaps_and_k3_count():
    k3 = "void gn_loop_kernel<4>(float const*, int)"
    events = [  # (name, on the device, start s, end s)
        (k3, True, 0.0, 1.0),
        ("other_kernel(int)", True, 0.5, 1.5),   # overlaps: union 0-1.5
        ("Memcpy DtoH", True, 3.0, 3.5),          # gap 1.5-3.0
        (k3, True, 4.0, 4.5),                     # gap 3.5-4.0
        ("aten::add", False, 1.0, 2.9),           # covers the first gap
    ]
    s = trace.reduce(events, 10.0, 2)
    assert s.busy_s == pytest.approx(2.5)
    assert s.k3_seen == 2 and s.k3_s == pytest.approx(1.5)
    assert s.kernels == 3 and s.accepted
    assert s.gaps == {"aten::add": pytest.approx(1.5),
                      "host outside any op": pytest.approx(0.5)}
    assert not trace.reduce(events, 10.0, 3).accepted   # a lost launch


def test_device_readers_use_accepted_sessions_only():
    good = trace.Session(2.0, 2, k3_seen=2, k3_s=40e-6, kernels=300,
                         busy_s=0.1)
    lost = trace.Session(2.0, 5, k3_seen=2, k3_s=40e-6, kernels=300,
                         busy_s=0.1)
    recs = [_record(2, session=good), _record(2, session=lost),
            _record(2)]
    ctx = _ctx(recs)
    assert ctx.dropped == 1 and ctx.sessions == [good]
    assert _read("k3_us_per_launch", ctx) == pytest.approx(20.0)
    assert _read("device_idle_share", ctx) == pytest.approx(95.0)
    assert _read("launches_per_scan", ctx) == pytest.approx(150.0)


def test_no_accepted_session_reads_nothing():
    ctx = _ctx([_record(2)])
    for name in ("k3_us_per_launch", "k3_roofline", "device_idle_share",
                 "launches_per_scan"):
        assert _read(name, ctx) is None


def test_k3_bound_by_hand():
    # 1000 slots, 800 valid, 192 candidates, 2 K1 phases in 5 iterations
    nbytes, ops = roofline.k3_work(1000, 800, 192, 2, 5)
    assert nbytes == 2 * 800 * 192 * 6 + 1000 * 13 + 144
    assert ops == 2 * 800 * (24 * 192 + 520) + 3 * 1000 * 120 + 5 * 1500
    t, by = roofline.k3_bound_s(1000, 800, 192, 2, 5)
    assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    # operations bound when there is almost nothing to read
    t, by = roofline.k3_bound_s(1, 1, 192, 1, 1000)
    assert by == "operations"


def test_k3_roofline_sums_the_bound_over_registrations():
    sess = trace.Session(1.0, 3, k3_seen=3, k3_s=3e-5, busy_s=0.1)
    rec = _record(4, session=sess, iters=3.0, gathers=1.0, capacity=100)
    bound = 3 * roofline.k3_bound_s(100, 80, 8 * 24, 1.0, 3.0)[0]
    assert _read("k3_roofline", _ctx([rec])) == pytest.approx(
        100 * bound / 3e-5)
