"""The PyTorch port's EKF fusion filter, beside the JAX package.

The five cases of tests/test_filter.py on the port (the streaming numpy
proxy is the behavioural spec; the f32 replay must match it), then the port's
replay against the JAX package's ``ekf_replay`` on one tape, and inside the
port: chunked against whole-tape replay bit for bit, and the C++ step
against the numpy step.

The port's replay runs on the host in f32 (``csrc/hostops.cpp`` through
``native.ekf_replay_chunk``, numpy where the helpers are not built), the JAX
package's as a compiled ``lax.scan``; both round each operation to f32, but
``cos``/``sin`` and the 2x2 inverse may differ in the last bit and the filter
feeds itself, so the two are held to 1e-4 m / 1e-4 rad over the tape
(measured: 5e-7 m, 1e-8 rad over 60 scans of events), with the emitted mask
identical.
"""

import numpy as np
import pytest

from simpleslam_tpu.models import filter as jflt
from simpleslam_tpu.pipeline import simulate as sim
from simpleslam_tpu_torch import native
from simpleslam_tpu_torch.models import filter as flt
from simpleslam_tpu_torch.utils.config import Params
from simpleslam_tpu_torch.utils.logging import Logger


@pytest.fixture(autouse=True)
def _params():
    Params.load({"torch": {"device": "cpu"}})
    yield
    Params.reset()
    Logger.reset()


def _streams(n_scans=40, seed=3):
    world = sim.make_world(seed=seed, n_buildings=0)
    return sim.simulate_sequence(world, n_scans=n_scans, seed=seed, n_az=60,
                                 n_el=2)


def _tape_args(streams):
    return (streams.wheel_stamps, streams.wheel_poses, streams.imu_stamps,
            streams.imu_quats)


def _run_streaming(streams):
    proxy = flt.EkfOdomProxy(deque_size=0)
    wi = ii = 0
    W, I = len(streams.wheel_stamps), len(streams.imu_stamps)
    while wi < W or ii < I:
        tw = streams.wheel_stamps[wi] if wi < W else np.inf
        ti = streams.imu_stamps[ii] if ii < I else np.inf
        if ti <= tw:
            proxy.imu_handler(float(ti), streams.imu_quats[ii])
            ii += 1
        else:
            proxy.wheel_handler(float(tw), streams.wheel_poses[wi])
            wi += 1
    return proxy.local_odom.snapshot()


def test_scan_replay_matches_streaming():
    streams = _streams()
    stream_odo = _run_streaming(streams)
    res = flt.ekf_replay(flt.build_tape(*_tape_args(streams)))
    scan_odo = flt.replay_to_odometry(res)
    assert len(scan_odo) == len(stream_odo) > 0
    for a, b in zip(stream_odo, scan_odo):
        assert a.stamp == pytest.approx(b.stamp, abs=1e-5)
        # replay runs f32, streaming f64: allow f32 accumulation drift
        np.testing.assert_allclose(a.odom, b.odom, atol=1e-3)


def test_fusion_tracks_ground_truth():
    streams = _streams(n_scans=60)
    odo = _run_streaming(streams)
    stamps = np.array([o.stamp for o in odo])
    xy = np.stack([o.odom[:2, 3] for o in odo])
    gt_xy = np.stack([
        np.interp(stamps, streams.scan_stamps, streams.gt_poses[:, i, 3])
        for i in (0, 1)
    ], axis=1)
    rmse = np.sqrt(np.mean(np.sum((xy - gt_xy) ** 2, axis=1)))
    assert rmse < 0.5


def test_imu_update_rate_gated_by_wheel():
    """The IMU update only fires once per wheel predict (mUpdateImuFlag)."""
    proxy = flt.EkfOdomProxy(deque_size=0)
    q = np.array([1.0, 0, 0, 0])
    proxy.imu_handler(0.0, q)  # init
    x0 = proxy.x.copy()
    turned = np.array([np.cos(0.1), 0, 0, np.sin(0.1)])
    for k in range(5):  # no wheel predict in between: no update at all
        proxy.imu_handler(0.01 * (k + 1), turned)
    np.testing.assert_array_equal(proxy.x, x0)

    proxy.wheel_handler(0.06, np.eye(4))  # init wheel
    proxy.wheel_handler(0.11, np.eye(4))  # predict + sets flag
    proxy.imu_handler(0.12, turned)
    assert proxy.x[2] != x0[2]  # update fired
    x1 = proxy.x.copy()
    proxy.imu_handler(0.13, np.array([np.cos(0.2), 0, 0, np.sin(0.2)]))
    np.testing.assert_array_equal(proxy.x, x1)  # flag consumed, gated again


def test_dt_squared_noise_scaling():
    """Parity with the modified Kalman lib: P grows with dt^2 on predict."""
    P = np.eye(3) * 1e-8
    var = np.array([1.0, 1.0, 0.01])
    P1 = flt.ekf_predict(P, 0.1, var)
    P2 = flt.ekf_predict(P, 0.2, var)
    np.testing.assert_allclose((P2 - P)[0, 0] / (P1 - P)[0, 0], 4.0, rtol=1e-6)


def _chunked(streams, chunk, replay_chunk):
    stamps, is_wheel, xy, wyaw, iyaw = flt.build_tape_arrays(
        *_tape_args(streams))
    n = len(stamps)
    assert n > 300  # enough events for several chunks
    carry = flt.ekf_carry0()
    c_st, c_xs = [], []
    for pos in range(0, n, chunk):
        sl = slice(pos, min(pos + chunk, n))
        im = ~is_wheel[sl]
        last_iy = float(iyaw[sl][im][-1]) if im.any() else 0.0
        tape = flt.pad_tape_chunk(stamps[sl], is_wheel[sl], xy[sl], wyaw[sl],
                                  iyaw[sl], chunk, last_iy)
        carry, res = replay_chunk(carry, tape)
        c_st.append(res.stamps[res.emitted])
        c_xs.append(res.states[res.emitted])
    return np.concatenate(c_st), np.concatenate(c_xs)


def _numpy_chunk(carry, tape):
    carry, states, emitted = flt._replay_numpy(carry, tape)
    return carry, flt.EkfReplayResult(tape.stamps, states, emitted)


@pytest.mark.parametrize("step", ["main", "numpy"])
def test_chunked_replay_matches_whole_tape(step):
    """The incremental chunked replay (the lio feeder's path) is
    bit-identical to the whole-tape replay across chunk boundaries, on the
    step the main path runs and on the numpy step."""
    streams = _streams(n_scans=40, seed=7)
    replay_chunk = flt.ekf_replay_chunk if step == "main" else _numpy_chunk
    tape = flt.build_tape(*_tape_args(streams))
    whole = replay_chunk(flt.ekf_carry0(), tape)[1]
    c_st, c_xs = _chunked(streams, 128, replay_chunk)
    assert len(c_st) == int(whole.emitted.sum()) > 0
    np.testing.assert_array_equal(c_st, whole.stamps[whole.emitted])
    np.testing.assert_array_equal(c_xs, whole.states[whole.emitted])


def test_replay_matches_the_jax_replay():
    streams = _streams(n_scans=60, seed=3)
    jres = jflt.ekf_replay(jflt.build_tape(*_tape_args(streams)))
    tape = flt.build_tape(*_tape_args(streams))
    np.testing.assert_array_equal(tape.stamps, np.asarray(
        jflt.build_tape(*_tape_args(streams)).stamps))
    res = flt.ekf_replay(tape)
    em = np.asarray(jres.emitted)
    np.testing.assert_array_equal(res.emitted, em)
    assert em.sum() > 100
    gap = np.abs(res.states - np.asarray(jres.states))[em].max(axis=0)
    print(f"largest state gap over the tape: x {gap[0]:.2e} m, y "
          f"{gap[1]:.2e} m, yaw {gap[2]:.2e} rad ({native.backend()} step)")
    assert gap[0] < 1e-4 and gap[1] < 1e-4 and gap[2] < 1e-4, gap


def test_cpp_step_matches_numpy_step():
    """The C++ step the main path runs against the numpy step (the path
    where the helpers are not built), over one tape."""
    if native.backend() != "cpp":
        pytest.skip("needs the C++ build of the host helpers (g++)")
    tape = flt.build_tape(*_tape_args(_streams(n_scans=40, seed=5)))
    carry, res = flt.ekf_replay_chunk(flt.ekf_carry0(), tape)
    carry_n, states_n, emitted_n = flt._replay_numpy(flt.ekf_carry0(), tape)
    np.testing.assert_array_equal(res.emitted, emitted_n)
    np.testing.assert_allclose(res.states, states_n, rtol=0, atol=1e-5)
    for a, b in zip(carry, carry_n):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=0,
                                   atol=1e-5)


def test_step_on_a_carry_from_the_jax_package():
    """Both packages' steps on the very same mid-tape state: the JAX carry
    after 300 events, carried across with ``carry_from_numpy``, then one
    wheel and one IMU event through each package's step."""
    streams = _streams(n_scans=40, seed=3)
    arrs = jflt.build_tape_arrays(*_tape_args(streams))
    head = jflt.pad_tape_chunk(*(a[:300] for a in arrs), 300, 0.0)
    jcarry, _ = jflt.ekf_replay_chunk(jflt.ekf_carry0(), head)
    carry = flt.carry_from_numpy([np.asarray(leaf) for leaf in jcarry])
    done = set()
    for e in range(300, 400):
        kind = bool(arrs[1][e])
        if kind in done:
            continue
        done.add(kind)
        one = tuple(a[e:e + 1] for a in arrs)
        jc, jres = jflt.ekf_replay_chunk(
            jcarry, jflt.pad_tape_chunk(*one, 1, 0.0))
        tape = flt.pad_tape_chunk(*one, 1, 0.0)
        _, res = flt.ekf_replay_chunk(carry, tape)
        _, (x_np, em_np) = flt._ekf_step(
            carry, (tape.stamps[0], tape.is_wheel[0], tape.wheel_xy[0],
                    tape.wheel_yaw[0], tape.imu_yaw[0]))
        want = np.asarray(jres.states)[0]
        np.testing.assert_allclose(res.states[0], want, rtol=0, atol=2e-6)
        np.testing.assert_allclose(x_np, want, rtol=0, atol=2e-6)
        assert bool(res.emitted[0]) == bool(jres.emitted[0]) == em_np == kind
    assert done == {True, False}
