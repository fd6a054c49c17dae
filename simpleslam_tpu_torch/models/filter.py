"""Planar EKF wheel+IMU fusion — the LocalOdom producer of lio mode.

Port of ``simpleslam_tpu/models/filter.py`` (reference filter stack:
``filter/include/filter/*``, ``dataproxy/src/EkfOdomProxy.cpp:25-252`` and the
modified Kalman library ``kalman/ExtendedKalmanFilter.hpp:91-155``):

- 3-state planar state [x, y, yaw] with identity dynamics,
- 1-D IMU yaw and 2-D wheel xy measurement models with trivial Jacobians,
- the dt^2-scaled process/measurement covariances of the modified library,
  including the ``dt = max(dt, 1e-6)`` clamps,
- the relative-measurement trick for both sensors (wheel: the last fused
  state composed with the wheel increment; IMU: the relative yaw added to
  the current state yaw and wrapped about it),
- the update-rate gate: the IMU update only fires on the first IMU message
  after each wheel predict, so the filter's update rate is the wheel rate.

Two execution paths:

1. ``EkfOdomProxy`` — the streaming path (offline and threaded runs): tiny
   3x3 numpy f64 math per message.
2. ``ekf_replay`` / ``ekf_replay_chunk`` — the bulk path of the streamed
   executor: the merged event tape fused in f32, one event after the other.
   The replay stays on the host: it is a strictly sequential scan over a
   3-state filter (each step needs the last step's ``x``, ``P`` and flags,
   so a GPU has no parallel work in it and would run thousands of dependent
   3x3 launches), and its output is consumed on the host straight away (the
   nearest-stamp lookup of ``streamed._LocalOdomFeeder``). The step runs in
   the package's C++ host helpers (``native.ekf_replay_chunk``); where they
   are not built, in numpy f32 (``_ekf_step``), which is also what the tests
   hold the C++ step against. Whole-tape and chunked replays run the same
   step, so they agree bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np

from .. import native
from ..utils.concurrency import SafeDeque
from ..utils.config import Params
from ..utils.logging import Logger
from .frontend import Odometry

# Noise setup (EkfOdomProxy.cpp:72-95; stored squared = variances).
PRIOR_STD = np.array([1e-4, 1e-4, 1e-4])
SYS_STD = np.array([1.0, 1.0, math.radians(5.0)])
IMU_STD = np.array([math.radians(0.1)])
WHEEL_STD = np.array([0.1, 0.1])
_MIN_DT = 1e-6


def _wrap_about(a: float, ref: float) -> float:
    """Wrap ``a`` into (ref - pi, ref + pi] (utils::math::correctAngles)."""
    return a - 2.0 * math.pi * round((a - ref) / (2.0 * math.pi))


def _quat_yaw(q: np.ndarray) -> float:
    """Yaw of a (w, x, y, z) quaternion (ZYX convention, trans::q2ypr row 0)."""
    w, x, y, z = q
    return math.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def _pose2d(x: float, y: float, yaw: float) -> np.ndarray:
    c, s = math.cos(yaw), math.sin(yaw)
    T = np.eye(4)
    T[0, 0], T[0, 1], T[1, 0], T[1, 1] = c, -s, s, c
    T[0, 3], T[1, 3] = x, y
    return T


# ---------------------------------------------------------------------------
# core EKF steps (numpy; the streaming proxy runs them in f64)
# ---------------------------------------------------------------------------

def ekf_predict(P, dt, sys_var):
    """Identity-dynamics predict: x unchanged, P += dt^2 * Q
    (F = W = I, ExtendedKalmanFilter.hpp:109-122)."""
    dt = max(dt, _MIN_DT)
    return P + (dt * dt) * np.diag(sys_var)


def ekf_update(x, P, z, H, meas_var, dt):
    """EKF update with dt^2-scaled R (ExtendedKalmanFilter.hpp:131-155)."""
    dt = np.maximum(dt, _MIN_DT)
    R = (dt * dt) * np.diag(meas_var)
    S = H @ P @ H.T + R
    K = P @ H.T @ np.linalg.inv(S)
    x = x + K @ (z - H @ x)
    P = P - K @ H @ P
    return x, P


_H_IMU = np.array([[0.0, 0.0, 1.0]])
_H_WHEEL = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])


# ---------------------------------------------------------------------------
# streaming proxy
# ---------------------------------------------------------------------------

class EkfOdomProxy:
    """Message-driven fusion producer (EkfOdomProxy.cpp semantics).

    ``wheel_handler``/``imu_handler`` mirror the reference callbacks; fused
    planar odometry is pushed to ``local_odom`` at wheel rate.
    """

    def __init__(self, deque_size: Optional[int] = None):
        cfg = Params.get_instance()
        self.lg = Logger.get_instance()
        size = deque_size if deque_size is not None else int(
            cfg["frontend"]["local_size"])
        self.local_odom: SafeDeque[Odometry] = SafeDeque(size)

        self.x = np.zeros(3)
        self.P = np.diag(PRIOR_STD ** 2)
        self._update_imu_flag = False
        self._imu_last_time = -1.0
        self._imu_last_q: Optional[np.ndarray] = None
        self._wheel_last_time = -1.0
        self._wheel_last: Optional[Tuple[np.ndarray, float]] = None  # (t, yaw)

    # EkfOdomProxy.cpp:130-170
    def imu_handler(self, stamp: float, quat_wxyz: np.ndarray) -> None:
        q = np.asarray(quat_wxyz, np.float64)
        if self._imu_last_time < 0:
            self._imu_last_time = stamp
            self._imu_last_q = q
            self.x[2] = _quat_yaw(q)
            self.P = np.diag(PRIOR_STD ** 2)
            self.lg.info("imu init x done: (%g, %g, %g)", *self.x)
            return
        if self._update_imu_flag:
            self._update_imu_flag = False
            dt = stamp - self._imu_last_time
            # relative yaw, absolute-ized about the current state yaw
            dyaw = _quat_yaw(_quat_mul(_quat_conj(self._imu_last_q), q))
            z = _wrap_about(self.x[2] + dyaw, self.x[2])
            self.x, self.P = ekf_update(
                self.x, self.P, np.array([z]), _H_IMU, IMU_STD ** 2, dt)
            self._imu_last_time = stamp
            self._imu_last_q = q

    # EkfOdomProxy.cpp:185-248
    def wheel_handler(self, stamp: float, wheel_pose: np.ndarray) -> None:
        t = np.asarray(wheel_pose[:3, 3], np.float64)
        yaw = math.atan2(wheel_pose[1, 0], wheel_pose[0, 0])
        if self._wheel_last_time < 0:
            self._wheel_last_time = stamp
            self._wheel_last = (t, yaw)
            self.x[0], self.x[1] = t[0], t[1]
            self.P = np.diag(PRIOR_STD ** 2)
            self.lg.info("wheel init x done: (%g, %g, %g)", *self.x)
            return
        dt = stamp - self._wheel_last_time
        self.P = ekf_predict(self.P, dt, SYS_STD ** 2)
        self._update_imu_flag = True

        # measurement = fused state composed with the wheel increment
        lt, lyaw = self._wheel_last
        delta = _pose2d(*self.x[:2], self.x[2]) @ (
            np.linalg.inv(_pose2d(lt[0], lt[1], lyaw)) @ _pose2d(t[0], t[1], yaw)
        )
        z = delta[:2, 3]
        self.x, self.P = ekf_update(self.x, self.P, z, _H_WHEEL, WHEEL_STD ** 2, dt)

        self._wheel_last_time = stamp
        self._wheel_last = (t, yaw)
        self.local_odom.push_back(
            Odometry(stamp, _pose2d(self.x[0], self.x[1], self.x[2])), block=False
        )

    def abort(self) -> None:
        self.local_odom.abort()


def _quat_conj(q: np.ndarray) -> np.ndarray:
    return np.array([q[0], -q[1], -q[2], -q[3]])


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


# ---------------------------------------------------------------------------
# batched replay: the merged event tape fused on the host in f32
# ---------------------------------------------------------------------------

class EkfTape(NamedTuple):
    """Merged, stamp-sorted sensor event tape (numpy)."""

    stamps: np.ndarray     # (E,) f32
    is_wheel: np.ndarray   # (E,) bool
    wheel_xy: np.ndarray   # (E, 2) f32 wheel position (zeros on imu rows)
    wheel_yaw: np.ndarray  # (E,) f32 wheel yaw
    imu_yaw: np.ndarray    # (E,) f32 absolute imu yaw (zeros on wheel rows)


def build_tape_arrays(wheel_stamps: np.ndarray, wheel_poses: np.ndarray,
                      imu_stamps: np.ndarray, imu_quats: np.ndarray):
    """Merged, stamp-ordered event arrays (numpy f64, unpadded) — the first
    half of ``build_tape``; the chunked feeder slices these directly."""
    wy = np.arctan2(wheel_poses[:, 1, 0], wheel_poses[:, 0, 0])
    iy = np.array([_quat_yaw(q) for q in np.asarray(imu_quats, np.float64)])
    stamps = np.concatenate([wheel_stamps, imu_stamps])
    is_wheel = np.concatenate(
        [np.ones(len(wheel_stamps), bool), np.zeros(len(imu_stamps), bool)])
    xy = np.concatenate(
        [wheel_poses[:, :2, 3], np.zeros((len(imu_stamps), 2))])
    wyaw = np.concatenate([wy, np.zeros(len(imu_stamps))])
    iyaw = np.concatenate([np.zeros(len(wheel_stamps)), iy])
    order = np.lexsort((is_wheel, stamps))  # stable: imu before wheel on ties
    return (stamps[order], is_wheel[order], xy[order], wyaw[order],
            iyaw[order])


def pad_tape_chunk(stamps, is_wheel, xy, wyaw, iyaw, cap: int,
                   last_imu_yaw: float) -> EkfTape:
    """Pad one event-array slice to ``cap`` rows with IMU rows at the final
    stamp repeating ``last_imu_yaw`` and cast it to f32. A pad row emits
    nothing, but it may consume the update flag and shrink P on a
    zero-innovation update, so only a chunk that no real event follows is
    ever padded (the final one)."""
    n = len(stamps)
    if cap > n:
        pad = cap - n
        last_t = stamps[-1] if n else 0.0
        stamps = np.concatenate([stamps, np.full(pad, last_t)])
        is_wheel = np.concatenate([is_wheel, np.zeros(pad, bool)])
        xy = np.concatenate([xy, np.zeros((pad, 2))])
        wyaw = np.concatenate([wyaw, np.zeros(pad)])
        iyaw = np.concatenate([iyaw, np.full(pad, last_imu_yaw)])
    return EkfTape(
        np.asarray(stamps, np.float32),
        np.asarray(is_wheel, bool),
        np.asarray(xy, np.float32).reshape(-1, 2),
        np.asarray(wyaw, np.float32),
        np.asarray(iyaw, np.float32),
    )


def build_tape(wheel_stamps: np.ndarray, wheel_poses: np.ndarray,
               imu_stamps: np.ndarray, imu_quats: np.ndarray) -> EkfTape:
    """Merge wheel/imu streams into one stamp-ordered tape (ties: imu first,
    matching bag dispatch order), padded as the reference pads it: to a
    power-of-2 bucket of at least 4096 events, with IMU rows after every
    real event, so the emitted rows are those of the unpadded tape."""
    stamps, is_wheel, xy, wyaw, iyaw = build_tape_arrays(
        wheel_stamps, wheel_poses, imu_stamps, imu_quats)
    n = len(stamps)
    cap = max(4096, 1 << int(np.ceil(np.log2(max(n, 1)))))
    last_iy = iyaw[np.nonzero(~is_wheel)[0][-1]] if (~is_wheel).any() else 0.0
    return pad_tape_chunk(stamps, is_wheel, xy, wyaw, iyaw, cap,
                          float(last_iy))


class EkfReplayResult(NamedTuple):
    stamps: np.ndarray   # (E,) f32 event stamps
    states: np.ndarray   # (E, 3) f32 fused [x, y, yaw] after each event
    emitted: np.ndarray  # (E,) bool — True where a wheel event pushed odometry


_F32 = np.float32
_TWO_PI = _F32(2.0 * math.pi)
# (prior xx yy tt, system xx yy tt, imu, wheel x y) variances, f64 squares
# cast to f32 as the reference casts them
_VAR = np.concatenate([PRIOR_STD ** 2, SYS_STD ** 2, IMU_STD ** 2,
                       WHEEL_STD ** 2]).astype(np.float32)


def _wrap32(a, ref):
    return a - _TWO_PI * np.round((a - ref) / _TWO_PI)


def _ekf_step(carry, ev):
    """One event of the fused replay in numpy f32: (new carry, (state,
    emitted)). Same init, gating, dt bookkeeping and update order as the
    streaming proxy, with the 3x3 algebra written out for the two
    measurement models (H = [0 0 1] and H = [I2 0]) as
    ``csrc/hostops.cpp::ekf_replay_chunk`` writes it."""
    (x, P, imu_init, wheel_init, upd_flag,
     imu_t, imu_yaw_prev, wheel_t, wx_prev, wy_prev, wyaw_prev) = carry
    stamp, is_wheel, exy, wyaw, iyaw = ev
    min_dt = _F32(_MIN_DT)
    P0 = np.diag(_VAR[:3])
    emitted = False
    if is_wheel:
        if not wheel_init:
            x = x.copy()
            x[0], x[1] = exy[0], exy[1]
            P, wheel_init = P0, True
        else:
            dt = max(stamp - wheel_t, min_dt)
            dt2 = dt * dt
            P = P.copy()
            for i in range(3):
                P[i, i] = P[i, i] + dt2 * _VAR[3 + i]
            # z = xy of state_pose * (last_wheel^-1 * cur_wheel)
            ca, sa = np.cos(wyaw_prev), np.sin(wyaw_prev)
            dx, dy = exy[0] - wx_prev, exy[1] - wy_prev
            rx = ca * dx + sa * dy
            ry = -sa * dx + ca * dy
            c, s = np.cos(x[2]), np.sin(x[2])
            z0 = x[0] + c * rx - s * ry
            z1 = x[1] + s * rx + c * ry
            s00, s01 = P[0, 0] + dt2 * _VAR[7], P[0, 1]
            s10, s11 = P[1, 0], P[1, 1] + dt2 * _VAR[8]
            det = s00 * s11 - s01 * s10
            i00, i01, i10, i11 = s11 / det, -s01 / det, -s10 / det, s00 / det
            K0 = P[:, 0] * i00 + P[:, 1] * i10
            K1 = P[:, 0] * i01 + P[:, 1] * i11
            y0, y1 = z0 - x[0], z1 - x[1]
            x = x + (K0 * y0 + K1 * y1)
            P = P - (K0[:, None] * P[0][None, :] + K1[:, None] * P[1][None, :])
            upd_flag, emitted = True, True
        wheel_t, wx_prev, wy_prev, wyaw_prev = stamp, exy[0], exy[1], wyaw
    elif not imu_init:
        x = x.copy()
        x[2] = iyaw
        P, imu_init = P0, True
        imu_t, imu_yaw_prev = stamp, iyaw
    elif upd_flag:
        dt = max(stamp - imu_t, min_dt)
        dyaw = _wrap32(iyaw - imu_yaw_prev, _F32(0.0))
        z = _wrap32(x[2] + dyaw, x[2])
        sinv = _F32(1.0) / (P[2, 2] + (dt * dt) * _VAR[6])
        K = P[:, 2] * sinv
        y = z - x[2]
        x = x + K * y
        P = P - K[:, None] * P[2][None, :]
        upd_flag = False
        imu_t, imu_yaw_prev = stamp, iyaw
    carry = (x, P, imu_init, wheel_init, upd_flag,
             imu_t, imu_yaw_prev, wheel_t, wx_prev, wy_prev, wyaw_prev)
    return carry, (x, emitted)


def ekf_carry0():
    """Initial replay carry (pre-init filter, matching EkfOdomProxy ctor):
    (x (3,), P (3, 3), imu_init, wheel_init, upd_flag, imu_t, imu_yaw_prev,
    wheel_t, wx_prev, wy_prev, wyaw_prev), floats in f32."""
    f = _F32
    return (np.zeros(3, f), np.diag(_VAR[:3]), False, False, False,
            f(-1.0), f(0.0), f(-1.0), f(0.0), f(0.0), f(0.0))


def carry_from_numpy(leaves):
    """A replay carry from the host arrays of another package's 11-tuple
    (e.g. ``np.asarray`` of each leaf of the reference package's carry), so
    both packages' steps can be evaluated on the very same state."""
    x, P, a, b, c, *scal = leaves
    return (np.array(x, _F32).reshape(3), np.array(P, _F32).reshape(3, 3),
            bool(a), bool(b), bool(c), *(_F32(s) for s in scal))


def _replay_numpy(carry, tape: EkfTape):
    states = np.empty((len(tape.stamps), 3), _F32)
    emitted = np.zeros(len(tape.stamps), bool)
    for e in range(len(tape.stamps)):
        carry, (states[e], emitted[e]) = _ekf_step(
            carry, (tape.stamps[e], tape.is_wheel[e], tape.wheel_xy[e],
                    tape.wheel_yaw[e], tape.imu_yaw[e]))
    return carry, states, emitted


def ekf_replay_chunk(carry, tape: EkfTape):
    """Fuse one tape chunk, carrying the filter state across chunks — the
    incremental form of ``ekf_replay`` (same step, so chunked and whole
    replays agree bit for bit). Returns (carry, EkfReplayResult)."""
    x, P, imu_init, wheel_init, upd_flag, *scal = carry
    x = np.array(x, _F32)
    P = np.array(P, _F32)
    flags = np.array([imu_init, wheel_init, upd_flag], np.int32)
    scal_a = np.array(scal, _F32)
    out = native.ekf_replay_chunk(x, P, flags, scal_a, _VAR, tape.stamps,
                                  tape.is_wheel, tape.wheel_xy,
                                  tape.wheel_yaw, tape.imu_yaw)
    if out is None:
        carry, states, emitted = _replay_numpy(carry, tape)
    else:
        states, emitted = out
        carry = (x, P, *(bool(f) for f in flags), *(_F32(s) for s in scal_a))
    return carry, EkfReplayResult(tape.stamps, states, emitted)


def ekf_replay(tape: EkfTape) -> EkfReplayResult:
    """Fuse the whole tape in one pass (see ``_ekf_step`` for semantics)."""
    return ekf_replay_chunk(ekf_carry0(), tape)[1]


def replay_to_odometry(res: EkfReplayResult) -> list:
    """Convert emitted replay states to host Odometry entries (wheel rate)."""
    stamps = np.asarray(res.stamps, np.float64)
    states = np.asarray(res.states, np.float64)
    return [
        Odometry(float(stamps[i]), _pose2d(states[i, 0], states[i, 1], states[i, 2]))
        for i in np.nonzero(res.emitted)[0]
    ]
