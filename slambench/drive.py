"""The one general drive generator: a traffic file's parameters and a seed
in, one drive (a recorded bag's worth of scans, wheel and IMU messages and
the ground truth) out.

A traffic file (``slambench/traffic/<name>.json``) names a world and its
arguments, a trajectory, the number of scans, the scan period and the
sensor noise; the configuration file gives the sensor (beams, azimuth
steps, range). Scans are ray-cast in child processes, each scan from a
generator of its own (``SeedSequence([seed, 1, i])``), so the drive is the
same whatever the number of children. Children are plain interpreters
(``python -m slambench.drive``) that write their scans to a pipe: no shared
memory and no file.

Everything here is numpy and the frozen simulator ``slambench/sim.py``.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import threading
from dataclasses import dataclass
from typing import List

import numpy as np

from . import sim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# world builders a traffic file can name, with its arguments
WORLDS = {
    "city": lambda seed, a: sim.make_world(seed=seed, **a),
    "loop": lambda seed, a: sim.make_loop_world(seed=seed, **a),
    "forest": lambda seed, a: sim.make_forest_world(seed=seed, **a),
    "adversarial": lambda seed, a: sim.make_adversarial_world(seed=seed, **a),
    "sloped": lambda seed, a: sim.make_sloped_world(seed=seed, **a),
    "corridor": lambda seed, a: sim.make_corridor_world(**a),
    "courtyard": lambda seed, a: sim.make_courtyard(seed=seed, **a),
}


@dataclass
class Drive:
    """One drive; the field names are those of the program's input bundle."""

    scan_stamps: np.ndarray          # (S,)
    scans: List[np.ndarray]          # S x (n_i, 3) float32, sensor frame
    gt_poses: np.ndarray             # (S, 4, 4) body ground truth
    wheel_stamps: np.ndarray
    wheel_poses: np.ndarray
    imu_stamps: np.ndarray
    imu_quats: np.ndarray
    ds_counts: np.ndarray            # (S,) voxels of each scan at the map grid


def trajectory(traffic: dict):
    """(stamps, body poses) of the traffic's trajectory: the simulator's
    circle (``loop``) or straight line, or an outward ``spiral`` (copied
    from ``bench.py``'s long run) about (0, ``center_y``) from ``radius``,
    ``lap_gap`` metres further out each lap, so a second lap passes its
    first ``lap_gap`` to the side."""
    tr = traffic["trajectory"]
    n, dt = int(traffic["n_scans"]), float(traffic["dt"])
    speed, r0 = float(tr["speed"]), float(tr.get("radius", 40.0))
    kind = tr.get("kind", "loop")
    if kind != "spiral":
        return sim.make_trajectory(n, dt, speed, r0, loop=kind == "loop")
    cy = float(tr.get("center_y", r0))
    c = float(tr["lap_gap"]) / (2 * np.pi)
    th_fine = np.linspace(0, 8.0 * np.pi, 80000)
    r_fine = r0 + c * th_fine
    s_fine = np.concatenate([[0.0], np.cumsum(
        np.sqrt(r_fine[:-1] ** 2 + c ** 2) * np.diff(th_fine))])
    th = np.interp(np.arange(n) * speed * dt, s_fine, th_fine)
    r = r0 + c * th
    x, y = r * np.sin(th), cy - r * np.cos(th)
    yaw = np.unwrap(np.arctan2(np.gradient(y), np.gradient(x)))
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, 0, 0], poses[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    poses[:, 1, 0], poses[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    poses[:, 0, 3], poses[:, 1, 3] = x, y
    return np.arange(n) * dt, poses


def _movers(traffic: dict, seed: int, stamps, poses):
    """Moving obstacles crossing the path (the simulator's ``n_dynamic``)."""
    n_dyn = int(traffic.get("n_dynamic", 0))
    rng = np.random.default_rng(np.random.SeedSequence([seed, 2]))
    out = []
    dt = float(traffic["dt"])
    n = len(stamps)
    for _ in range(n_dyn):
        ti = rng.uniform(0.1, 0.9) * n * dt
        k = min(int(ti / dt), n - 1)
        heading = rng.uniform(0, 2 * np.pi)
        spd = rng.uniform(0.8, 4.0)
        start = poses[k, :2, 3] - np.array(
            [np.cos(heading), np.sin(heading)]) * spd * ti
        dims = (0.5, 0.5, 1.8) if rng.random() < 0.5 else (4.0, 1.8, 1.6)
        out.append((start, heading, spd, dims))
    return out


def voxel_count(xyz: np.ndarray, grid: float) -> int:
    """Occupied voxels of ``grid`` (floor of xyz / grid, origin 0)."""
    if len(xyz) == 0:
        return 0
    k = np.floor(xyz * (np.float32(1.0) / np.float32(grid))).astype(np.int64)
    k += 1 << 20
    return int(len(np.unique((k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2])))


def simulate_scans(spec: dict, idx) -> tuple:
    """Scans ``idx`` of the drive ``spec`` describes, with their voxel
    counts at the map grid."""
    traffic, sensor, seed = spec["traffic"], spec["sensor"], int(spec["seed"])
    world = WORLDS[traffic["world"]](seed, dict(traffic.get("world_args", {})))
    stamps, poses = trajectory(traffic)
    movers = _movers(traffic, seed, stamps, poses)
    scans, counts = [], []
    for i in idx:
        extra = []
        for start, heading, spd, dims in movers:
            t = stamps[i]
            extra.extend(sim._box_patches(start[0] + np.cos(heading) * spd * t,
                                          start[1] + np.sin(heading) * spd * t,
                                          heading, *dims))
        rng = np.random.default_rng(np.random.SeedSequence([seed, 1, int(i)]))
        pts = sim.simulate_scan(
            world, sim.sensor_from_body(poses[i], float(sensor["lidar_height"])),
            n_az=int(sensor["n_az"]), n_el=int(sensor["n_el"]),
            min_range=float(sensor["min_range"]),
            max_range=float(sensor["max_range"]),
            noise=float(traffic["noise"]), rng=rng,
            extra_patches=extra or None)
        scans.append(pts)
        counts.append(voxel_count(pts, float(spec["grid"])))
    return scans, np.asarray(counts, np.int64)


def _odometry_streams(traffic: dict, seed: int, stamps, poses):
    """Wheel odometry and IMU orientation, as the simulator makes them."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 3]))
    dt = float(traffic["dt"])
    duration = stamps[-1] + dt
    wheel_rate = float(traffic.get("wheel_rate", 20.0))
    imu_rate = float(traffic.get("imu_rate", 100.0))
    wn = int(duration * wheel_rate)
    w_stamps = np.arange(wn) / wheel_rate
    gt_xyyaw = sim._interp_planar(stamps, poses, w_stamps)
    d = np.diff(gt_xyyaw, axis=0, prepend=gt_xyyaw[:1])
    slip = 1.0 + rng.normal(0, 0.01, size=(wn, 1))
    noise_yaw = rng.normal(0, 0.002, size=wn)
    wheel = np.cumsum(d * np.concatenate([slip, slip, np.ones((wn, 1))], 1),
                      axis=0)
    wheel[:, 2] += np.cumsum(noise_yaw) * 0.02 + gt_xyyaw[0, 2]
    wheel[:, :2] += gt_xyyaw[0, :2]
    inn = int(duration * imu_rate)
    i_stamps = np.arange(inn) / imu_rate
    gt_i = sim._interp_planar(stamps, poses, i_stamps)
    yaw = (gt_i[:, 2] + np.cumsum(rng.normal(0, 1e-4, size=inn))
           + rng.normal(0, 5e-4, size=inn))
    quats = np.stack([np.cos(yaw / 2), np.zeros_like(yaw), np.zeros_like(yaw),
                      np.sin(yaw / 2)], axis=1)
    return w_stamps, sim._planar_to_pose(wheel), i_stamps, quats


def _child_env() -> dict:
    env = dict(os.environ)
    for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        env[k] = "1"
    return env


class DriveJob:
    """The drive of ``traffic`` under ``sensor`` from ``seed``, ray-cast in
    ``workers`` child processes (0: one per core) that run while the caller
    goes on; ``result()`` waits for them."""

    def __init__(self, traffic: dict, sensor: dict, grid: float, seed: int,
                 workers: int = 0):
        self.traffic, self.seed = traffic, seed
        self.stamps, self.poses = trajectory(traffic)
        n = len(self.stamps)
        spec = {"traffic": traffic, "sensor": sensor, "grid": grid,
                "seed": seed}
        workers = max(1, min(workers or os.cpu_count() or 1, n))
        self.parts = [list(range(w, n, workers)) for w in range(workers)]
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "slambench.drive",
             json.dumps({"spec": spec, "idx": p})],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=_child_env()) for p in self.parts]
        self.outs = [None] * len(self.procs)
        self.threads = [threading.Thread(target=self._collect, args=(k,))
                        for k in range(len(self.procs))]
        for t in self.threads:
            t.start()

    def _collect(self, k: int) -> None:
        self.outs[k] = self.procs[k].communicate()

    def close(self) -> None:
        """Stop the children that still run and wait for them."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for t in self.threads:
            t.join()

    def result(self) -> Drive:
        for t in self.threads:
            t.join()
        n = len(self.stamps)
        scans: List[np.ndarray] = [None] * n  # type: ignore[list-item]
        counts = np.zeros(n, np.int64)
        for p, part, (out, err) in zip(self.procs, self.parts, self.outs):
            if p.returncode != 0:
                raise RuntimeError("drive worker failed: "
                                   + err.decode()[-2000:])
            z = np.load(io.BytesIO(out))
            offs = np.concatenate([[0], np.cumsum(z["sizes"])])
            for k, i in enumerate(part):
                scans[i] = z["points"][offs[k]:offs[k + 1]]
            counts[part] = z["counts"]
        # the ground truth in the frame of the first scan, where the
        # program starts its map (a spiral does not start at yaw 0)
        gt = np.linalg.inv(self.poses[0]) @ self.poses
        w_st, w_po, i_st, i_q = _odometry_streams(self.traffic, self.seed,
                                                  self.stamps, gt)
        return Drive(self.stamps, scans, gt, w_st, w_po, i_st, i_q, counts)


def _worker_main(arg: str) -> None:
    job = json.loads(arg)
    scans, counts = simulate_scans(job["spec"], job["idx"])
    buf = io.BytesIO()
    np.savez(buf, points=np.concatenate(scans) if scans
             else np.zeros((0, 3), np.float32),
             sizes=np.array([len(s) for s in scans], np.int64), counts=counts)
    sys.stdout.buffer.write(buf.getvalue())
    sys.stdout.buffer.flush()


if __name__ == "__main__":
    _worker_main(sys.argv[1])
