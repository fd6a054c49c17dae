"""Persistence: TUM trajectories, PCD point clouds, g2o factor graphs.

Port of ``simpleslam_tpu/utils/fileio.py``. Format-compatible with the
reference and with the reference package, so maps can be exchanged:
- ``tum.txt``       keyframe trajectory    (common/utils/File.hpp:25-95)
- ``{i}.pcd``       per-keyframe clouds    (frontend/src/MapManager.cpp:203-213)
- ``fg.g2o``        factor graph           (backend/src/Backend.cpp:125-222)

All readers/writers are numpy host-side (IO never sits on the device path).
PCD support covers the subset the reference produces/consumes via PCL:
XYZ[I] fields, ascii and binary encodings.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import geometry as geo

# ---------------------------------------------------------------------------
# TUM trajectories: "stamp tx ty tz qx qy qz qw" per line
# ---------------------------------------------------------------------------

def write_tum(dir_or_path: str, stamps: np.ndarray, poses: np.ndarray, append: bool = False) -> str:
    """Write poses (K, 4, 4) with stamps (K,) in TUM format.

    Matches reference precision: stamp/translation at 3 decimals, quaternion
    at 6 (File.hpp:32).
    """
    path = _tum_path(dir_or_path)
    mode = "a" if (append and os.path.exists(path)) else "w"
    R = torch.as_tensor(np.asarray(poses, np.float64)[..., :3, :3])
    qs = geo.rot_to_quat(R).numpy()
    with open(path, mode) as f:
        for stamp, pose, q in zip(np.asarray(stamps), np.asarray(poses), qs):
            t = pose[:3, 3]
            w, x, y, z = q
            f.write(
                f"{stamp:.3f} {t[0]:.3f} {t[1]:.3f} {t[2]:.3f} "
                f"{x:.6f} {y:.6f} {z:.6f} {w:.6f}\n"
            )
    return path


def load_tum(dir_or_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a TUM file -> (stamps (K,), poses (K, 4, 4)). Empty arrays if absent."""
    path = _tum_path(dir_or_path)
    if not os.path.isfile(path):
        return np.zeros((0,)), np.zeros((0, 4, 4))
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 8:
                rows.append([float(v) for v in parts[:8]])
    if not rows:
        return np.zeros((0,)), np.zeros((0, 4, 4))
    arr = np.asarray(rows, dtype=np.float64)
    stamps = arr[:, 0]
    t = arr[:, 1:4]
    # file stores x y z w; geo uses (w, x, y, z)
    q_wxyz = np.concatenate([arr[:, 7:8], arr[:, 4:7]], axis=1)
    R = geo.quat_to_rot(torch.as_tensor(q_wxyz, dtype=torch.float64)).numpy()
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = t
    return stamps, poses


def remove_tum(dir_or_path: str) -> None:
    path = _tum_path(dir_or_path)
    if os.path.exists(path):
        os.remove(path)


def _tum_path(dir_or_path: str) -> str:
    if dir_or_path.endswith(".txt"):
        return dir_or_path
    return os.path.join(dir_or_path, "tum.txt")


# ---------------------------------------------------------------------------
# PCD files (XYZ[I]; ascii / binary)
# ---------------------------------------------------------------------------

def save_pcd(path: str, xyz: np.ndarray, intensity: Optional[np.ndarray] = None,
             binary: bool = True, stamp: float = 0.0) -> None:
    """Write an XYZ[I] PCD v0.7 file (binary by default, like the reference)."""
    xyz = np.asarray(xyz, dtype=np.float32)
    n = xyz.shape[0]
    fields = ["x", "y", "z"] + (["intensity"] if intensity is not None else [])
    nf = len(fields)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(['4'] * nf)}\n"
        f"TYPE {' '.join(['F'] * nf)}\n"
        f"COUNT {' '.join(['1'] * nf)}\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    data = xyz if intensity is None else np.concatenate(
        [xyz, np.asarray(intensity, dtype=np.float32).reshape(n, 1)], axis=1
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(np.ascontiguousarray(data, dtype=np.float32).tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")


def load_pcd(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a PCD file -> (xyz (N, 3) f32, intensity (N,) f32 zeros if absent).

    Handles ascii and binary encodings with arbitrary 4-byte float/int/uint
    field layouts (enough for PCL-written XYZI clouds, incl. padding fields).
    """
    with open(path, "rb") as f:
        header: Dict[str, List[str]] = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, *vals = line.split()
            header[key.upper()] = vals
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n = int(header["POINTS"][0])
        mode = header["DATA"][0].lower()

        np_types = {("F", 4): "f4", ("F", 8): "f8", ("U", 1): "u1", ("U", 2): "u2",
                    ("U", 4): "u4", ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4"}
        dtype_fields = []
        for name, size, typ, cnt in zip(fields, sizes, types, counts):
            base = np_types[(typ, size)]
            dtype_fields.append((name, base, (cnt,)) if cnt > 1 else (name, base))
        dt = np.dtype(dtype_fields)

        if mode == "binary":
            raw = f.read(dt.itemsize * n)
            arr = np.frombuffer(raw, dtype=dt, count=n)
        elif mode == "ascii":
            arr = np.loadtxt(f, dtype=np.float64, max_rows=n)
            arr = np.atleast_2d(arr)
            rec = np.zeros(n, dtype=dt)
            col = 0
            for name, cnt in zip(fields, counts):
                if cnt == 1:
                    rec[name] = arr[:, col]
                else:
                    rec[name] = arr[:, col:col + cnt]
                col += cnt
            arr = rec
        else:
            raise ValueError(f"unsupported PCD DATA mode: {mode}")

    xyz = np.stack(
        [arr["x"].astype(np.float32), arr["y"].astype(np.float32), arr["z"].astype(np.float32)],
        axis=1,
    )
    if "intensity" in fields:
        inten = arr["intensity"].astype(np.float32).reshape(-1)
    else:
        inten = np.zeros((n,), dtype=np.float32)
    return xyz, inten



# ---------------------------------------------------------------------------
# g2o factor-graph files (VERTEX_SE3:QUAT / EDGE_SE3:QUAT)
# ---------------------------------------------------------------------------

def _quats(poses: np.ndarray) -> np.ndarray:
    """(K, 4, 4) -> (K, 4) (w, x, y, z), computed in f64."""
    R = torch.as_tensor(np.asarray(poses, np.float64).reshape(-1, 4, 4)[:, :3, :3])
    return geo.rot_to_quat(R).numpy()


def _rot(q_wxyz) -> np.ndarray:
    return geo.quat_to_rot(torch.as_tensor(np.asarray(q_wxyz, np.float64))).numpy()


def write_g2o(path: str, poses: np.ndarray,
              edges: List[Tuple[int, int, np.ndarray, np.ndarray]]) -> None:
    """Write VERTEX_SE3:QUAT lines for poses (K, 4, 4) and EDGE_SE3:QUAT
    lines for ``edges`` (i, j, between pose (4, 4), info (6, 6)), the
    information matrix in g2o order (translation block first) as its upper
    triangle. Quaternions are computed in f64 (the reference package's in
    f32); both print 9 decimals."""
    poses = np.asarray(poses)
    with open(path, "w") as f:
        for k, (pose, q) in enumerate(zip(poses, _quats(poses))):
            t = pose[:3, 3]
            w, x, y, z = q
            f.write(
                f"VERTEX_SE3:QUAT {k} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                f"{x:.9f} {y:.9f} {z:.9f} {w:.9f}\n"
            )
        for i, j, bt, info in edges:
            bt = np.asarray(bt)
            info = np.asarray(info)
            t = bt[:3, 3]
            w, x, y, z = _quats(bt)[0]
            upper = " ".join(
                f"{info[r, c]:.9f}" for r in range(6) for c in range(r, 6)
            )
            f.write(
                f"EDGE_SE3:QUAT {i} {j} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                f"{x:.9f} {y:.9f} {z:.9f} {w:.9f} {upper}\n"
            )


def load_g2o(path: str) -> Tuple[np.ndarray, List[Tuple[int, int, np.ndarray, np.ndarray]]]:
    """Read VERTEX_SE3:QUAT / EDGE_SE3:QUAT -> (poses (K, 4, 4), edges list),
    information matrices in g2o order (translation first)."""
    vertices: Dict[int, np.ndarray] = {}
    edges: List[Tuple[int, int, np.ndarray, np.ndarray]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "VERTEX_SE3:QUAT":
                idx = int(parts[1])
                tx, ty, tz, qx, qy, qz, qw = (float(v) for v in parts[2:9])
                pose = np.eye(4)
                pose[:3, :3] = _rot([qw, qx, qy, qz])
                pose[:3, 3] = (tx, ty, tz)
                vertices[idx] = pose
            elif tag == "EDGE_SE3:QUAT":
                i, j = int(parts[1]), int(parts[2])
                tx, ty, tz, qx, qy, qz, qw = (float(v) for v in parts[3:10])
                bt = np.eye(4)
                bt[:3, :3] = _rot([qw, qx, qy, qz])
                bt[:3, 3] = (tx, ty, tz)
                vals = [float(v) for v in parts[10:31]]
                info = np.zeros((6, 6))
                k = 0
                for r in range(6):
                    for c in range(r, 6):
                        info[r, c] = info[c, r] = vals[k]
                        k += 1
                edges.append((i, j, bt, info))
    if vertices:
        poses = np.tile(np.eye(4), (max(vertices) + 1, 1, 1))
        for idx, pose in vertices.items():
            poses[idx] = pose
    else:
        poses = np.zeros((0, 4, 4))
    return poses, edges


def is_file(path: str) -> bool:
    return os.path.isfile(path)
