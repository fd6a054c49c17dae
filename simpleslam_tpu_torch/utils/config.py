"""Config system: a comment-tolerant JSON params singleton.

Mirrors the reference's config layer (``config/params.hpp:17-48``): a single
JSON file (``//`` comments allowed), one process-wide instance, and the same
schema keys as ``config/params.json`` so reference configs load unchanged.
Unlike the reference (path compiled in via -DCONFIG_FILE), the path is set at
runtime via ``Params.load(path)`` or falls back to built-in defaults.
"""

from __future__ import annotations

import copy
import json
import re
import threading
from typing import Any, Optional

_COMMENT_RE = re.compile(r'("(?:[^"\\]|\\.)*")|//[^\n]*')


def _strip_comments(text: str) -> str:
    # Remove // comments but never inside string literals.
    return _COMMENT_RE.sub(lambda m: m.group(1) or "", text)


DEFAULT_PARAMS: dict = {
    "mode": "lo",  # "lo" (lidar-only) or "lio" (EKF wheel+imu local odometry)
    "cores": 4,  # kept for config parity; TPU kernels ignore it
    "downSampleVoxelGridSize": 0.5,
    "pcd_file": "",
    "saveMapDir": "",
    "rosbag": "",
    "tf": {"lidar_height": 2.0},
    "dataproxy": {
        "lidar": "/lidar_points",
        "lidar_size": 10,
        "imu": "/imu/data",
        "wheel": "/odom/raw",
    },
    "vis": {"enable": False, "align": "/aligned", "submap": "/globalmap",
            "out_dir": ""},
    "backend": {
        "enable": True,  # pose-graph backend (reference always runs it)
        "lc": {
            "enable": False,
            "contextDownSampleGridSize": 0.5,
            "historySubmapRange": 1,
            "fitnessThreshold": 0.3,
        },
        "context": {
            "used": "scancontext",  # place-recognition plugin (see models/context.py)
            "distcontext": {"distThres": 5.0},
            "scancontext": {
                "numExcludeRecent": 40,
                "buildTreeGap": 10,
                "numCandidatesFromTree": 10,
                "searchRatio": 0.1,
                "scDistThres": 0.4,
            }
        },
    },
    # planar_clamp: the per-frame SixDof2Mobile z/roll/pitch clamp
    # (LidarOdometry.cpp:211). The reference hardcodes it (mobile base on
    # flat ground); sloped/rough terrain needs it off, so it is a config
    # knob here (tests/test_adversarial.py runs a sloped world with it off).
    # degeneracy_guard: zero GN updates along eigen-directions with no real
    # constraint (corridors) — disabled by default for the same reason the
    # reference disables its _removeDegeneratePart (ops/loam.py rationale).
    "frontend": {"pcr": "loam", "local_size": 100, "global_size": 10,
                 "planar_clamp": True, "degeneracy_guard": False},
    # TPU-native capacity knobs (no reference counterpart): static shapes
    # everything is padded to. Chosen so XLA compiles each kernel once.
    "tpu": {
        # multi-chip execution: > 0 runs the streamed pipeline on a device
        # mesh of that many chips — registration shards scan points ("dp"
        # axis, fused psum per GN iteration), the backend solves the pose
        # graph edge-sharded. 0 = single device.
        "mesh_devices": 0,
        "scan_capacity": 32768,      # raw scan points
        "ds_scan_capacity": 8192,    # downsampled scan points fed to PCR
        # streamed executor: device-resident keyframe store row capacity and
        # the max keyframes merged per submap rebuild (8 m radius window).
        # The window cap must cover REVISIT density: the reference's radius
        # search has NO cap (MapManager.cpp:176-192) — at 16, a second-lap
        # pass saturates the window and drops half the local coverage,
        # leaving registration marginal (29 % scan support measured) and
        # bistable; the resulting slide self-poisons the map (ATE 0.22 m ->
        # 71 m on the 1.8-lap longrun). 24 covers two-lap density at the
        # 1 m keyframe gap inside 8 m.
        "kf_capacity": 8192,
        "submap_kf_window": 24,
        "submap_capacity": 131072,   # submap points
        "map_voxel_capacity": 65536, # voxel slots in the sorted neighbor map
        "max_pts_per_voxel": 8,
        # dense registration-target grid (ops/voxel.py DenseVoxelMap): window
        # dims in voxels around the submap anchor; at the 1 m LOAM grid this
        # covers +-96 m xy / +-16 m z — the 80 m lidar range plus the 8 m
        # submap radius. Lookup is pure index math (no key search).
        "dense_grid_dims": [192, 192, 32],
        # slab capacity of the LOAM dense map (grid 2.0; a 2 m voxel of a
        # 0.5 m-downsampled surface holds ~16 points, 24 leaves headroom).
        # NOT 16, although that would make the corner gather's candidate
        # axis one exact lane tile (8*16 = 128) and cut per-iteration
        # candidate passes by a third: a full-to-the-brim slab truncates
        # exactly when voxels hold two surfaces or dense returns, and the
        # corridor-degeneracy world then lattice-locks (the along-corridor
        # direction re-acquires spurious support above the guard floor —
        # tests/test_adversarial.py::test_corridor_pipeline_does_not_diverge
        # regresses from 0.05 m to 4.3 m of invented standstill).
        "loam_slab_size": 24,
        "max_keyframes": 2048,
        "max_edges": 8192,
        # initial pose-graph device capacities; grow x4 on demand up to the
        # max_* envelope (each growth rebuilds + recompiles once). Keeps the
        # padded per-event solve O(actual graph), not O(envelope).
        "kf_bucket": 128,
        "edge_bucket": 512,
    },
    # PyTorch port only: the device every tensor of the main path lives on.
    # The port never switches device on its own; tests set "cpu".
    "torch": {"device": "cuda"},
}


class Params:
    """Process-wide parameter singleton (reference ``config::Params``).

    ``getInstance()`` returns a deep copy like the reference returns a json
    copy (params.hpp:38-41) so callers can't mutate shared state.
    """

    _lock = threading.Lock()
    _params: Optional[dict] = None

    @classmethod
    def load(cls, path_or_dict: Any = None) -> dict:
        with cls._lock:
            base = copy.deepcopy(DEFAULT_PARAMS)
            if path_or_dict is None:
                loaded: dict = {}
            elif isinstance(path_or_dict, dict):
                loaded = path_or_dict
            else:
                with open(path_or_dict, "r") as f:
                    loaded = json.loads(_strip_comments(f.read()))
            _deep_update(base, loaded)
            cls._params = base
            return copy.deepcopy(base)

    @classmethod
    def get_instance(cls) -> dict:
        with cls._lock:
            if cls._params is None:
                cls._params = copy.deepcopy(DEFAULT_PARAMS)
            return copy.deepcopy(cls._params)

    # camelCase alias for reference-API familiarity
    getInstance = get_instance

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._params = None


def _deep_update(base: dict, new: dict) -> None:
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
