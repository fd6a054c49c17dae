"""The single-device entry hook: the flagship forward step and its arguments.

Port of the reference package's ``__graft_entry__.entry`` and its
``_tiny_fixture``: LOAM scan-to-map registration (the whole Gauss-Newton
loop: gather, plane fit, masked normal equations, 6x6 solve, SE(3) update)
of 256 points against a small world of two walls and a ground plane.

    fn, args = entry()                  # on the card
    pose = fn(*args)                    # one launch of K3 (gn_loop_fused)
    fn, args = entry(device="cpu")      # the plain version on the CPU

On a CUDA device ``fn`` is one launch of K3 against the sorted voxel table,
or with ``dense=True`` against the dense voxel map (the production fast
path of the reference hook's fixture); on the CPU it runs K3's plain
version, ``loam.gn_loop_stepwise``. The world is drawn from
``np.random.default_rng(0)`` in the reference's order, so both packages
build it from the same numpy arrays (``fixture_arrays``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops import loam
from .ops import pointcloud as pcops
from .ops import voxel as vox


def fixture_arrays(n_src: int = 256, n_map: int = 2048):
    """(map points (3 n_map, 3), source points (n_src, 3)), both f32: the
    ground and two walls with 1 cm of noise, and ``n_src`` of those points
    drawn without replacement."""
    rng = np.random.default_rng(0)
    # two walls + ground so the GN system is fully constrained
    g = rng.uniform(-8, 8, size=(n_map, 2)).astype(np.float32)
    ground = np.stack([g[:, 0], g[:, 1], np.zeros(n_map, np.float32)], 1)
    w1 = np.stack([g[:, 0], np.full(n_map, 8.0, np.float32),
                   g[:, 1] * 0.3 + 2], 1)
    w2 = np.stack([np.full(n_map, -8.0, np.float32), g[:, 0],
                   g[:, 1] * 0.3 + 2], 1)
    map_xyz = np.concatenate([ground, w1, w2]) + rng.normal(
        size=(3 * n_map, 3)).astype(np.float32) * 0.01
    src_idx = rng.choice(len(map_xyz), size=n_src, replace=False)
    return map_xyz, map_xyz[src_idx]


def _tiny_fixture(n_src: int = 256, n_map: int = 2048,
                  num_voxels: int = 4096, slab: int = 4, dense: bool = False,
                  device=None):
    """(source cloud, target map) of the plane world on ``device``: the
    sorted voxel table (1 m grid, ``num_voxels`` rows of ``slab`` points),
    or with ``dense=True`` the dense voxel map (2 m grid, 16 x 16 x 8
    voxels of 16 points)."""
    dev = torch.device("cuda" if device is None else device)
    map_xyz, src_xyz = fixture_arrays(n_src, n_map)
    map_pc = pcops.from_numpy(map_xyz, 4 * n_map, dev)
    origin = torch.zeros(3, dtype=torch.float32, device=dev)
    if dense:
        vm = vox.build_dense_voxel_map(map_pc, 2.0, origin, dims=(16, 16, 8),
                                       slab_size=16)
    else:
        vm = vox.build_voxel_map(map_pc, 1.0, origin, num_voxels=num_voxels,
                                 slab_size=slab)
    return pcops.from_numpy(src_xyz, n_src, dev), vm


def entry(device: Optional[str] = None, dense: bool = False):
    """(forward step on the flagship kernel, its example arguments).

    ``fn(src, vm, init_pose)`` returns the registered (4, 4) pose of
    ``loam.scan2map``. ``device`` defaults to ``"cuda"``, as the config's
    ``torch.device`` does; pass ``"cpu"`` for the plain version."""
    src, vm = _tiny_fixture(dense=dense, device=device)
    init_pose = torch.eye(4, dtype=torch.float32, device=src.xyz.device)

    def fn(src, vm, init_pose):
        return loam.scan2map(src, vm, init_pose).pose

    return fn, (src, vm, init_pose)
