"""Point-parallel scan-to-map registration over the ranks of a mesh axis.

Port of ``simpleslam_tpu/parallel/dist_registration.py``: the scan's points
are split into one contiguous block per rank; every rank linearizes its
block against the replicated map, and the 43 floats of each iteration's
normal equations (J^T J, J^T e, n_valid) are summed across the ranks in one
collective, in rank order, so every rank takes the same step. On CUDA this
is the stepwise GN loop (K1 or K4 on a refresh, K2 otherwise; see
``ops.loam.gn_loop_stepwise``). On one rank it is the unsharded call.
"""

from __future__ import annotations

import torch

from ..ops import loam
from ..ops.pointcloud import PointCloud
from .mesh import Axis, Mesh


def loam_hooks(ax: Axis):
    """(reduce_fn, rmax_reduce_fn) of ``loam.gn_loop`` on axis ``ax``: one
    fused 43-float cross-rank sum of the normal equations, and the max of
    the source range. With one rank both are None, so the call is the
    unsharded one (K3 on CUDA) bit for bit."""
    if ax.size == 1:
        return None, None

    def fused_sum(JtJ, JtE, n_valid):
        flat = ax.gather_sum(torch.cat([
            JtJ.reshape(36), JtE, n_valid.to(torch.float32).reshape(1)]))
        return (flat[:36].reshape(6, 6), flat[36:42],
                flat[42].to(torch.int32))

    return fused_sum, ax.gather_max


def shard_cloud(mesh: Mesh, src: PointCloud, axis: str = "dp") -> PointCloud:
    """This rank's contiguous block of a cloud's points (the point count
    must divide by the axis size)."""
    sl = mesh.axis(axis).shard(src.xyz.shape[0])
    return PointCloud(src.xyz[sl].contiguous(), src.intensity[sl].contiguous(),
                      src.mask[sl].contiguous())


def sharded_scan2map(mesh: Mesh, axis: str = "dp",
                     max_iters: int = loam.MAX_ITERS):
    """(src_block, vm, init_pose) -> LoamResult, replicated on every rank.

    Each rank calls it on its own block of the scan (``shard_cloud``); the
    map and the pose are replicated."""
    reduce_fn, rmax_fn = loam_hooks(mesh.axis(axis))

    def fn(src: PointCloud, vm, init_pose: torch.Tensor) -> loam.LoamResult:
        return loam.gn_loop(src, vm, init_pose, max_iters,
                            reduce_fn=reduce_fn, rmax_reduce_fn=rmax_fn)

    return fn
