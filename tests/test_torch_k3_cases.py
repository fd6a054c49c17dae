"""K3 (``gn_loop_fused``, the whole Gauss-Newton loop in one cooperative
launch) against its plain version ``loam.gn_loop_stepwise`` on the card, at
the edges of the kernel's layout: a scan with fewer valid queries than
warps on the grid, a query count that is no multiple of a warp, every query
masked out;
on the merged map, the dense map and the sorted table both above and within
the sampled key index's budget (4096 keys, ``csrc/target_gather.h``).

The same bounds as ``test_torch_loam.py::test_fused_loop_matches_stepwise``:
the same counts (iterations, gathers, n_valid, converged), the pose within
1e-4 m and 1e-5 rad, two launches bit-identical. This file builds its scene
with the port alone (no JAX), so it runs wherever a CUDA device is; without
one every test skips.
"""

import numpy as np
import pytest
import torch

from simpleslam_tpu_torch.ops import loam as tloam
from simpleslam_tpu_torch.ops import loam_kernels as lk
from simpleslam_tpu_torch.ops import pointcloud as tpc
from simpleslam_tpu_torch.ops import voxel as tvox
from simpleslam_tpu_torch.pipeline import simulate as sim

OFFSET = (0.25, -0.15, 0.05)
INDEX_BUDGET = 4096   # tg::kIndexBudget
TARGETS = ["merged", "dense", "table", "table-within-budget"]
GRID_WARPS = 132 * 16   # K3's warps on an H100: one 16-warp block per SM
CASES = ["whole-scan", "1000-queries", "all-masked"]


@pytest.fixture(scope="module")
def card_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3 has no CPU mode")
    dev = torch.device("cuda")
    world = sim.make_world(seed=0)
    _, poses = sim.make_trajectory(10, 0.1, speed=1.5)
    rng = np.random.default_rng(0)
    s0 = sim.simulate_scan(world, sim.sensor_from_body(poses[0]), n_az=720,
                           n_el=12, rng=rng)
    sub = tpc.from_numpy(
        (s0 @ poses[0][:3, :3].T + poses[0][:3, 3]).astype(np.float32), 16384,
        dev)
    center = torch.tensor(poses[0][:3, 3].astype(np.float32), device=dev)
    ds_map = tvox.voxel_downsample(sub, 0.5, center)
    targets = {
        "merged": tvox.build_merged_dense_voxel_map(ds_map, 2.0, center,
                                                    (48, 48, 8), 24),
        "dense": tvox.build_dense_voxel_map(ds_map, 2.0, center, (48, 48, 8),
                                            24),
        "table": tvox.build_voxel_map(ds_map, 1.0, center, 32768, 8),
        "table-within-budget": tvox.build_voxel_map(ds_map, 1.0, center,
                                                    INDEX_BUDGET, 8)}
    scan = sim.simulate_scan(world, sim.sensor_from_body(poses[1]), n_az=720,
                             n_el=12, rng=rng)
    src = tpc.compact(tvox.voxel_downsample(tpc.from_numpy(scan, 16384, dev),
                                            0.5), 1024)
    return targets, src, torch.tensor(poses[1].astype(np.float32), device=dev)


def _case(src, case):
    if case == "whole-scan":
        return src
    if case == "1000-queries":
        return tpc.PointCloud(*(t[:1000].contiguous() for t in src))
    return src._replace(mask=torch.zeros_like(src.mask))


def _rot_angle(Ra, Rb):
    dR = Ra.astype(np.float64).T @ Rb.astype(np.float64)
    return 0.5 * np.linalg.norm([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                                 dR[1, 0] - dR[0, 1]])


@pytest.mark.cuda
@pytest.mark.parametrize("degen", [0.0, tloam.DEGEN_EIGEN_PER_ROW],
                         ids=["plain-solve", "degeneracy-guard"])
@pytest.mark.parametrize("which", ["on-pose", "perturbed"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("target", TARGETS)
def test_fused_loop_edges_match_stepwise(card_scene, target, case, which,
                                         degen):
    targets, src, pose = card_scene
    vm, src = targets[target], _case(src, case)
    if target == "table":
        assert vm.keys.shape[0] > INDEX_BUDGET
    if target == "table-within-budget":
        assert vm.keys.shape[0] <= INDEX_BUDGET
    if which == "perturbed":
        pose = pose.clone()
        pose[:3, 3] += torch.tensor(OFFSET, device=pose.device)
    before = lk.K3_LAUNCHES
    got = tloam.gn_loop(src, vm, pose, degen_per_row=degen)
    again = tloam.gn_loop(src, vm, pose, degen_per_row=degen)
    assert lk.K3_LAUNCHES == before + 2
    ref = tloam.gn_loop_stepwise(src, vm, pose, degen_per_row=degen)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    counts = (int(got.iters), int(got.n_gathers), int(got.n_valid),
              bool(got.converged))
    assert counts == (int(ref.iters), int(ref.n_gathers), int(ref.n_valid),
                      bool(ref.converged))
    # the scan has fewer valid queries than the grid has warps: most warps
    # select nothing
    n_valid = int(src.mask.sum())
    assert n_valid < GRID_WARPS and src.capacity % 32 == (
        8 if case == "1000-queries" else 0)
    assert (counts[2] == 0) if case == "all-masked" else counts[2] > 30
    p, q = got.pose.cpu().numpy(), ref.pose.cpu().numpy()
    assert np.linalg.norm(p[:3, 3] - q[:3, 3]) < 1e-4
    assert _rot_angle(p[:3, :3], q[:3, :3]) < 1e-5
