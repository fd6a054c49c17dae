"""Parity: the PyTorch port's LOAM linearization and registration against
the JAX package, on the same merged voxel map (built by the JAX package and
handed over as numpy) and the same queries.

Every port variant — the explicit-candidate functions, and the plain
versions of the CUDA kernels K1 (``fit_and_linearize_merged``) and K2
(``plane_normal_equations``) — is held against both
``loam.normal_equations_from_candidates`` and the Pallas TPU kernel itself
(``loam_pallas.normal_equations_t`` in interpret mode), with the tolerances
of tests/test_loam_pallas.py: J^T J within 2e-5 max|J^T J|, J^T e within
5e-4 max|J^T e| (f32 sums in another order), identical n_valid.

The kernels themselves only run on a CUDA device: those tests carry the
``cuda`` marker and skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleslam_tpu.ops import loam as jloam
from simpleslam_tpu.ops import loam_pallas
from simpleslam_tpu.ops import pointcloud as jpc
from simpleslam_tpu.ops import voxel as jvox
from simpleslam_tpu.pipeline import simulate as sim
from simpleslam_tpu_torch.ops import geometry as tgeo
from simpleslam_tpu_torch.ops import loam as tloam
from simpleslam_tpu_torch.ops import loam_kernels as lk
from simpleslam_tpu_torch.ops import pointcloud as tpc
from simpleslam_tpu_torch.ops import voxel as tvox

OFFSET = np.array([0.25, -0.15, 0.05], np.float32)


@pytest.fixture(scope="module")
def scene():
    world = sim.make_world(seed=0)
    _, poses = sim.make_trajectory(10, 0.1, speed=1.5)
    rng = np.random.default_rng(0)
    s0 = sim.simulate_scan(world, sim.sensor_from_body(poses[0]),
                           n_az=720, n_el=12, rng=rng)
    sub = jpc.from_numpy(
        (s0 @ poses[0][:3, :3].T + poses[0][:3, 3]).astype(np.float32), 16384)
    center = jnp.asarray(poses[0][:3, 3].astype(np.float32))
    vm = jvox.build_merged_dense_voxel_map(
        jvox.voxel_downsample(sub, 0.5, center), 2.0, center, dims=(48, 48, 8),
        slab_size=24)
    scan = sim.simulate_scan(world, sim.sensor_from_body(poses[1]),
                             n_az=720, n_el=12, rng=rng)
    ds = jpc.compact(jvox.voxel_downsample(jpc.from_numpy(scan, 16384), 0.5),
                     1024)
    tvm = tvox.MergedDenseVoxelMap.from_numpy(
        np.asarray(vm.rows), vm.scale, vm.corner, vm.grid, vm.dims,
        vm.slab_pts, "cpu")
    tds = tpc.from_arrays(np.asarray(ds.xyz), np.asarray(ds.intensity),
                          np.asarray(ds.mask), "cpu")
    return ds, vm, tds, tvm, poses[1].astype(np.float32)


def _pose(scene, which):
    pose = scene[4].copy()
    if which == "perturbed":
        pose[:3, 3] += OFFSET
    return pose


@pytest.fixture(scope="module")
def references(scene):
    """JAX normal equations, both ways, at the on-pose and perturbed poses."""
    ds, vm = scene[:2]
    out = {}
    for which in ("on-pose", "perturbed"):
        pose = jnp.asarray(_pose(scene, which))
        cand, ok = jloam.gather_candidates(ds, vm, pose)
        out[which, "jnp"] = jloam.normal_equations_from_candidates(
            ds, cand, ok, pose)
        out[which, "pallas"] = loam_pallas.normal_equations_t(
            ds, jnp.transpose(cand, (2, 1, 0)), ok.T.astype(jnp.float32), pose,
            interpret=True)
    return out


def _port(scene, variant, which):
    _, _, tds, tvm, _ = scene
    pose = torch.tensor(_pose(scene, which))
    p_map = tgeo.transform_points(pose, tds.xyz)
    sqrt_r = tloam.source_sqrt_range(tds)
    if variant == "from_candidates":
        cand, ok = tloam.gather_candidates(tds, tvm, pose)
        return tloam.normal_equations_from_candidates(tds, cand, ok, pose)
    if variant == "fit_then_rows":
        cand, ok = tloam.gather_candidates(tds, tvm, pose)
        planes = tloam.fit_planes(tds, cand, ok, pose)
        return tloam.plane_normal_equations(tds, planes, pose)
    if variant == "k1_plain":
        return lk.fit_and_linearize_merged(tvm, p_map, sqrt_r, tds.mask)[:3]
    # k2_plain: planes fit at this pose by K1's plain version, then K2's
    planes = lk.fit_and_linearize_merged(tvm, p_map, sqrt_r, tds.mask)[3]
    return lk.plane_normal_equations(planes, p_map, sqrt_r)


def _assert_close(got, ref):
    JtJ, JtE, nv = (np.asarray(x) for x in ref)
    JtJ1, JtE1, nv1 = (x.numpy() for x in got)
    assert int(nv1) == int(nv) and int(nv) > 30
    np.testing.assert_allclose(JtJ1, JtJ, atol=2e-5 * np.abs(JtJ).max())
    np.testing.assert_allclose(JtE1, JtE, atol=5e-4 * (np.abs(JtE).max() + 1e-9))


@pytest.mark.parametrize("ref", ["jnp", "pallas"])
@pytest.mark.parametrize("which", ["on-pose", "perturbed"])
@pytest.mark.parametrize("variant", ["from_candidates", "fit_then_rows",
                                     "k1_plain", "k2_plain"])
def test_normal_equations_parity(scene, references, variant, which, ref):
    _assert_close(_port(scene, variant, which), references[which, ref])


def test_fit_planes_parity(scene):
    ds, vm, tds, tvm, pose = scene
    cand, ok = jloam.gather_candidates(ds, vm, jnp.asarray(pose))
    ref = jloam.fit_planes(ds, cand, ok, jnp.asarray(pose))
    tcand, tok = tloam.gather_candidates(tds, tvm, torch.tensor(pose))
    out = tloam.fit_planes(tds, tcand, tok, torch.tensor(pose))
    ok_j = np.asarray(ref.ok)
    np.testing.assert_array_equal(out.ok.numpy(), ok_j)
    assert ok_j.sum() > 30
    np.testing.assert_allclose(out.centroid.numpy()[ok_j],
                               np.asarray(ref.centroid)[ok_j], atol=2e-5)
    # a plane's normal is defined up to sign; both packages pick the same
    np.testing.assert_allclose(out.normal.numpy()[ok_j],
                               np.asarray(ref.normal)[ok_j], atol=1e-4)


def test_frozen_planes_at_another_pose(scene):
    """K2's plain version: planes fit at the on-pose, rows at a moved pose
    (one GN iteration between refreshes)."""
    ds, vm, tds, tvm, pose = scene
    moved = _pose(scene, "perturbed")
    cand, ok = jloam.gather_candidates(ds, vm, jnp.asarray(pose))
    planes = jloam.fit_planes(ds, cand, ok, jnp.asarray(pose))
    ref = jloam.plane_normal_equations(ds, planes, jnp.asarray(moved))
    t_planes = lk.fit_and_linearize_merged(
        tvm, tgeo.transform_points(torch.tensor(pose), tds.xyz),
        tloam.source_sqrt_range(tds), tds.mask)[3]
    got = lk.plane_normal_equations(
        t_planes, tgeo.transform_points(torch.tensor(moved), tds.xyz),
        tloam.source_sqrt_range(tds))
    _assert_close(got, ref)


@pytest.mark.parametrize("degen", [0.0, jloam.DEGEN_EIGEN_PER_ROW],
                         ids=["plain-solve", "degeneracy-guard"])
def test_scan2map_parity(scene, degen):
    """One registration from the same map and start pose: same converged
    flag and iteration count, poses within 1e-3 m and 1e-3 rad."""
    ds, vm, tds, tvm, pose = scene
    start = pose.copy()
    start[:3, 3] += np.array([0.3, -0.2, 0.0], np.float32)
    start[:3, :3] = start[:3, :3] @ np.asarray(
        tgeo.so3_exp(torch.tensor([0.0, 0.0, 0.03])))
    ref = jloam.scan2map(ds, vm, jnp.asarray(start), degen_per_row=degen)
    out = tloam.scan2map(tds, tvm, torch.tensor(start), degen_per_row=degen)
    assert out.converged == bool(ref.converged)
    assert out.iters == int(ref.iters) and out.iters > 1
    assert out.n_gathers == int(ref.n_gathers)
    p_j, p_t = np.asarray(ref.pose), out.pose.numpy()
    assert np.linalg.norm(p_t[:3, 3] - p_j[:3, 3]) < 1e-3
    dR = p_j[:3, :3].T @ p_t[:3, :3]
    assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 1e-3
    if degen == 0.0:  # the guard holds weak directions at the prediction
        assert np.linalg.norm(p_t[:3, 3] - pose[:3, 3]) < 0.05


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (need the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_scene(scene):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _, _, tds, tvm, pose = scene
    dev = torch.device("cuda")
    vm = tvox.MergedDenseVoxelMap(tvm.rows.to(dev), tvm.scale.to(dev),
                                  tvm.corner.to(dev), tvm.grid.to(dev),
                                  tvm.dims, tvm.slab_pts)
    src = tpc.PointCloud(*(t.to(dev) for t in tds))
    return vm, src, torch.tensor(pose, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["on-pose", "perturbed"])
def test_kernels_match_plain(cuda_scene, which):
    vm, src, pose = cuda_scene
    if which == "perturbed":
        pose = pose.clone()
        pose[:3, 3] += torch.tensor(OFFSET, device=pose.device)
    p_map = tgeo.transform_points(pose, src.xyz)
    sqrt_r = tloam.source_sqrt_range(src)
    k1 = lk.fit_and_linearize_merged(vm, p_map, sqrt_r, src.mask)
    p1 = lk.fit_and_linearize_merged_plain(vm, p_map, sqrt_r, src.mask)
    _assert_close([t.cpu() for t in k1[:3]], [t.cpu() for t in p1[:3]])
    assert torch.equal(k1[3].ok, p1[3].ok)
    again = lk.fit_and_linearize_merged(vm, p_map, sqrt_r, src.mask)
    assert all(torch.equal(a, b) for a, b in zip(k1[:3], again[:3]))
    k2 = lk.plane_normal_equations(k1[3], p_map, sqrt_r)
    p2 = lk.plane_normal_equations_plain(k1[3], p_map, sqrt_r)
    _assert_close([t.cpu() for t in k2], [t.cpu() for t in p2])


def test_wrappers_refuse_bad_inputs(scene):
    """A wrapper routes CPU tensors to the plain version and refuses a device
    it has no path for, never falling back."""
    _, _, tds, tvm, pose = scene
    p_map = tgeo.transform_points(torch.tensor(pose), tds.xyz)
    before = (lk.K1_LAUNCHES, lk.K1_PLAIN_CUDA_CALLS)
    lk.fit_and_linearize_merged(tvm, p_map, tloam.source_sqrt_range(tds),
                                tds.mask)
    assert (lk.K1_LAUNCHES, lk.K1_PLAIN_CUDA_CALLS) == before
    meta = torch.empty((p_map.shape[0], 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lk.fit_and_linearize_merged(tvm, meta, meta[:, 0], meta[:, 0].bool())
