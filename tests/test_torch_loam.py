"""Parity: the PyTorch port's LOAM linearization and registration against
the JAX package, on the same merged voxel map (built by the JAX package and
handed over as numpy) and the same queries.

Every port variant — the explicit-candidate functions, the plain versions
of the CUDA kernels K1 (``fit_and_linearize_merged``) and K2
(``plane_normal_equations``), and K2's body compiled for the host with its
fixed-order double sums (``native.k2_host``) — is held against both
``loam.normal_equations_from_candidates`` and the Pallas TPU kernel itself
(``loam_pallas.normal_equations_t`` in interpret mode), with the tolerances
of tests/test_loam_pallas.py: J^T J within 2e-5 max|J^T J|, J^T e within
5e-4 max|J^T e| (f32 sums in another order), identical n_valid.

The small step of the fused GN kernel K3 (``csrc/gn_step.h``: the 6x6 LU
solve, the Jacobi eigensolve of the degeneracy guard, ``se3_exp``, the
compose, the motion test and the re-orthonormalization) is compiled for the
host and held against ``loam._solve`` and the torch pose update: dx within
1e-5 relative and poses within 1e-6 on a well-conditioned system, and no
further from the float64 solution than twice torch's own error on the
scene's ill-conditioned ones; a Python loop that takes its steps through
that code must reproduce ``gn_loop_stepwise``.

The candidate form (K4 ``fit_and_linearize_candidates``, plain version here)
and the GN loop are also held against the JAX package on the other two
targets: a dense map through the corner gather (C = 192) and a sorted voxel
table through the 27-cell gather (C = 216), built by the JAX package from the
same submap. Normal equations at the tolerances above; ``scan2map`` poses
within 1e-4 m and 1e-5 rad with the same converged flag and counts.

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
from simpleslam_tpu_torch import native
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
    # planes fit at this pose by K1's plain version, then K2's plain version
    # or K2's body on the host on the card's grid (132 blocks)
    planes = lk.fit_and_linearize_merged(tvm, p_map, sqrt_r, tds.mask)[3]
    if variant == "k2_plain":
        return lk.plane_normal_equations(planes, p_map, sqrt_r)
    jtj, jte, nv = native.k2_host(*(t.numpy() for t in planes),
                                  p_map.numpy(), sqrt_r.numpy(), 132)
    return torch.tensor(jtj), torch.tensor(jte), torch.tensor(nv)


def _assert_close(got, ref):
    JtJ, JtE, nv = (np.asarray(x) for x in ref)
    JtJ1, JtE1, nv1 = (x.numpy() for x in got)
    assert int(nv1) == int(nv) and int(nv) > 30
    np.testing.assert_allclose(JtJ1, JtJ, atol=2e-5 * np.abs(JtJ).max())
    np.testing.assert_allclose(JtE1, JtE, atol=5e-4 * (np.abs(JtE).max() + 1e-9))


@pytest.mark.parametrize("ref", ["jnp", "pallas"])
@pytest.mark.parametrize("which", ["on-pose", "perturbed"])
@pytest.mark.parametrize("variant", ["from_candidates", "fit_then_rows",
                                     "k1_plain", "k2_plain", "k2_host"])
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
    # the counts stay tensors on the pose's device: nothing forces a read
    for field in (out.converged, out.iters, out.n_valid, out.n_gathers):
        assert isinstance(field, torch.Tensor) and field.dim() == 0
        assert field.device == out.pose.device
    assert out.converged.dtype == torch.bool
    assert bool(out.converged) == bool(ref.converged)
    assert int(out.iters) == int(ref.iters) and int(out.iters) > 1
    assert int(out.n_gathers) == int(ref.n_gathers)
    assert int(out.n_valid) == int(ref.n_valid)
    p_j, p_t = np.asarray(ref.pose), out.pose.numpy()
    assert np.linalg.norm(p_t[:3, 3] - p_j[:3, 3]) < 1e-3
    dR = p_j[:3, :3].T @ p_t[:3, :3]
    assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 1e-3
    if degen == 0.0:  # the guard holds weak directions at the prediction
        assert np.linalg.norm(p_t[:3, 3] - pose[:3, 3]) < 0.05


# ---------------------------------------------------------------------------
# the dense (corner gather) and sorted-table targets: K4's plain version
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def other_targets(scene):
    """The scene's submap as a dense map (grid 2.0) and a sorted table (grid
    1.0, slab 8), built by the JAX package and handed over as numpy."""
    world = sim.make_world(seed=0)
    _, poses = sim.make_trajectory(10, 0.1, speed=1.5)
    s0 = sim.simulate_scan(world, sim.sensor_from_body(poses[0]), n_az=720,
                           n_el=12, rng=np.random.default_rng(0))
    sub = jpc.from_numpy(
        (s0 @ poses[0][:3, :3].T + poses[0][:3, 3]).astype(np.float32), 16384)
    center = jnp.asarray(poses[0][:3, 3].astype(np.float32))
    ds_map = jvox.voxel_downsample(sub, 0.5, center)
    dense = jvox.build_dense_voxel_map(ds_map, 2.0, center, dims=(48, 48, 8),
                                       slab_size=24)
    table = jvox.build_voxel_map(ds_map, 1.0, center, num_voxels=32768,
                                 slab_size=8)
    return {
        "dense": (dense, tvox.DenseVoxelMap.from_numpy(
            np.asarray(dense.slab), dense.counts, dense.corner, dense.grid,
            dense.dims, dense.slab_pts, "cpu")),
        "table": (table, tvox.VoxelMap.from_numpy(
            np.asarray(table.keys), np.asarray(table.slab), table.counts,
            table.origin, table.grid, "cpu")),
    }


@pytest.mark.parametrize("ref", ["jnp", "pallas", "build"])
@pytest.mark.parametrize("which", ["on-pose", "perturbed"])
@pytest.mark.parametrize("kind", ["dense", "table"])
def test_candidate_form_parity(scene, other_targets, kind, which, ref):
    """``normal_equations_from_candidates``, ``build_normal_equations`` and
    K4's plain version on gathered candidates, against the JAX functions and
    the Pallas kernel on the same candidates."""
    ds, _, tds, _, _ = scene
    jvm, tvm = other_targets[kind]
    pose_np = _pose(scene, which)
    pose = jnp.asarray(pose_np)
    cand, ok = jloam.gather_candidates(ds, jvm, pose)
    assert cand.shape[1] == {"dense": 192, "table": 216}[kind]
    if ref == "jnp":
        want = jloam.normal_equations_from_candidates(ds, cand, ok, pose)
    elif ref == "pallas":
        want = loam_pallas.normal_equations_t(
            ds, jnp.transpose(cand, (2, 1, 0)), ok.T.astype(jnp.float32), pose,
            interpret=True)
    else:
        want = jloam.build_normal_equations(ds, jvm, pose)
    tpose = torch.tensor(pose_np)
    tcand, tok = tloam.gather_candidates(tds, tvm, tpose)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ok))
    np.testing.assert_array_equal(tcand.numpy(), np.asarray(cand))
    _assert_close(tloam.normal_equations_from_candidates(tds, tcand, tok,
                                                         tpose), want)
    _assert_close(tloam.build_normal_equations(tds, tvm, tpose), want)
    p_map = tgeo.transform_points(tpose, tds.xyz)
    before = (lk.K4_LAUNCHES, lk.K4_PLAIN_CUDA_CALLS)
    k4 = lk.fit_and_linearize_candidates(tcand, tok, p_map,
                                         tloam.source_sqrt_range(tds),
                                         tds.mask)
    assert (lk.K4_LAUNCHES, lk.K4_PLAIN_CUDA_CALLS) == before  # CPU tensors
    _assert_close(k4[:3], want)
    # its plane set serves K2 on the following iterations
    _assert_close(lk.plane_normal_equations(
        k4[3], p_map, tloam.source_sqrt_range(tds)), want)


def test_gather_candidates_refuses_another_target(scene):
    _, _, tds, _, pose = scene
    with pytest.raises(TypeError, match="not a LOAM target"):
        tloam.gather_candidates(tds, object(), torch.tensor(pose))


@pytest.mark.parametrize("degen", [0.0, jloam.DEGEN_EIGEN_PER_ROW],
                         ids=["plain-solve", "degeneracy-guard"])
@pytest.mark.parametrize("kind", ["dense", "table"])
def test_scan2map_on_other_targets(scene, other_targets, kind, degen):
    """One registration against a dense and a sorted-table target, from the
    same start: same converged flag and counts as the JAX ``scan2map``, pose
    within 1e-4 m and 1e-5 rad (same candidates, f32 sums in another
    order)."""
    ds, _, tds, _, _ = scene
    jvm, tvm = other_targets[kind]
    start = _start_pose(scene)
    ref = jloam.scan2map(ds, jvm, jnp.asarray(start), degen_per_row=degen)
    before = lk.K3_PLAIN_CUDA_CALLS
    out = tloam.scan2map(tds, tvm, torch.tensor(start), degen_per_row=degen)
    assert lk.K3_PLAIN_CUDA_CALLS == before
    assert bool(out.converged) == bool(ref.converged)
    assert int(out.iters) == int(ref.iters) and int(out.iters) > 1
    assert int(out.n_gathers) == int(ref.n_gathers) >= 2
    assert int(out.n_valid) == int(ref.n_valid) > 30
    p_j, p_t = np.asarray(ref.pose), out.pose.numpy()
    assert np.linalg.norm(p_t[:3, 3] - p_j[:3, 3]) < 1e-4
    assert _rot_angle(p_j[:3, :3], p_t[:3, :3]) < 1e-5


def test_scan2map_on_an_empty_table_fails_gracefully(scene):
    """``tests/test_loam.py``'s empty-map case: no convergence, pose kept."""
    tds = scene[2]
    vm = tvox.build_voxel_map(tpc.empty(1024), 1.0, torch.zeros(3), 2048, 8)
    out = tloam.scan2map(tds, vm, torch.eye(4))
    assert not bool(out.converged) and int(out.n_valid) == 0
    np.testing.assert_allclose(out.pose.numpy(), np.eye(4), atol=1e-5)


# ---------------------------------------------------------------------------
# the fused kernel's small step (csrc/gn_step.h), compiled for the host
# ---------------------------------------------------------------------------

def _start_pose(scene):
    start = scene[4].copy()
    start[:3, 3] += np.array([0.3, -0.2, 0.0], np.float32)
    start[:3, :3] = start[:3, :3] @ np.asarray(
        tgeo.so3_exp(torch.tensor([0.0, 0.0, 0.03])))
    return start


def _scene_equations(scene, pose):
    _, _, tds, tvm, _ = scene
    p_map = tgeo.transform_points(torch.tensor(pose), tds.xyz)
    return lk.fit_and_linearize_merged(
        tvm, p_map, tloam.source_sqrt_range(tds), tds.mask)[:3]


def _torch_step(JtJ, JtE, n_valid, degen, pose, anchor, r_max):
    """One iteration of ``gn_loop_stepwise`` after its linearization."""
    enough = n_valid >= tloam.MIN_VALID_ROWS
    dx = tloam._solve(JtJ, JtE, n_valid, enough, degen)
    conv = (torch.linalg.norm(dx[:3]) <= tloam.POS_CONVERGE) & (
        torch.linalg.norm(dx[3:]) <= tloam.ROT_CONVERGE)
    pose = torch.where(conv | ~enough, pose,
                       tgeo.pose_compose(tgeo.se3_exp(dx), pose))
    dt = torch.linalg.norm(pose[:3, 3] - anchor[:3, 3])
    cos_a = (torch.trace(anchor[:3, :3].T @ pose[:3, :3]) - 1.0) * 0.5
    moved = dt + r_max * torch.arccos(torch.clamp(cos_a, -1.0, 1.0))
    return dx, pose, bool(conv), bool(enough), float(moved)


def _solve_f64(JtJ, JtE, n_valid, degen):
    """``loam._solve`` in float64: the yardstick both f32 solves are held to."""
    enough = n_valid >= tloam.MIN_VALID_ROWS
    A = JtJ.numpy().astype(np.float64) + np.eye(6) * (not enough)
    b = -JtE.numpy().astype(np.float64)
    if degen > 0:
        w, V = np.linalg.eigh(A)
        y = V.T @ b
        return V @ np.where(w > degen * n_valid * enough,
                            y / np.maximum(w, 1e-12), 0.0)
    return np.linalg.solve(A, b)


@pytest.mark.parametrize("case", ["well-conditioned", "scene", "starved",
                                  "guard", "guard-near-singular",
                                  "near-singular", "converged"])
def test_gn_step_matches_torch(scene, case):
    """The in-kernel solve against ``loam._solve``: on a well-conditioned
    system (the scene's equations, diagonally equilibrated and damped) dx agrees within
    1e-5 of |dx| and the updated pose within 1e-6. The scene's raw equations
    have a condition number near 5e5 (few rows at the offset start; rotation
    columns scale with range), where two f32 factorizations differ by more
    than that: there each is held to the float64 solution, the in-kernel one
    to no more than twice torch's error or a thousandth of the worst-case
    bound eps * cond. Same flags; the motion test within
    1e-3 m (arccos near 1 in f32)."""
    pose = _start_pose(scene)
    JtJ, JtE, n_valid = _scene_equations(scene, pose)
    degen = tloam.DEGEN_EIGEN_PER_ROW if case.startswith("guard") else 0.0
    if case == "well-conditioned":
        d = 1.0 / torch.sqrt(torch.diagonal(JtJ))
        JtJ = JtJ * d[:, None] * d[None, :] + 0.05 * torch.eye(6)
        JtE = JtE * d * 0.1
        assert torch.linalg.cond(JtJ) < 200
    if case == "starved":
        n_valid = torch.tensor(3, dtype=torch.int32)
    if case.endswith("near-singular"):
        # squash one direction of the normal equations: a corridor
        w, V = torch.linalg.eigh(JtJ)
        w = w.clone()
        w[0] = w[-1] * 1e-6
        JtJ = (V * w) @ V.T
        JtJ = 0.5 * (JtJ + JtJ.T)
    if case == "converged":
        JtE = JtE * 1e-4
    anchor = scene[4]
    got = native.gn_step(JtJ.numpy(), JtE.numpy(), int(n_valid), degen, pose,
                         anchor, 42.0)
    ref = _torch_step(JtJ, JtE, n_valid, degen, torch.tensor(pose),
                      torch.tensor(anchor), torch.tensor(42.0))
    truth = _solve_f64(JtJ, JtE, int(n_valid), degen)
    scale = np.linalg.norm(truth)
    e_got = np.abs(got[0] - truth).max()
    e_ref = np.abs(ref[0].numpy() - truth).max()
    print(f"{case}: |dx| {scale:.3e}, error of gn_step.h {e_got:.3e}, of "
          f"torch {e_ref:.3e}")
    cond = float(torch.linalg.cond(JtJ)) if case != "starved" else 1.0
    eps = float(np.finfo(np.float32).eps)
    assert e_got <= max(2.0 * e_ref, (1e-5 + 1e-3 * eps * cond) * scale)
    if case == "well-conditioned":
        assert np.abs(got[0] - ref[0].numpy()).max() <= 1e-5 * scale
    np.testing.assert_allclose(got[1], ref[1].numpy(),
                               atol=1e-6 + 2.0 * (e_got + e_ref))
    assert got[2:4] == ref[2:4]
    assert got[2] == (case == "converged")
    assert got[3] == (case != "starved")
    assert abs(got[4] - ref[4]) < 1e-3 + 50.0 * (e_got + e_ref)
    if case in ("starved", "converged"):   # the loop stops before the update
        np.testing.assert_array_equal(got[1], pose)


@pytest.mark.parametrize("case", ["scene", "near-singular"])
def test_guarded_solve_is_the_float64_step(scene, case):
    """With the degeneracy guard the stepwise loop takes its eigenbasis in
    float64, so its step is the float64 step rounded once, within 1e-6 of
    |dx|, on the scene's ill-conditioned system and on one squashed to a
    corridor. An f32 eigh keeps the weak eigenvalues only to eps * |JtJ|
    and misses that step by about 5e-5 of |dx| here (1.5e-05 m of 0.31 m);
    K3's Jacobi sweep (``csrc/gn_step.h``), which it is held against on the
    card, missed it by 5.2e-08 m at most on the streamed path's systems
    that ``tools/gn_loop_gap.py --guard`` traces."""
    pose = _start_pose(scene)
    JtJ, JtE, n_valid = _scene_equations(scene, pose)
    if case == "near-singular":
        w, V = torch.linalg.eigh(JtJ.double())
        w = w.clone()
        w[0] = w[-1] * 1e-6
        JtJ = ((V * w) @ V.T).float()
        JtJ = 0.5 * (JtJ + JtJ.T)
    degen = tloam.DEGEN_EIGEN_PER_ROW
    dx = tloam._solve(JtJ, JtE, n_valid, n_valid >= tloam.MIN_VALID_ROWS,
                      degen)
    assert dx.dtype == torch.float32
    truth = _solve_f64(JtJ, JtE, int(n_valid), degen)
    assert np.abs(dx.numpy() - truth).max() <= 1e-6 * np.linalg.norm(truth)


def test_gn_step_zero_pivot_is_non_finite_not_an_error():
    """A singular system gives a non-finite step (the streamed batch's NaN
    guard takes it), where ``torch.linalg.solve`` raises."""
    dx, pose, conv, enough, _ = native.gn_step(
        np.zeros((6, 6), np.float32), np.ones(6, np.float32), 10, 0.0,
        np.eye(4), np.eye(4), 1.0)
    assert not np.isfinite(dx).all() and not conv and enough
    assert not np.isfinite(pose).all()
    with pytest.raises(RuntimeError):
        torch.linalg.solve(torch.zeros(6, 6), torch.ones(6))


def test_jacobi_eigensolve_matches_eigh(scene):
    JtJ = _scene_equations(scene, scene[4])[0].numpy()
    w, V = native.jacobi_eig6(JtJ)
    order = np.argsort(w)
    w_ref = np.linalg.eigvalsh(JtJ.astype(np.float64))
    np.testing.assert_allclose(w[order], w_ref, rtol=1e-5,
                               atol=1e-6 * w_ref[-1])
    np.testing.assert_allclose(V.T @ V, np.eye(6), atol=1e-5)
    np.testing.assert_allclose((V * w) @ V.T, JtJ,
                               atol=2e-6 * np.abs(JtJ).max())


def test_gn_finish_matches_reorthonormalize(scene):
    pose = _start_pose(scene)
    pose[:3, :3] += np.float32(1e-3) * np.arange(9, dtype=np.float32
                                                 ).reshape(3, 3)
    for flip in (np.eye(3), np.diag([1.0, -1.0, -1.0]),
                 np.diag([-1.0, 1.0, -1.0]), np.diag([-1.0, -1.0, 1.0])):
        # rotations by pi about each axis reach every Shepperd branch
        p = pose.copy()
        p[:3, :3] = (p[:3, :3] @ flip).astype(np.float32)
        ref = tgeo.reorthonormalize(torch.tensor(p)).numpy()
        np.testing.assert_allclose(native.gn_finish(p), ref, atol=1e-6)


@pytest.mark.parametrize("degen", [0.0, tloam.DEGEN_EIGEN_PER_ROW],
                         ids=["plain-solve", "degeneracy-guard"])
def test_gn_step_drives_the_loop(scene, degen):
    """The fused kernel's control flow in Python: K1/K2's plain versions for
    the linearization, ``csrc/gn_step.h`` for everything between. Same
    iterations, gathers and n_valid as ``gn_loop_stepwise``, pose within
    1e-4 (the two f32 solves differ by a few 1e-5 of |dx| per step on this
    ill-conditioned scene)."""
    _, _, tds, tvm, _ = scene
    start = _start_pose(scene)
    ref = tloam.gn_loop_stepwise(tds, tvm, torch.tensor(start),
                                 degen_per_row=degen)
    sqrt_r = tloam.source_sqrt_range(tds)
    r_max = float(torch.linalg.norm(tds.xyz, dim=-1)[tds.mask].max())
    pose, anchor = start.copy(), start.copy()
    iters = gathers = 0
    refit, planes = True, None
    while True:
        p_map = tgeo.transform_points(torch.tensor(pose), tds.xyz)
        if refit:
            JtJ, JtE, nv, planes = lk.fit_and_linearize_merged(
                tvm, p_map, sqrt_r, tds.mask)
            gathers += 1
        else:
            JtJ, JtE, nv = lk.plane_normal_equations(planes, p_map, sqrt_r)
        _, pose, conv, enough, moved = native.gn_step(
            JtJ.numpy(), JtE.numpy(), int(nv), degen, pose, anchor, r_max)
        iters += 1
        if (conv and enough) or not enough or iters >= tloam.MAX_ITERS:
            break
        refit = moved > tloam.REGATHER_DIST
        if refit:
            anchor = pose.copy()
    assert (iters, gathers, int(nv)) == (int(ref.iters), int(ref.n_gathers),
                                         int(ref.n_valid))
    assert bool(ref.converged) == (conv and enough)
    assert iters > 1 and gathers > 1
    np.testing.assert_allclose(native.gn_finish(pose), ref.pose.numpy(),
                               atol=1e-4)


def test_gn_loop_on_cpu_is_the_stepwise_loop(scene):
    """``gn_loop`` takes K3's plain version for CPU tensors, and counts no
    plain call "on CUDA"; K3's wrapper itself refuses a CPU tensor."""
    _, _, tds, tvm, pose = scene
    before = (lk.K3_LAUNCHES, lk.K3_PLAIN_CUDA_CALLS)
    a = tloam.gn_loop(tds, tvm, torch.tensor(pose))
    b = tloam.gn_loop_stepwise(tds, tvm, torch.tensor(pose))
    assert torch.equal(a.pose, b.pose) and int(a.iters) == int(b.iters)
    assert (lk.K3_LAUNCHES, lk.K3_PLAIN_CUDA_CALLS) == before
    with pytest.raises(ValueError, match="unsupported device"):
        lk.gn_loop_fused(tds.xyz, tds.mask, tvm, torch.tensor(pose), 8, 0.0)


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


def _hand_launches(fn) -> int:
    """Hand-kernel launches of one call of ``fn`` on the card, as
    ``chip_smoke.py``'s ``call_device`` counts them (PyTorch's own fills and
    copies apart); the script is loaded by path from the repository root."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    t = cs.call_device(fn)
    assert t is not None, "the profiler saw no hand kernel"
    return t.launches


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all", "Q=5", "Q=131", "all-masked"])
def test_k1_k2_one_launch_each(cuda_scene, case):
    """K1 and K2 are one launch per wrapper call (no second pass over the
    block partials) on the card's grid of one block per SM, also with fewer
    queries than blocks and with every query masked out; two calls
    bit-identical; n_valid and the plane gates equal to the plain versions',
    the sums within the tolerances."""
    vm, src, pose = cuda_scene
    p_map = tgeo.transform_points(pose, src.xyz)
    sqrt_r = tloam.source_sqrt_range(src)
    mask = src.mask
    if case.startswith("Q="):
        n = int(case[2:])
        p_map, sqrt_r, mask = p_map[:n], sqrt_r[:n], mask[:n]
    elif case == "all-masked":
        mask = torch.zeros_like(mask)
    k1 = lk.fit_and_linearize_merged(vm, p_map, sqrt_r, mask)
    again = lk.fit_and_linearize_merged(vm, p_map, sqrt_r, mask)
    assert all(torch.equal(a, b) for a, b in zip((*k1[:3], *k1[3]),
                                                 (*again[:3], *again[3])))
    p1 = lk.fit_and_linearize_merged_plain(vm, p_map, sqrt_r, mask)
    assert torch.equal(k1[3].ok, p1[3].ok)
    k2 = lk.plane_normal_equations(k1[3], p_map, sqrt_r)
    assert all(torch.equal(a, b) for a, b in zip(
        k2, lk.plane_normal_equations(k1[3], p_map, sqrt_r)))
    p2 = lk.plane_normal_equations_plain(k1[3], p_map, sqrt_r)
    for got, ref in ((k1[:3], p1[:3]), (k2, p2)):
        JtJ, JtE = ref[0].cpu().numpy(), ref[1].cpu().numpy()
        assert int(got[2]) == int(ref[2])
        np.testing.assert_allclose(got[0].cpu().numpy(), JtJ,
                                   atol=2e-5 * np.abs(JtJ).max())
        np.testing.assert_allclose(got[1].cpu().numpy(), JtE,
                                   atol=5e-4 * np.abs(JtE).max())
    if case == "all-masked":
        assert int(k1[2]) == 0 and not k1[3].centroid.any()
    assert _hand_launches(lambda: lk.fit_and_linearize_merged(
        vm, p_map, sqrt_r, mask)) == 1
    assert _hand_launches(lambda: lk.plane_normal_equations(
        k1[3], p_map, sqrt_r)) == 1


def _to(vm, dev):
    return type(vm)(*(t.to(dev) if isinstance(t, torch.Tensor) else t
                      for t in vm))


def _assert_k4_matches_plain(cand, ok, p_map, sqrt_r, mask):
    """K4 against its plain version: n_valid and the plane set
    bit-identical, the sums at the op tolerances, two launches
    bit-identical."""
    k4 = lk.fit_and_linearize_candidates(cand, ok, p_map, sqrt_r, mask)
    p4 = lk.fit_and_linearize_candidates_plain(cand, ok, p_map, sqrt_r, mask)
    assert int(k4[2]) == int(p4[2])
    for a, b in zip(k4[3], p4[3]):
        assert torch.equal(a, b)
    JtJ, JtE = p4[0].cpu().numpy(), p4[1].cpu().numpy()
    np.testing.assert_allclose(k4[0].cpu().numpy(), JtJ,
                               atol=2e-5 * np.abs(JtJ).max())
    np.testing.assert_allclose(k4[1].cpu().numpy(), JtE,
                               atol=5e-4 * (np.abs(JtE).max() + 1e-9))
    again = lk.fit_and_linearize_candidates(cand, ok, p_map, sqrt_r, mask)
    assert all(torch.equal(a, b) for a, b in zip(
        (*k4[:3], *k4[3]), (*again[:3], *again[3])))
    return int(p4[2])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "table"])
def test_candidate_kernel_matches_plain(cuda_scene, other_targets, kind):
    """K4 against its plain version on the corner gather's and the sorted
    table's candidates; two launches bit-identical; its planes feed K2."""
    _, src, pose = cuda_scene
    dev = pose.device
    tvm = _to(other_targets[kind][1], dev)
    pose = pose.clone()
    pose[:3, 3] += torch.tensor(OFFSET, device=dev)
    p_map = tgeo.transform_points(pose, src.xyz)
    sqrt_r = tloam.source_sqrt_range(src)
    cand, ok = tloam.gather_candidates_at(tvm, p_map, src.mask)
    assert _assert_k4_matches_plain(cand, ok, p_map, sqrt_r, src.mask) > 30
    wide = torch.zeros((8, 257, 3), device=dev)
    with pytest.raises(ValueError, match="candidates per query"):
        lk.fit_and_linearize_candidates(
            wide, wide[..., 0].bool(), p_map[:8].contiguous(), sqrt_r[:8],
            src.mask[:8])


def _planar_candidates(n_cand: int, flags: str, n_q: int = 600):
    """Candidates near a plane through each of ``n_q`` queries, made with
    numpy from a seed: (cand (Q, C, 3), flags (Q, C), queries (Q, 3), mask
    (Q,)). ``flags``: "random" (a masked-out query's flags off, as every
    gather leaves them), "masked-set" (its flags set as well), "all-off",
    or "all-masked" (every query masked out, every flag off)."""
    rng = np.random.default_rng(n_cand)
    q = rng.uniform(-20, 20, (n_q, 3)).astype(np.float32)
    off = np.concatenate([rng.uniform(-0.7, 0.7, (n_q, n_cand, 2)),
                          rng.uniform(0, 0.002, (n_q, n_cand, 1))], axis=-1)
    mask = rng.random(n_q) > 0.1
    ok = rng.random((n_q, n_cand)) > 0.3
    if flags == "random":
        ok &= mask[:, None]
    elif flags != "masked-set":
        ok[:] = False
    if flags == "all-masked":
        mask[:] = False
    return (q[:, None, :] + off).astype(np.float32), ok, q, mask


@pytest.mark.cuda
@pytest.mark.parametrize("flags", ["random", "masked-set", "all-off",
                                   "all-masked"])
@pytest.mark.parametrize("n_cand", [1, 7, 192, 216, 256])
def test_candidate_kernel_widths(cuda_scene, n_cand, flags):
    """K4 at every copy path it has (1-byte flags and 4-byte coordinates at
    C = 1 and 7, 4-byte flags at 216, 16-byte chunks at 192 and 256), with
    set flags on masked-out queries (which neither side reads), every flag
    off, and every query masked out."""
    dev = cuda_scene[2].device
    cand, ok, q, mask = _planar_candidates(n_cand, flags)
    p_map = torch.tensor(q, device=dev)
    sqrt_r = torch.sqrt(torch.clamp(torch.linalg.norm(p_map, dim=1), min=1e-6))
    n_valid = _assert_k4_matches_plain(
        torch.tensor(cand, device=dev), torch.tensor(ok, device=dev), p_map,
        sqrt_r, torch.tensor(mask, device=dev))
    if flags in ("random", "masked-set") and n_cand >= 32:
        assert n_valid > 100


@pytest.mark.parametrize("n_cand", [7, 192])
def test_candidate_plain_ignores_masked_flags(n_cand):
    """K4's plain version (what its wrapper runs on CPU tensors) gives a
    masked-out query the zero plane whatever its flags hold, as the kernel
    does, and the same sums as with those flags cleared."""
    cand, ok, q, mask = _planar_candidates(n_cand, "masked-set")
    p_map = torch.tensor(q)
    sqrt_r = torch.sqrt(torch.clamp(torch.linalg.norm(p_map, dim=1), min=1e-6))
    args = (torch.tensor(cand), p_map, sqrt_r, torch.tensor(mask))
    got = lk.fit_and_linearize_candidates(args[0], torch.tensor(ok), *args[1:])
    ref = lk.fit_and_linearize_candidates(
        args[0], torch.tensor(ok & mask[:, None]), *args[1:])
    assert (ok & ~mask[:, None]).any()
    for a, b in zip((*got[:3], *got[3]), (*ref[:3], *ref[3])):
        assert torch.equal(a, b)
    planes = got[3]
    assert not planes.ok[~torch.tensor(mask)].any()
    assert not planes.centroid[~torch.tensor(mask)].any()
    assert int(got[2]) > 100


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
    with pytest.raises(ValueError, match="unsupported device"):
        lk.fit_and_linearize_candidates(
            torch.empty((p_map.shape[0], 192, 3), device="meta"),
            torch.empty((p_map.shape[0], 192), device="meta").bool(), meta,
            meta[:, 0], meta[:, 0].bool())


def test_fused_loop_refuses_what_the_kernel_cannot_take(scene,
                                                        other_targets):
    """K3 takes the three LOAM targets up to 256 candidates per query and a
    table with a row; it refuses anything else before it looks at the
    device, and a CPU tensor after (its plain version is the stepwise
    loop)."""
    _, _, tds, tvm, pose = scene
    start = torch.tensor(pose)
    for vm in (tvm, other_targets["dense"][1], other_targets["table"][1]):
        with pytest.raises(ValueError, match="unsupported device"):
            lk.gn_loop_fused(tds.xyz, tds.mask, vm, start, 8, 0.0)
    with pytest.raises(TypeError, match="not a LOAM target"):
        lk.gn_loop_fused(tds.xyz, tds.mask, object(), start, 8, 0.0)
    table = other_targets["table"][1]
    empty = tvox.VoxelMap(table.keys[:0], table.slab[:0], table.counts[:0],
                          table.origin, table.grid)
    with pytest.raises(ValueError, match="no row"):
        lk.gn_loop_fused(tds.xyz, tds.mask, empty, start, 8, 0.0)
    wide = tvox.VoxelMap(table.keys, torch.zeros((table.keys.shape[0], 10, 3)),
                         table.counts, table.origin, table.grid)
    with pytest.raises(ValueError, match="270 candidates per query"):
        lk.gn_loop_fused(tds.xyz, tds.mask, wide, start, 8, 0.0)
    dense = other_targets["dense"][1]
    wide = dense._replace(slab_pts=33)
    with pytest.raises(ValueError, match="264 candidates per query"):
        lk.gn_loop_fused(tds.xyz, tds.mask, wide, start, 8, 0.0)


def _rot_angle(Ra, Rb):
    dR = Ra.astype(np.float64).T @ Rb.astype(np.float64)
    return 0.5 * np.linalg.norm([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                                 dR[1, 0] - dR[0, 1]])


@pytest.mark.cuda
@pytest.mark.parametrize("degen", [0.0, tloam.DEGEN_EIGEN_PER_ROW],
                         ids=["plain-solve", "degeneracy-guard"])
@pytest.mark.parametrize("which", ["on-pose", "perturbed"])
@pytest.mark.parametrize("target", ["merged", "dense", "table"])
def test_fused_loop_matches_stepwise(cuda_scene, other_targets, target,
                                     which, degen):
    """K3 against its plain version on the card, on each of the three
    targets: the same counts, the pose within 1e-4 m and 1e-5 rad, and
    bit-identical across two launches; the stepwise loop is counted as a
    plain call on every target."""
    vm, src, pose = cuda_scene
    if target != "merged":
        vm = _to(other_targets[target][1], pose.device)
    if which == "perturbed":
        pose = pose.clone()
        pose[:3, 3] += torch.tensor(OFFSET, device=pose.device)
    before = (lk.K3_LAUNCHES, lk.K3_PLAIN_CUDA_CALLS, lk.K4_LAUNCHES)
    got = tloam.gn_loop(src, vm, pose, degen_per_row=degen)
    again = tloam.gn_loop(src, vm, pose, degen_per_row=degen)
    assert (lk.K3_LAUNCHES, lk.K3_PLAIN_CUDA_CALLS, lk.K4_LAUNCHES) == (
        before[0] + 2, before[1], before[2])
    ref = tloam.gn_loop_stepwise(src, vm, pose, degen_per_row=degen)
    assert lk.K3_PLAIN_CUDA_CALLS == before[1] + 1
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert (int(got.iters), int(got.n_gathers), int(got.n_valid),
            bool(got.converged)) == (int(ref.iters), int(ref.n_gathers),
                                     int(ref.n_valid), bool(ref.converged))
    p, q = got.pose.cpu().numpy(), ref.pose.cpu().numpy()
    assert np.linalg.norm(p[:3, 3] - q[:3, 3]) < 1e-4
    assert _rot_angle(p[:3, :3], q[:3, :3]) < 1e-5
