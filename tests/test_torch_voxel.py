"""Parity: the PyTorch port's voxel ops against the JAX package on the same
simulated clouds (numpy, handed to both).

Measured on these fixtures, with the tolerance each test allows:
- ``voxel_downsample``: same mask and order; centroids bit-identical (both
  sum each voxel's points in sorted order); allowed 1e-5 m.
- ``build_merged_dense_voxel_map``: int16 rows identical. f32 division
  could round a count differently; the measured share of +-1 entries is 0,
  and that is what is asserted.
- ``gather_neighbors_merged``: identical (both dequantize with one fused
  multiply-add).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleslam_tpu.ops import pointcloud as jpc
from simpleslam_tpu.ops import voxel as jvox
from simpleslam_tpu.pipeline import simulate as sim
from simpleslam_tpu_torch.ops import pointcloud as tpc
from simpleslam_tpu_torch.ops import voxel as tvox


def _to_torch(pc):
    return tpc.from_arrays(np.asarray(pc.xyz), np.asarray(pc.intensity),
                           np.asarray(pc.mask), "cpu")


@pytest.fixture(scope="module")
def clouds():
    world = sim.make_world(seed=0)
    _, poses = sim.make_trajectory(20, 0.1, speed=1.5)
    rng = np.random.default_rng(0)
    scans = [sim.simulate_scan(world, sim.sensor_from_body(poses[i]),
                               n_az=720, n_el=12, rng=rng) for i in (0, 10)]
    sub = np.concatenate([s @ poses[i][:3, :3].T + poses[i][:3, 3]
                          for s, i in zip(scans, (0, 10))]).astype(np.float32)
    # intensities make the first-point rule observable
    inten = rng.uniform(0, 100, len(sub)).astype(np.float32)
    return jpc.from_numpy(sub, 32768, intensity=inten), poses[5][:3, 3]


@pytest.mark.parametrize("grid,origin", [(0.5, None), (0.5, "center"),
                                         (2.0, "center")])
def test_voxel_downsample(clouds, grid, origin):
    pc, center = clouds
    o_j = None if origin is None else jnp.asarray(center.astype(np.float32))
    o_t = None if origin is None else torch.tensor(center.astype(np.float32))
    ref = jvox.voxel_downsample(pc, grid, o_j)
    out = tvox.voxel_downsample(_to_torch(pc), grid, o_t)
    mask = np.asarray(ref.mask)
    np.testing.assert_array_equal(out.mask.numpy(), mask)
    assert mask.sum() > 500
    np.testing.assert_allclose(out.xyz.numpy()[mask], np.asarray(ref.xyz)[mask],
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(out.intensity.numpy()[mask],
                                  np.asarray(ref.intensity)[mask])


def test_compact_truncates_the_same_points(clouds):
    pc, _ = clouds
    ref = jpc.compact(jvox.voxel_downsample(pc, 0.5), 1024)
    out = tpc.compact(tvox.voxel_downsample(_to_torch(pc), 0.5), 1024)
    assert int(np.asarray(pc.mask).sum()) > 1024
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_allclose(out.xyz.numpy(), np.asarray(ref.xyz), atol=1e-5,
                               rtol=0)


@pytest.fixture(scope="module")
def merged(clouds):
    pc, center = clouds
    ds = jvox.voxel_downsample(pc, 0.5, jnp.asarray(center.astype(np.float32)))
    c = center.astype(np.float32)
    ref = jvox.build_merged_dense_voxel_map(ds, 2.0, jnp.asarray(c),
                                            dims=(48, 48, 8), slab_size=24)
    out = tvox.build_merged_dense_voxel_map(_to_torch(ds), 2.0,
                                            torch.tensor(c), (48, 48, 8), 24)
    return ds, ref, out


def test_build_dense_voxel_map(clouds):
    pc, center = clouds
    c = center.astype(np.float32)
    ref = jvox.build_dense_voxel_map(pc, 2.0, jnp.asarray(c), dims=(24, 24, 4),
                                     slab_size=24, lane_quantum=1)
    out = tvox.build_dense_voxel_map(_to_torch(pc), 2.0, torch.tensor(c),
                                     (24, 24, 4), 24)
    np.testing.assert_array_equal(out.slab.numpy(), np.asarray(ref.slab))
    np.testing.assert_array_equal(out.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(out.corner.numpy(), np.asarray(ref.corner))


def test_build_merged_dense_voxel_map(merged):
    _, ref, out = merged
    rows_j, rows_t = np.asarray(ref.rows), out.rows.numpy()
    assert rows_t.shape == rows_j.shape == (49 * 49 * 9 + 1, 8 * 24 * 3)
    off_by_one = np.abs(rows_t.astype(np.int32) - rows_j) == 1
    assert off_by_one.mean() == 0.0  # measured share: 0
    np.testing.assert_array_equal(rows_t, rows_j)
    assert (rows_t != tvox.MERGED_PAD_Q).any()
    assert float(out.scale) == float(ref.scale)
    np.testing.assert_array_equal(out.corner.numpy(), np.asarray(ref.corner))


@pytest.mark.parametrize("shift", [0.0, 0.7], ids=["on-map", "shifted"])
def test_gather_neighbors_merged(merged, shift):
    ds, ref_map, _ = merged
    q = np.asarray(ds.xyz)[:4096] + np.float32(shift)
    qm = np.asarray(ds.mask)[:4096]
    cand_j, ok_j = jvox.gather_neighbors_merged(ref_map, jnp.asarray(q),
                                                jnp.asarray(qm))
    tmap = tvox.MergedDenseVoxelMap.from_numpy(
        np.asarray(ref_map.rows), ref_map.scale, ref_map.corner, ref_map.grid,
        ref_map.dims, ref_map.slab_pts, "cpu")
    cand_t, ok_t = tvox.gather_neighbors_merged(tmap, torch.tensor(q),
                                                torch.tensor(qm))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t.sum() > 1000
    np.testing.assert_array_equal(cand_t.numpy(), np.asarray(cand_j))


# ---------------------------------------------------------------------------
# the sorted-table maps, the corner gather, the point-cloud remainder
# ---------------------------------------------------------------------------
#
# Measured on these fixtures: table keys, counts and slabs identical; gathers
# identical (both index the same tables); kNN distances within 1e-6 with the
# same neighbours, duplicated points included (ties go to the lower candidate
# index in both); sparse Gaussian means within 1e-5 and covariances within
# 1e-4 absolute on coordinates kept inside +-6 m (E[x x^T] - mean mean^T in
# f32 loses more on larger ones, in either package's summation order).


def _sparse_cloud(seed=1, n=6000, cap=8192, extent=12.0, dup=True):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
    if dup:   # exact duplicates: equal distances that only the order decides
        pts[n // 2:n // 2 + 500] = pts[:500]
    return jpc.from_numpy(pts, cap), rng


def _table_pair(num_voxels, slab, seed=1, cap=8192):
    pc, rng = _sparse_cloud(seed, cap=cap)
    origin = np.array([0.3, -0.2, 0.1], np.float32)
    ref = jvox.build_voxel_map(pc, 1.0, jnp.asarray(origin),
                               num_voxels=num_voxels, slab_size=slab)
    out = tvox.build_voxel_map(_to_torch(pc), 1.0, torch.tensor(origin),
                               num_voxels, slab)
    return pc, ref, out, rng


@pytest.mark.parametrize("num_voxels,slab", [(16384, 8), (2048, 8), (16384, 2)],
                         ids=["table-longer-than-cloud", "voxels-dropped",
                              "points-dropped"])
def test_build_voxel_map(num_voxels, slab):
    _, ref, out, _ = _table_pair(num_voxels, slab)
    keys = np.asarray(ref.keys)
    np.testing.assert_array_equal(out.keys.numpy(), keys)
    assert out.keys.dtype == torch.int32
    assert (keys != jvox.INVALID_KEY).sum() > 1000
    np.testing.assert_array_equal(out.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(out.slab.numpy(), np.asarray(ref.slab))
    assert out.num_voxels == num_voxels and out.slab_size == slab


def test_build_voxel_map_of_an_empty_cloud():
    ref = jvox.build_voxel_map(jpc.empty(1024), 1.0, jnp.zeros(3),
                               num_voxels=2048, slab_size=8)
    out = tvox.build_voxel_map(tpc.empty(1024), 1.0, torch.zeros(3), 2048, 8)
    np.testing.assert_array_equal(out.keys.numpy(), np.asarray(ref.keys))
    np.testing.assert_array_equal(out.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(out.slab.numpy(), np.asarray(ref.slab))


def _table_from_reference(ref):
    return tvox.VoxelMap.from_numpy(np.asarray(ref.keys), np.asarray(ref.slab),
                                    np.asarray(ref.counts), ref.origin,
                                    ref.grid, "cpu")


def _queries(pc, rng, n=1024):
    q = np.asarray(pc.xyz)[:n] + rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    q[:64] = np.asarray(pc.xyz)[:64]          # on a point: distance ties
    q[64:96] += 600.0                         # outside the +-512 voxel range
    qm = np.ones(n, bool)
    qm[-100:] = False
    return q.astype(np.float32), qm


def test_lookup_voxels_with_the_invalid_tail():
    _, ref, out, rng = _table_pair(2048, 8)
    keys = np.asarray(ref.keys)
    real = keys[keys != jvox.INVALID_KEY]
    probe = np.concatenate([
        real[::7], real[::11] + 1, [0, int(jvox.INVALID_KEY),
                                    int(real.max()) + 5, (1 << 30) - 1],
    ]).astype(np.int32).reshape(-1, 1)   # (n, 1): an N-D lookup
    idx_j, found_j = jvox.lookup_voxels(ref.keys, jnp.asarray(probe))
    idx_t, found_t = tvox.lookup_voxels(out.keys, torch.tensor(probe))
    np.testing.assert_array_equal(found_t.numpy(), np.asarray(found_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert found_t.any() and not found_t.all()


@pytest.mark.parametrize("radius", [1, 0])
def test_gather_neighbors(radius):
    pc, ref, _, rng = _table_pair(16384, 8)
    q, qm = _queries(pc, rng)
    cand_j, ok_j = jvox.gather_neighbors(ref, jnp.asarray(q), jnp.asarray(qm),
                                         radius)
    cand_t, ok_t = tvox.gather_neighbors(_table_from_reference(ref),
                                         torch.tensor(q), torch.tensor(qm),
                                         radius)
    k = (2 * radius + 1) ** 3
    assert cand_t.shape == (len(q), k * 8, 3) and cand_t.is_contiguous()
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t.sum() > 1000 and not ok_t[-100:].any()
    np.testing.assert_array_equal(cand_t.numpy(), np.asarray(cand_j))


def test_knn_ties_go_to_the_lower_index():
    pc, ref, _, rng = _table_pair(16384, 8)
    q, qm = _queries(pc, rng)
    sq_j, nb_j, ok_j = jvox.knn(ref, jnp.asarray(q), jnp.asarray(qm), 5)
    sq_t, nb_t, ok_t = tvox.knn(_table_from_reference(ref), torch.tensor(q),
                                torch.tensor(qm), 5)
    ok = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok)
    assert ok.sum() > 2000
    np.testing.assert_allclose(sq_t.numpy()[ok], np.asarray(sq_j)[ok],
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(nb_t.numpy()[ok], np.asarray(nb_j)[ok])
    # the duplicated points make exact ties among the first queries
    d = np.asarray(sq_j)[:64]
    assert (d[:, 0] == d[:, 1]).any()


def _corner_case(case, rng):
    if case == "search-ball":
        pts = rng.uniform(-20, 20, size=(20000, 3)).astype(np.float32)
        return pts, 32768, rng.uniform(-18, 18, (512, 3)), (32, 32, 32)
    if case == "edge-shells":
        pts = rng.uniform(-16, 16, size=(8000, 3)).astype(np.float32)
        q = np.concatenate([
            rng.uniform(-16, 16, size=(256, 3)),
            rng.uniform(-16, -15.2, size=(64, 3)),
            np.stack([rng.uniform(-16, -15.2, 64), rng.uniform(-14, 14, 64),
                      rng.uniform(-14, 14, 64)], axis=1)])
        return pts, 8192, q, (16, 16, 16)
    pts = rng.uniform(-10, 10, size=(5000, 3)).astype(np.float32)
    pts[2500:2700] = pts[:200]                # duplicated points
    return pts, 8192, rng.uniform(-8, 8, (128, 3)), (16, 16, 16)


@pytest.mark.parametrize("case", ["search-ball", "edge-shells", "duplicates"])
def test_gather_neighbors_corner(case):
    """The three scenes of tests/test_corner_gather.py: candidates and
    validity bit-equal, in the same candidate order."""
    pts, cap, q, dims = _corner_case(case, np.random.default_rng(5))
    q = q.astype(np.float32)
    qm = np.ones(len(q), bool)
    qm[::17] = False
    pc = jpc.from_numpy(pts, cap)
    dm = jvox.build_dense_voxel_map(pc, 2.0, jnp.zeros(3, jnp.float32), dims,
                                    slab_size=24)
    cand_j, ok_j = jvox.gather_neighbors_corner(dm, jnp.asarray(q),
                                                jnp.asarray(qm))
    tdm = tvox.DenseVoxelMap.from_numpy(np.asarray(dm.slab), dm.counts,
                                        dm.corner, dm.grid, dm.dims,
                                        dm.slab_pts, "cpu")
    assert tdm.slab.shape[1] == 24 * 3       # the reference pads rows to 128
    own = tvox.build_dense_voxel_map(_to_torch(pc), 2.0, torch.zeros(3), dims,
                                     24)
    np.testing.assert_array_equal(own.slab.numpy(), tdm.slab.numpy())
    cand_t, ok_t = tvox.gather_neighbors_corner(tdm, torch.tensor(q),
                                                torch.tensor(qm))
    assert cand_t.shape == (len(q), 192, 3) and cand_t.is_contiguous()
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t.sum() > 100 and not ok_t[::17].any()
    np.testing.assert_array_equal(cand_t.numpy(), np.asarray(cand_j))


@pytest.mark.parametrize("num_voxels", [16384, 1024],
                         ids=["all-voxels", "voxels-dropped"])
def test_sparse_gaussian_map(num_voxels):
    pc, rng = _sparse_cloud(seed=2, n=7000, extent=6.0, dup=False)
    origin = np.array([0.1, 0.2, -0.3], np.float32)
    ref = jvox.build_gaussian_voxel_map(pc, 2.0, jnp.asarray(origin),
                                        num_voxels=num_voxels)
    out = tvox.build_gaussian_voxel_map(_to_torch(pc), 2.0,
                                        torch.tensor(origin), num_voxels)
    np.testing.assert_array_equal(out.keys.numpy(), np.asarray(ref.keys))
    np.testing.assert_array_equal(out.counts.numpy(), np.asarray(ref.counts))
    assert np.asarray(ref.counts).max() >= 6
    np.testing.assert_allclose(out.means.numpy(), np.asarray(ref.means),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.covs.numpy(), np.asarray(ref.covs),
                               atol=1e-4, rtol=0)
    q, qm = _queries(pc, rng, 512)
    offs = jvox.DIRECT7_OFFSETS
    np.testing.assert_array_equal(tvox.DIRECT7_OFFSETS, offs)
    m_j, c_j, v_j = jvox.gather_gaussians(ref, jnp.asarray(q), jnp.asarray(qm),
                                          jnp.asarray(offs))
    tg = tvox.GaussianVoxelMap.from_numpy(
        np.asarray(ref.keys), ref.means, ref.covs, ref.counts, ref.origin,
        ref.grid, "cpu")
    m_t, c_t, v_t = tvox.gather_gaussians(tg, torch.tensor(q), torch.tensor(qm),
                                          torch.tensor(offs))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert v_t.any() and not v_t.all()
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


def test_pointcloud_remainder(clouds):
    """``empty``, ``count``, ``transform``, ``crop_range`` and ``concat``
    against the reference's on the same cloud."""
    pc, center = clouds
    tp = _to_torch(pc)
    e_j, e_t = jpc.empty(64), tpc.empty(64)
    np.testing.assert_array_equal(e_t.xyz.numpy(), np.asarray(e_j.xyz))
    assert int(e_t.count()) == 0 and int(tp.count()) == int(pc.count()) > 0
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[0.8, -0.6, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, 1.0]]
    pose[:3, 3] = [1.0, -2.0, 0.5]
    m_j = jpc.transform(pc, jnp.asarray(pose))
    m_t = tpc.transform(tp, torch.tensor(pose))
    np.testing.assert_allclose(m_t.xyz.numpy(), np.asarray(m_j.xyz), atol=1e-5,
                               rtol=0)
    c = center.astype(np.float32)
    c_j = jpc.crop_range(pc, jnp.asarray(c), 10.0)
    c_t = tpc.crop_range(tp, torch.tensor(c), 10.0)
    np.testing.assert_array_equal(c_t.mask.numpy(), np.asarray(c_j.mask))
    assert 0 < int(c_t.count()) < int(tp.count())
    np.testing.assert_array_equal(c_t.xyz.numpy(), np.asarray(c_j.xyz))
    k_j = jpc.concat(c_j, m_j, 40000)
    k_t = tpc.concat(c_t, m_t, 40000)
    np.testing.assert_array_equal(k_t.mask.numpy(), np.asarray(k_j.mask))
    np.testing.assert_allclose(k_t.xyz.numpy(), np.asarray(k_j.xyz), atol=1e-5,
                               rtol=0)
