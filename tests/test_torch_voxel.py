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
