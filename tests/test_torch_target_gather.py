"""The CUDA kernel K3's index math for the dense map and the sorted voxel
table (``simpleslam_tpu_torch/csrc/target_gather.h``), compiled for the host
(``native.corner_rows`` / ``native.table_rows``), against the port's and the
JAX package's gathers on the same seeded inputs.

K3 reads a query's candidates on the card as: the 8 rows of the corner-
selected 2x2x2 block of a dense map (base ``floor((q - corner) / grid -
0.5)``, x outermost, the sentinel row outside the window or for a masked
query), or the 27 cells of a sorted table (a lower bound of each packed key,
clamped to the last row; found = key equal and not INVALID; a slot is valid
below ``counts[row]``). Candidates rebuilt from those rows must equal
``gather_neighbors_corner`` / ``gather_neighbors(vm, q, mask, 1)`` bit for
bit: order decides ties in the 5-NN rounds. The cases take in exact ties
(duplicated map points), queries on voxel boundaries, masked-out queries,
queries outside the window, a table with no valid key, and a table longer
than its cloud (the padding row under an INVALID key).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleslam_tpu.ops import pointcloud as jpc
from simpleslam_tpu.ops import voxel as jvox
from simpleslam_tpu_torch import native
from simpleslam_tpu_torch.ops import pointcloud as tpc
from simpleslam_tpu_torch.ops import voxel as tvox

DIMS = (6, 6, 4)
DENSE_GRID = 2.0
TABLE_GRID = 1.0
SLAB = 8
CAPACITY = 512
CASES = ["random", "ties", "boundaries", "masked", "outside", "empty",
         "longer-table"]


def _cloud(case: str, rng) -> np.ndarray:
    """Map points about the origin: a box of the window's size, with every
    point twice for exact ties, or none for an empty map."""
    if case == "empty":
        return np.zeros((0, 3), np.float32)
    pts = rng.uniform([-5.5, -5.5, -3.5], [5.5, 5.5, 3.5],
                      (150, 3)).astype(np.float32)
    if case == "ties":
        pts = np.concatenate([pts, pts])
    return pts


def _queries(case: str, rng):
    """(Q, 3) f32 queries and (Q,) mask for a case."""
    q = rng.uniform([-6.0, -6.0, -4.0], [6.0, 6.0, 4.0],
                    (96, 3)).astype(np.float32)
    mask = np.ones(len(q), bool)
    if case == "boundaries":
        # exactly on voxel faces of both grids, and on the corner block's
        # half-voxel shift
        k = rng.integers(-5, 6, (96, 3)).astype(np.float32)
        q = np.where(rng.random((96, 1)) < 0.5, k, k + 0.5).astype(np.float32)
    elif case == "masked":
        mask = rng.random(len(q)) < 0.5
    elif case == "outside":
        q = q * np.float32(3.0)
    mask[0] = False   # a masked-out query in every case
    return q, mask


def _maps(case: str, rng):
    pts = _cloud(case, rng)
    center = np.zeros(3, np.float32)
    n_vox = 4 * CAPACITY if case == "longer-table" else CAPACITY // 2
    jcloud = jpc.from_numpy(pts, CAPACITY)
    tcloud = tpc.from_numpy(pts, CAPACITY, "cpu")
    jdense = jvox.build_dense_voxel_map(jcloud, DENSE_GRID,
                                        jnp.asarray(center), DIMS, SLAB)
    jtable = jvox.build_voxel_map(jcloud, TABLE_GRID, jnp.asarray(center),
                                  n_vox, SLAB)
    tdense = tvox.build_dense_voxel_map(tcloud, DENSE_GRID,
                                        torch.tensor(center), DIMS, SLAB)
    ttable = tvox.build_voxel_map(tcloud, TABLE_GRID, torch.tensor(center),
                                  n_vox, SLAB)
    return jdense, jtable, tdense, ttable


@pytest.fixture(params=CASES)
def case(request):
    rng = np.random.default_rng(CASES.index(request.param))
    q, mask = _queries(request.param, rng)
    return request.param, q, mask, _maps(request.param, rng)


def test_corner_rows_match_both_gathers(case):
    """The 8 rows K3 stages per query rebuild the corner gather exactly."""
    name, q, mask, (jdense, _, tdense, _) = case
    rows = native.corner_rows(q, mask, tdense.corner.numpy(),
                              float(tdense.grid), tdense.dims)
    assert rows.shape == (len(q), 8)
    g_total = int(np.prod(DIMS))
    assert rows.min() >= 0 and rows.max() <= g_total
    assert (rows[~mask] == g_total).all()
    slab = tdense.slab.numpy()
    pts = slab[rows].reshape(len(q), 8 * SLAB, 3)
    valid = pts[..., 0] < np.float32(0.5e6)   # the PAD_COORD test
    tcand, tok = tvox.gather_neighbors_corner(tdense, torch.tensor(q),
                                              torch.tensor(mask))
    np.testing.assert_array_equal(pts, tcand.numpy())
    np.testing.assert_array_equal(valid, tok.numpy())
    jcand, jok = jvox.gather_neighbors_corner(jdense, jnp.asarray(q),
                                              jnp.asarray(mask))
    np.testing.assert_array_equal(pts, np.asarray(jcand))
    np.testing.assert_array_equal(valid, np.asarray(jok))
    if name == "outside":
        assert (rows == g_total).any() and (rows < g_total).any()
    if name not in ("empty", "outside"):
        assert valid[mask].any()


def test_table_rows_match_both_gathers(case):
    """The 27 cells K3 searches per query rebuild the table gather exactly:
    the lower bound, the clamp to the last row, the INVALID key."""
    name, q, mask, (_, jtable, _, ttable) = case
    keys = ttable.keys.numpy()
    idx, found = native.table_rows(q, mask, ttable.origin.numpy(),
                                   float(ttable.grid), keys)
    assert idx.shape == found.shape == (len(q), 27)
    assert idx.min() >= 0 and idx.max() < len(keys)
    assert not found[~mask].any()
    counts = ttable.counts.numpy()
    lane = np.arange(SLAB)
    valid = found[:, :, None] & (lane[None, None, :] < counts[idx][:, :, None])
    pts = ttable.slab.numpy()[idx]
    tcand, tok = tvox.gather_neighbors(ttable, torch.tensor(q),
                                       torch.tensor(mask), 1)
    np.testing.assert_array_equal(pts.reshape(len(q), -1, 3), tcand.numpy())
    np.testing.assert_array_equal(valid.reshape(len(q), -1), tok.numpy())
    jcand, jok = jvox.gather_neighbors(jtable, jnp.asarray(q),
                                       jnp.asarray(mask), 1)
    np.testing.assert_array_equal(pts.reshape(len(q), -1, 3),
                                  np.asarray(jcand))
    np.testing.assert_array_equal(valid.reshape(len(q), -1), np.asarray(jok))
    if name == "empty":
        assert (keys == tvox.INVALID_KEY).all() and not found.any()
    else:
        assert found.any()
    if name == "longer-table":
        # the padding row under an INVALID key, which no search finds
        assert len(keys) > CAPACITY and keys[CAPACITY] == tvox.INVALID_KEY
        assert counts[CAPACITY] > 0
        assert not (found & (idx == CAPACITY)).any()


def test_table_search_clamps_and_refuses_invalid():
    """Keys past the table's end clamp to its last row, which then decides;
    the INVALID key is never found, even where the table holds it."""
    keys = np.array([3, 7, 7 + (1 << 20), tvox.INVALID_KEY], np.int32)
    origin = np.zeros(3, np.float32)
    # voxel (x, y, z) of a point is floor(p) + 512 at grid 1
    q = np.array([[-512.0, -512.0, -510.0]], np.float32)   # key 0..27 range
    idx, found = native.table_rows(q, np.ones(1, bool), origin, 1.0, keys)
    want_idx, want_found = tvox.lookup_voxels(
        torch.tensor(keys),
        tvox.pack_coords(tvox.voxel_coords(torch.tensor(q), torch.zeros(3),
                                           torch.tensor(1.0))[:, None, :]
                         + tvox._neighbor_offsets(1, "cpu")[None],
                         torch.ones((1, 1), dtype=torch.bool)))
    np.testing.assert_array_equal(idx, want_idx.numpy())
    np.testing.assert_array_equal(found, want_found.numpy())
    assert found.any() and not found.all()
    far = np.array([[600.0, 600.0, 600.0]], np.float32)   # out of range
    idx, found = native.table_rows(far, np.ones(1, bool), origin, 1.0, keys)
    assert (idx == len(keys) - 1).all() and not found.any()
    with pytest.raises(ValueError, match="no row"):
        native.table_rows(q, np.ones(1, bool), origin, 1.0,
                          np.zeros(0, np.int32))
