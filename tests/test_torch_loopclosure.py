"""Parity: the PyTorch port's loop-closure parts against the JAX package.

- ScanContext on the scenes of tests/test_scancontext.py: descriptors
  bit-identical (a scatter-max has no order), shift distances within 1e-5
  (measured 1.8e-7), and the same retrieval (index and yaw equal, distance
  within 1e-5).
- VGICP on the keyframes of tests/test_loopclosure.py (make_world(seed=11),
  a 10 m circle of 720 x 12 scans): the Gaussian target maps within 1e-4
  (measured: means identical, covariances 6.1e-5, counts identical); the
  plane-regularized source covariances within 1e-5 (measured 1.3e-6) where
  the neighbourhood scatter's two smallest eigenvalues are separated by
  more than 1 % of the largest — elsewhere the normal direction is
  ambiguous and a last-ulp difference of the scatter picks another one, in
  either package; identical validity masks; aligned poses within 2 cm
  (measured 5.5 mm, with and without ``lc_mode``) and fitness within 5 %
  (measured 1 %); the fitness score of one pose within 1e-6 relative
  (measured identical).
- The context plugins: a ScanContext database saved by the port loads in
  both packages (descriptors identical, ring keys within 1e-6), and
  DistContext answers every query as the JAX package's does.
- The port's LoopClosureManager on the keyframes of
  tests/test_loopclosure.py: the revisit closes with a between within
  0.25 m of the truth (that file's bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleslam_tpu import native as jnative
from simpleslam_tpu.models import context as jcontext
from simpleslam_tpu.ops import pointcloud as jpc
from simpleslam_tpu.ops import scancontext as jsc
from simpleslam_tpu.ops import vgicp as jv
from simpleslam_tpu.pipeline import simulate as sim
from simpleslam_tpu.utils.config import Params as JParams
from simpleslam_tpu_torch.models import context as tcontext
from simpleslam_tpu_torch.models.loopclosure import LoopClosureManager
from simpleslam_tpu_torch.models.mapmanager import KeyFrame, MapManager
from simpleslam_tpu_torch.models.registration import LoamRegister
from simpleslam_tpu_torch.ops import linalg3 as tl
from simpleslam_tpu_torch.ops import pointcloud as tpc
from simpleslam_tpu_torch.ops import scancontext as tsc
from simpleslam_tpu_torch.ops import vgicp as tv
from simpleslam_tpu_torch.ops import voxel as tvox
from simpleslam_tpu_torch.utils.config import Params as TParams
from simpleslam_tpu_torch.utils.logging import Logger as TLogger
from test_scancontext import _ring_scene

@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs several workers on a few cores: two torch threads a
    worker keeps them from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    TParams.reset()
    yield
    TParams.reset()
    TLogger.reset()


def _to_port(pc):
    return tpc.from_arrays(np.asarray(pc.xyz), np.asarray(pc.intensity),
                           np.asarray(pc.mask), "cpu")


# ---------------------------------------------------------------------------
# ScanContext
# ---------------------------------------------------------------------------

def _descs(xyz):
    dj = np.asarray(jsc.make_descriptor(jnp.asarray(xyz),
                                        jnp.ones(len(xyz), bool), 2.0))
    dt = tsc.make_descriptor(torch.tensor(xyz),
                             torch.ones(len(xyz), dtype=torch.bool), 2.0)
    return dj, dt.numpy()


@pytest.mark.parametrize("seed,yaw", [(42, 0.0), (42, 1.234), (7, 0.0),
                                      (102, 0.5)])
def test_make_descriptor_is_bit_identical(seed, yaw):
    xyz = _ring_scene(np.random.default_rng(seed), yaw=yaw)
    xyz[::50, 0] += 100.0  # some returns beyond the 80 m range
    dj, dt = _descs(xyz)
    np.testing.assert_array_equal(dt, dj)
    assert (dt > 0).sum() > 300


def test_all_shift_distances_match_jax():
    d0, _ = _descs(_ring_scene(np.random.default_rng(42), yaw=0.0))
    d1, _ = _descs(_ring_scene(np.random.default_rng(42), yaw=7 * 2 * np.pi
                               / tsc.NUM_SECTOR))
    d2, _ = _descs(_ring_scene(np.random.default_rng(3)))
    for a, b in ((d0, d1), (d0, d2)):
        ref = np.asarray(jsc._all_shift_distances(jnp.asarray(a),
                                                  jnp.asarray(b)))
        out = tsc._all_shift_distances(torch.tensor(a), torch.tensor(b))
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
        dj, sj = jsc.distance_between(jnp.asarray(a), jnp.asarray(b))
        dt, st = tsc.distance_between(torch.tensor(a), torch.tensor(b))
        assert int(st) == int(sj)
        assert abs(float(dt) - float(dj)) < 1e-5


def _database(cap, n, seeds):
    descs = np.zeros((cap, 20, 60), np.float32)
    for i in range(n):
        descs[i] = _descs(_ring_scene(np.random.default_rng(seeds(i))))[0]
    return descs, descs.mean(axis=2)


@pytest.mark.parametrize("case", ["revisit", "exclude_recent", "not_eligible"])
def test_query_matches_jax(case):
    if case == "revisit":   # scene 45 revisits scene 2
        descs, rk = _database(64, 46, lambda i: 102 if i == 45 else 100 + i)
        args = (45, 10, 0.4, 10)
    elif case == "exclude_recent":
        descs, rk = _database(32, 20, lambda i: 5 if i == 19 else 200 + i)
        descs[19], rk[19] = descs[17], rk[17]
        args = (19, 5, 0.4, 3)
    else:
        descs, rk = np.zeros((16, 20, 60), np.float32), np.zeros((16, 20),
                                                                np.float32)
        args = (5, 10, 0.4, 10)
    qid, excl, thres, ncand = args
    qj = jsc.query(jnp.asarray(descs), jnp.asarray(rk), jnp.int32(qid),
                   jnp.int32(excl), jnp.float32(thres), num_candidates=ncand)
    qt = tsc.query(torch.tensor(descs), torch.tensor(rk), qid, excl, thres,
                   num_candidates=ncand)
    assert int(qt.idx) == int(qj.idx)
    assert float(qt.yaw) == float(qj.yaw)
    if np.isfinite(float(qj.min_dist)):
        assert abs(float(qt.min_dist) - float(qj.min_dist)) < 1e-5
    else:
        assert not np.isfinite(float(qt.min_dist))
    if case == "revisit":
        assert int(qt.idx) == 2
    if case == "not_eligible":
        assert int(qt.idx) == -1


def test_scancontext_database_save_load_in_both_packages(tmp_path):
    TParams.load({"torch": {"device": "cpu"}, "tpu": {"max_keyframes": 16}})
    JParams.load({"tpu": {"max_keyframes": 16}})
    ctx = tcontext.make_context()
    for seed in range(5):
        ctx.add_context(_ring_scene(np.random.default_rng(seed)), np.eye(4))
    path = str(tmp_path / "sc")
    ctx.save_context(path)
    port, ref = tcontext.ScanContext(), jcontext.ScanContext()
    port.load_context(path)
    ref.load_context(path)
    assert port.n_contexts == ref.n_contexts == 5
    np.testing.assert_array_equal(port.descs.numpy(), ctx.descs.numpy())
    np.testing.assert_array_equal(np.asarray(ref.descs), ctx.descs.numpy())
    np.testing.assert_allclose(port.ring_keys.numpy(),
                               np.asarray(ref.ring_keys), rtol=0, atol=1e-6)


def test_distcontext_matches_jax():
    TParams.load({"torch": {"device": "cpu"}})
    port, ref = tcontext.make_context("distcontext"), \
        jcontext.make_context("distcontext")
    for k in range(60):  # a 10 m circle, then a second lap
        pose = _ring_pose(k % 45, n_ring=45)
        for c in (port, ref):
            c.add_context(np.zeros((1, 3), np.float32), pose)
    for qid in range(60):
        assert port.query(qid) == ref.query(qid)
    assert port.query(50).idx >= 0


# ---------------------------------------------------------------------------
# VGICP
# ---------------------------------------------------------------------------

def _ring_pose(k, n_ring=32, radius=10.0):
    th = 2 * np.pi * k / n_ring
    pose = np.eye(4)
    pose[0, 3], pose[1, 3] = radius * np.cos(th), radius * np.sin(th)
    c, s = np.cos(th + np.pi / 2), np.sin(th + np.pi / 2)
    pose[0, 0], pose[0, 1], pose[1, 0], pose[1, 1] = c, -s, s, c
    return pose


@pytest.fixture(scope="module")
def revisit():
    """History submap of keyframes 31, 0, 1 of the ring and a fresh scan
    at keyframe 0's pose, seen from a drifted estimate."""
    world = sim.make_world(seed=11)
    rng = np.random.default_rng(11)

    def scan(pose):
        return jnative.voxel_downsample_first(sim.simulate_scan(
            world, sim.sensor_from_body(pose), n_az=720, n_el=12, rng=rng),
            0.5)

    ring = [(_ring_pose(k), scan(_ring_pose(k))) for k in (31, 0, 1)]
    sub = jnative.voxel_downsample_first(jnative.transform_concat(
        [c for _, c in ring], np.stack([p for p, _ in ring])), 0.5)
    p0 = _ring_pose(0)
    src = jpc.from_numpy(scan(p0), 8192)
    sub = jpc.from_numpy(sub, 32768)
    center = p0[:3, 3].astype(np.float32)
    dims = (64, 64, 16)
    tj = jv.build_target(sub, 1.0, jnp.asarray(center), dims)
    tt = tv.build_target(_to_port(sub), 1.0, torch.tensor(center), dims)
    drift = np.eye(4)
    drift[0, 3], drift[1, 3] = 0.4, -0.3
    return src, tj, tt, p0, drift @ p0


def test_gaussian_target_matches_jax(revisit):
    _, tj, tt, _, _ = revisit
    np.testing.assert_array_equal(tt.gauss.counts.numpy(),
                                  np.asarray(tj.gauss.counts))
    np.testing.assert_allclose(tt.gauss.means.numpy(),
                               np.asarray(tj.gauss.means), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tt.gauss.covs.numpy(),
                               np.asarray(tj.gauss.covs), rtol=0, atol=1e-4)
    # the fitness map: same points (the reference pads rows to 64 lanes)
    w = tt.pts.slab.shape[1]
    np.testing.assert_array_equal(tt.pts.slab.numpy(),
                                  np.asarray(tj.pts.slab)[:, :w])


def test_source_covariances_match_jax(revisit):
    src = revisit[0]
    cj, vj = (np.asarray(a) for a in jv.source_covariances(src))
    tsrc = _to_port(src)
    ct, vt = (a.numpy() for a in tv.source_covariances(tsrc))
    np.testing.assert_array_equal(vt, vj)
    # the raw neighbourhood scatter, to find where the normal is defined
    svm = tvox.build_dense_voxel_map(tsrc, tv.SRC_GRID, torch.zeros(3),
                                     tv.SRC_DIMS, tv.SRC_SLAB)
    cand, ok = tvox.gather_neighbors_dense(svm, tsrc.xyz, tsrc.mask, 1)
    w = (ok & (((cand - tsrc.xyz[:, None]) ** 2).sum(-1)
               < tv.SRC_RADIUS_SQ)).float()
    cnt = w.sum(1).clamp(min=1)
    d = (cand - ((cand * w[..., None]).sum(1) / cnt[:, None])[:, None]) \
        * w[..., None]
    lam = tl.symeig3x3_values(torch.einsum("nki,nkj->nij", d, d)
                              / cnt[:, None, None]).numpy()
    sep = vt & ((lam[:, 1] - lam[:, 0]) > 0.01 * lam[:, 2])
    assert sep.sum() > 0.3 * vt.sum()
    np.testing.assert_allclose(ct[sep], cj[sep], rtol=0, atol=1e-5)


@pytest.mark.parametrize("lc_mode", [False, True], ids=["odometry", "lc"])
def test_align_matches_jax(revisit, lc_mode):
    src, tj, tt, p0, init = revisit
    rj = jv.align(src, tj, jnp.asarray(init, jnp.float32), lc_mode=lc_mode)
    rt = tv.align(_to_port(src), tt, torch.tensor(init, dtype=torch.float32),
                  lc_mode=lc_mode)
    assert rt.converged and bool(rj.converged)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), rtol=0,
                               atol=0.02)
    assert abs(float(rt.fitness) - float(rj.fitness)) \
        <= 0.05 * float(rj.fitness)
    # the drift (0.5 m) is taken out to the reference test's 0.25 m bound
    assert np.linalg.norm(rt.pose.numpy()[:3, 3] - p0[:3, 3]) < 0.25


def test_fitness_score_matches_jax(revisit):
    src, tj, tt, p0, _ = revisit
    fj = float(jv.fitness_score(src, tj.pts, jnp.asarray(p0, jnp.float32)))
    ft = float(tv.fitness_score(_to_port(src), tt.pts,
                                torch.tensor(p0, dtype=torch.float32)))
    assert abs(ft - fj) <= 1e-6 * fj and fj > 0


# ---------------------------------------------------------------------------
# the port's loop-closure manager (tests/test_loopclosure.py workflow)
# ---------------------------------------------------------------------------

def test_port_detects_and_verifies_closure():
    TParams.load({
        "saveMapDir": "", "torch": {"device": "cpu"},
        "backend": {"lc": {"enable": True, "historySubmapRange": 1,
                           "fitnessThreshold": 0.3},
                    "context": {"scancontext": {
                        "numExcludeRecent": 16, "numCandidatesFromTree": 4,
                        "scDistThres": 0.4}}},
        "tpu": {"max_keyframes": 64, "max_edges": 128,
                "ds_scan_capacity": 8192, "submap_capacity": 32768,
                "map_voxel_capacity": 16384, "scan_capacity": 16384},
    })
    world = sim.make_world(seed=11)
    rng = np.random.default_rng(11)
    n_ring, n_revisit = 32, 5
    mm = MapManager(LoamRegister())
    lcm = LoopClosureManager(mm)
    drift = np.eye(4)
    drift[0, 3], drift[1, 3] = 0.4, -0.3
    truth = []
    with mm.kf_obj.lock:
        for k in range(n_ring + n_revisit):
            pose = _ring_pose(k)
            scan = sim.simulate_scan(world, sim.sensor_from_body(pose),
                                     n_az=720, n_el=12, rng=rng)
            truth.append(pose)
            mm.kf_obj.keyframes.append(KeyFrame(
                float(k), drift @ pose if k >= n_ring else pose,
                mm._host_downsample(scan)))
        lcm.add_context()
    assert lcm.lc_handler_once() >= 1
    r = lcm.lc_queue.snapshot()[0]
    assert r.to_idx >= n_ring
    assert r.from_idx < r.to_idx - lcm.context.num_exclude_recent
    err = np.linalg.inv(np.linalg.inv(truth[r.from_idx]) @ truth[r.to_idx]) \
        @ r.between
    assert np.linalg.norm(err[:3, 3]) < 0.25, err[:3, 3]
