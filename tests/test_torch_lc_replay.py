"""The multi-lap spiral's loop-closure difference (ROADMAP §3, F8), replayed
from the JAX package's own inputs.

On the 400-scan spiral of tests/test_torch_pipeline_lc_multi.py the port
accepts 34 closures and the JAX package 35. Traced on the CPU:

- The runs keep the same keyframes up to keyframe 70 and accept the same
  closures up to it. Keyframe 71 is scan 282 in the JAX run and scan 283
  in the port's: at scan 282 the 1 m keyframe gate (``select_gate``) reads
  1.005978 m in the JAX run and 0.995752 m in the port's (two torch
  threads, as the tests run), whose positions of the scan lie 1.95 mm apart
  and of the gate's anchor (keyframe 70) 8.66 mm. The runs
  part by 2.39 mm at scan 72 through a convergence flip of the GN loop
  (F1's kind) and by 7-12 mm after the first closures. From keyframe 71 on
  the two runs hold other keyframes, descriptors and closures.
- Given the JAX run's keyframe clouds, poses and descriptors at every
  handler pass, the port makes the same retrieval decision on all 101
  queries (the same candidate at the same distance on the 49 that name
  one) and the JAX package's decision on all of its 35 accepted and 14
  rejected verifications but one: keyframe 75 against keyframe 30. There the JAX package's VGICP check, jitted as in
  its pipeline, runs its 100 iterations unconverged (fitness 0.26147);
  the same check in the JAX package run eagerly converges after 10
  iterations, and the port's after 3 (fitness 0.26139). Both fitnesses
  pass the 0.3 gate. The convergence flag flips at rounding size inside
  the reference itself.

So no op of the port computes another value: the count differs where a
reference gate falls on either side at rounding size. The file
``tests/data/lc_spiral400_replay.npz`` holds the JAX run's inputs at the
handler pass of keyframes 73-80 (descriptors and poses of keyframes 0-75,
the clouds of keyframe 75 and of its candidate's history window 28-32),
its query result and refined pose, and both runs' gate inputs at scan 282.
"""

import os
import threading
import types

import numpy as np
import pytest
import torch

import jax

from simpleslam_tpu.models import loopclosure as jlc
from simpleslam_tpu.models import mapmanager as jmm
from simpleslam_tpu.utils.config import Params as JParams
from simpleslam_tpu_torch.models import loopclosure as tlc
from simpleslam_tpu_torch.models import mapmanager as tmm
from simpleslam_tpu_torch.utils.config import Params as TParams
from simpleslam_tpu_torch.utils.logging import Logger as TLogger
from test_torch_pipeline_lc_multi import CFG

DATA = os.path.join(os.path.dirname(__file__), "data",
                    "lc_spiral400_replay.npz")
FIT_TOL = 1e-3      # fitness, port against the JAX package (measured 8e-05)
MIN_KF_GAP = 1.0    # MapManager.hpp:67, both packages


@pytest.fixture(scope="module")
def replay():
    with np.load(DATA) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs several workers on a few cores: two torch threads a
    worker keeps them from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_singletons():
    TParams.reset()
    JParams.reset()
    yield
    TParams.reset()
    JParams.reset()
    TLogger.reset()


def _keyframes(mm, d):
    """The JAX run's keyframes 0-75 at the handler pass: their poses, and
    the clouds the check reads (the others are never read)."""
    empty = np.zeros((0, 3), np.float32)
    return [mm.KeyFrame(0.1 * k, d["kf_pose"][k].copy(),
                        d.get(f"xyz_{k}", empty))
            for k in range(len(d["kf_pose"]))]


def _handler(lc_module, mm, d, descs, ring_keys):
    """A loop-closure manager of one package over the JAX run's keyframes,
    its context holding the JAX run's descriptors, with its check's
    (refined pose, converged flag) recorded; run for query keyframe 75."""
    kf_obj = mm.KeyFramesObj()
    kf_obj.keyframes[:] = _keyframes(mm, d)
    stub = types.SimpleNamespace(kf_obj=kf_obj, _kf_store=None,
                                 grid_size=0.5,
                                 kf_store_lock=threading.Lock())
    lc = lc_module.LoopClosureManager(stub)
    lc.context.descs = descs(lc.context.descs, d["descs"])
    lc.context.ring_keys = ring_keys(lc.context.ring_keys, d["ring_keys"])
    q = int(d["kf_query"])
    lc.context.n_contexts = q + 1
    lc.lc_size = q
    checks, queries = [], []
    scan2map, query_many = lc.register.scan2map, lc.context.query_many

    def recording_check(src, target, pose):
        checks.append(scan2map(src, target, pose))
        return checks[-1]

    def recording_query(ids):
        queries.extend(query_many(ids))
        return queries[-len(ids):]

    lc.register.scan2map = recording_check
    lc.context.query_many = recording_query
    accepted = lc.lc_handler_once()
    return lc, accepted, queries, checks


def _port(d):
    TParams.load(dict(CFG, torch={"device": "cpu"}))

    def put(buf, rows):
        buf[:len(rows)] = torch.from_numpy(rows)
        return buf

    return _handler(tlc, tmm, d, put, put)


def _jax(d):
    JParams.load(CFG)

    def put(buf, rows):
        return buf.at[:len(rows)].set(rows)

    return _handler(jlc, jmm, d, put, put)


def test_port_retrieves_the_jax_candidate_from_the_jax_descriptors(replay):
    _, _, queries, _ = _port(replay)
    idx, yaw, dist = replay["jax_query"]
    assert len(queries) == 1
    q = queries[0]
    assert q.idx == int(idx) == 30
    assert q.yaw == pytest.approx(yaw, abs=1e-7)
    assert q.min_dist == pytest.approx(dist, rel=1e-6)
    assert q.min_dist < 0.4       # scDistThres: a candidate to check


def test_jax_inputs_flip_the_check_of_keyframe_75_at_rounding_size(replay):
    """The stage that decides is the VGICP check's convergence flag: the
    port converges and accepts, the JAX package jitted (its pipeline's
    form) does not and rejects, the JAX package run eagerly converges and
    accepts. The fitnesses agree and pass the gate in all three."""
    lc, accepted, _, checks = _port(replay)
    fit = lc.register.get_fitness_score()
    refined, conv = checks[0]
    jlc_, jaccepted, _, jchecks = _jax(replay)
    jfit = jlc_.register.get_fitness_score()
    jrefined, jconv = jchecks[0]
    JParams.reset()
    with jax.disable_jit():
        elc, eaccepted, _, echecks = _jax(replay)
        efit = elc.register.get_fitness_score()
    print(f"keyframe 75 -> 30 on the JAX run's inputs: port converged "
          f"{bool(conv)}, fitness {fit:.6f}; JAX package jitted "
          f"{bool(jconv)}, {jfit:.6f}; eager {bool(echecks[0][1])}, "
          f"{efit:.6f}")
    # the jitted JAX check is the JAX pipeline's own, to the bit
    np.testing.assert_array_equal(np.asarray(jrefined, np.float64),
                                  replay["jax_refined"])
    assert (bool(conv), accepted) == (True, 1)
    assert (bool(jconv), jaccepted) == (False, 0)
    assert (bool(echecks[0][1]), eaccepted) == (True, 1)
    for f in (fit, efit):
        assert abs(f - jfit) < FIT_TOL
    assert max(fit, jfit, efit) < CFG["backend"]["lc"]["fitnessThreshold"]
    assert np.linalg.norm(np.asarray(refined)[:3, 3]
                          - np.asarray(jrefined)[:3, 3]) < 2e-3


def test_keyframe_gate_falls_either_side_at_scan_282(replay):
    """Keyframe 71: both packages' gate takes scan 282 from the JAX run's
    poses and refuses it from the port's; either distance lies nearer the
    1 m gate than the runs' positions of the scan and of the gate's anchor
    lie apart together."""
    out = {}
    for name, (anchor, pose) in (("jax", replay["gate_jax"]),
                                 ("port", replay["gate_port"])):
        got = []
        for mm in (jmm, tmm):
            self = types.SimpleNamespace(_select_anchor=anchor.copy())
            got.append(bool(mm.MapManager.select_gate(self, pose)))
        assert got[0] == got[1], name
        out[name] = (got[0], float(np.linalg.norm(pose - anchor)))
    assert out["jax"][0] and not out["port"][0]
    # the two distances differ by at most what the scan's positions and the
    # gate's anchors differ by
    gap = (np.linalg.norm(replay["gate_jax"][1] - replay["gate_port"][1])
           + np.linalg.norm(replay["gate_jax"][0] - replay["gate_port"][0]))
    assert tmm.MIN_KF_GAP == jmm.MIN_KF_GAP == MIN_KF_GAP
    for _, d in out.values():
        assert abs(d - MIN_KF_GAP) < gap
    print(f"scan 282: gate distance {out['jax'][1]:.6f} m (JAX run), "
          f"{out['port'][1]:.6f} m (port); scan and anchor {gap * 1e3:.2f} mm "
          "apart together")
