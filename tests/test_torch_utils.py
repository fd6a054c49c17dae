"""The port's copies of the infrastructure modules (``utils/concurrency.py``,
``utils/config.py``, ``utils/logging.py``, ``utils/fileio.py``) on the cases
of tests/test_utils.py: config defaults and overrides, the logger's exit
flag, SafeDeque (drop-oldest, blocking backpressure, abort, many producers
and consumers), ResidentThread, AtomicVar, and the TUM, PCD and g2o
round-trips. Each file the port writes is also read by the JAX package's
``fileio``, and the other way round: the two packages share their
artifacts."""

import threading
import time

import numpy as np
import pytest
import torch

from simpleslam_tpu.utils import fileio as jfileio
from simpleslam_tpu_torch.ops import geometry as geo
from simpleslam_tpu_torch.utils import fileio
from simpleslam_tpu_torch.utils.concurrency import (AtomicVar, ResidentThread,
                                                    SafeDeque)
from simpleslam_tpu_torch.utils.config import Params
from simpleslam_tpu_torch.utils.logging import Logger


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    Params.reset()
    Logger.reset()
    yield
    Params.reset()
    Logger.reset()


def _poses(rng, n, rot_scale, trans_scale):
    w = torch.tensor(rng.normal(size=(n, 3)).astype(np.float32) * rot_scale)
    t = torch.tensor(rng.normal(size=(n, 3)).astype(np.float32) * trans_scale)
    return geo.make_pose(geo.so3_exp(w), t).numpy()


def test_config_defaults_and_overrides(tmp_path):
    p = Params.get_instance()
    assert p["frontend"]["pcr"] == "loam"
    assert p["torch"]["device"] == "cuda"
    cfg_file = tmp_path / "params.json"
    cfg_file.write_text('{\n // comment line\n "mode": "lio", "frontend": '
                        '{"pcr": "ndt"}, "torch": {"device": "cpu"}\n}')
    p = Params.load(str(cfg_file))
    assert p["mode"] == "lio"
    assert p["frontend"]["pcr"] == "ndt"
    assert p["frontend"]["local_size"] == 100  # deep-merge keeps defaults
    assert p["torch"]["device"] == "cpu"
    p["mode"] = "corrupted"                    # returned copies are independent
    assert Params.get_instance()["mode"] == "lio"


def test_logger_exit_flag():
    lg = Logger.get_instance()
    assert not lg.is_program_exit()
    lg.exit_program()
    assert lg.is_program_exit()
    assert lg.exit_event.is_set()


def test_safedeque_drop_oldest():
    q = SafeDeque(capacity=3)
    for i in range(5):
        q.push_back(i, block=False)
    assert q.snapshot() == [2, 3, 4]


def test_safedeque_blocking_backpressure():
    q = SafeDeque(capacity=2)
    q.push_back(0)
    q.push_back(1)
    done = []

    def producer():
        done.append(q.push_back(2, block=True, timeout=5))

    t = threading.Thread(target=producer)
    t.start()
    time.sleep(0.05)
    assert not done  # blocked while full
    assert q.consume_front() == 0
    t.join(timeout=5)
    assert done == [True]
    assert q.snapshot() == [1, 2]


def test_safedeque_abort_releases_producer():
    q = SafeDeque(capacity=1)
    q.push_back(0)
    results = []

    def producer():
        results.append(q.push_back(1, block=True, timeout=5))

    t = threading.Thread(target=producer)
    t.start()
    time.sleep(0.05)
    q.abort()
    t.join(timeout=5)
    assert results == [False]


def test_safedeque_mpmc_stress():
    q = SafeDeque(capacity=16)
    n_per = 200
    consumed = []
    lock = threading.Lock()

    def producer(base):
        for i in range(n_per):
            q.push_back(base + i, block=True)

    def consumer():
        while True:
            item = q.consume_front(block=True, timeout=1)
            if item is None:
                return
            with lock:
                consumed.append(item)

    producers = [threading.Thread(target=producer, args=(k * 1000,))
                 for k in range(3)]
    consumers = [threading.Thread(target=consumer) for _ in range(2)]
    for t in producers + consumers:
        t.start()
    for t in producers + consumers:
        t.join()
    assert len(consumed) == 3 * n_per
    assert len(set(consumed)) == 3 * n_per


def test_resident_thread_stop_resume():
    counter = {"n": 0}
    ev = threading.Event()

    def work():
        counter["n"] += 1
        ev.set()
        time.sleep(0.005)

    rt = ResidentThread(work, name="worker")
    assert ev.wait(timeout=2)
    rt.pause()
    time.sleep(0.05)
    paused_at = counter["n"]
    time.sleep(0.05)
    assert counter["n"] <= paused_at + 1
    rt.resume()
    time.sleep(0.05)
    assert counter["n"] > paused_at
    rt.stop()
    rt.join(timeout=2)
    assert not rt.is_alive()


def test_atomic_var():
    av = AtomicVar(np.eye(4))
    av.store(np.ones((4, 4)))
    np.testing.assert_array_equal(av.load(), np.ones((4, 4)))


def test_tum_roundtrip(tmp_path, rng):
    n = 5
    poses = _poses(rng, n, 0.5, 10.0)
    stamps = np.arange(n) * 0.1 + 100.0
    fileio.write_tum(str(tmp_path), stamps, poses)
    for load in (fileio.load_tum, jfileio.load_tum):
        s2, p2 = load(str(tmp_path))
        np.testing.assert_allclose(s2, stamps, atol=1e-3)
        np.testing.assert_allclose(p2[:, :3, 3], poses[:, :3, 3], atol=2e-3)
        np.testing.assert_allclose(p2[:, :3, :3], poses[:, :3, :3], atol=1e-4)
    fileio.write_tum(str(tmp_path), stamps[:1] + 10, poses[:1], append=True)
    assert len(fileio.load_tum(str(tmp_path))[0]) == n + 1
    fileio.remove_tum(str(tmp_path))
    assert len(fileio.load_tum(str(tmp_path))[0]) == 0


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("binary", [True, False])
def test_pcd_roundtrip(tmp_path, rng, binary, writer):
    xyz = rng.normal(size=(100, 3)).astype(np.float32) * 20
    inten = rng.uniform(size=(100,)).astype(np.float32)
    path = str(tmp_path / "cloud.pcd")
    (fileio if writer == "port" else jfileio).save_pcd(path, xyz, inten,
                                                       binary=binary)
    for load in (fileio.load_pcd, jfileio.load_pcd):
        xyz2, inten2 = load(path)
        np.testing.assert_allclose(xyz2, xyz, atol=1e-5)
        np.testing.assert_allclose(inten2, inten, atol=1e-5)


def test_g2o_roundtrip(tmp_path, rng):
    n = 4
    poses = _poses(rng, n, 0.4, 5.0)
    info = np.diag([1.0, 2, 3, 4, 5, 6])
    edges = [(0, 1, poses[1], info), (1, 2, poses[2], info)]
    path = str(tmp_path / "fg.g2o")
    fileio.write_g2o(path, poses, edges)
    for load in (fileio.load_g2o, jfileio.load_g2o):
        p2, e2 = load(path)
        assert p2.shape == (n, 4, 4)
        np.testing.assert_allclose(p2, poses, atol=1e-5)
        assert len(e2) == 2
        i, j, bt, info2 = e2[0]
        assert (i, j) == (0, 1)
        np.testing.assert_allclose(bt, poses[1], atol=1e-5)
        np.testing.assert_allclose(info2, info, atol=1e-6)
