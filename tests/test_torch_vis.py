"""The port's own copy of the visualization egress (``pipeline/vis.py``):
the cases of tests/test_vis.py on the copy, the same PLY bytes as the JAX
package's writer, and a publish that never blocks while the drain thread
holds the lock."""

import os
import time

import numpy as np

from simpleslam_tpu.pipeline import vis as jvis
from simpleslam_tpu_torch.pipeline.vis import Vis, write_ply
from simpleslam_tpu_torch.utils.config import Params


def _wait_for(cond, timeout=4.0):
    t0 = time.time()
    while not cond() and time.time() - t0 < timeout:
        time.sleep(0.02)
    return cond()


def test_ply_roundtrip_header(tmp_path):
    xyz = np.random.default_rng(0).normal(size=(100, 3)).astype(np.float32)
    p, q = tmp_path / "a.ply", tmp_path / "b.ply"
    write_ply(str(p), xyz)
    jvis.write_ply(str(q), xyz)
    data = p.read_bytes()
    assert data == q.read_bytes()
    assert data.startswith(b"ply\nformat binary_little_endian")
    assert b"element vertex 100" in data
    body = data.split(b"end_header\n", 1)[1]
    np.testing.assert_array_equal(
        np.frombuffer(body, np.float32).reshape(-1, 3), xyz)


def test_publish_writes_files(tmp_path):
    Params.load({})
    vis = Vis(out_dir=str(tmp_path))
    vis.register_pc_pub("aligned")
    pose = np.eye(4)
    pose[0, 3] = 5.0
    assert vis.publish_pc("aligned", np.zeros((10, 3), np.float32), pose)
    assert _wait_for(lambda: any(f.startswith("aligned")
                                 for f in os.listdir(tmp_path)))
    vis.close()
    files = [f for f in os.listdir(tmp_path) if f.startswith("aligned")]
    body = (tmp_path / files[0]).read_bytes().split(b"end_header\n", 1)[1]
    pts = np.frombuffer(body, np.float32).reshape(-1, 3)
    np.testing.assert_allclose(pts[:, 0], 5.0)  # pose applied


def test_disabled_vis_is_noop():
    Params.load({})
    vis = Vis()
    assert not vis.enabled
    assert not vis.publish_pc("x", np.zeros((1, 3), np.float32))
    vis.close()


def test_sink_callback():
    Params.load({})
    got = []
    vis = Vis(sink=lambda name, xyz, pose: got.append((name, len(xyz))))
    vis.publish_pc("submap", np.zeros((7, 3), np.float32))
    assert _wait_for(lambda: bool(got))
    vis.close()
    assert got[0] == ("submap", 7)


def test_publish_drops_the_frame_when_the_worker_holds_the_lock():
    """The try-lock handoff: a busy visualizer costs the caller a dropped
    frame, never a wait."""
    Params.load({})
    vis = Vis(sink=lambda *a: None)
    with vis._lock:
        t0 = time.perf_counter()
        assert vis.publish_pc("aligned", np.zeros((4, 3), np.float32)) is False
        assert time.perf_counter() - t0 < 0.5
    assert _wait_for(lambda: vis.publish_pc("aligned",
                                            np.zeros((4, 3), np.float32)))
    vis.close()
