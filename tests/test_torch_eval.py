"""The port's own copy of the evaluation tooling (``simpleslam_tpu_torch/
eval``): the cases of tests/test_eval.py on the copy, and equality with the
JAX package's functions on the same inputs. The metrics are numpy f64 in
both, so they agree within 1e-12."""

import subprocess
import sys

import numpy as np
import pytest

from simpleslam_tpu import eval as jeval
from simpleslam_tpu.eval.metrics import associate as jassociate
from simpleslam_tpu_torch.eval import GpsTool, ape, evaluate, gps_to_tum, rpe
from simpleslam_tpu_torch.eval.metrics import associate, umeyama_align
from simpleslam_tpu_torch.utils import fileio


def test_lla_ecef_enu_roundtrip_scale():
    """1e-4 deg latitude is about 11.1 m north; ENU reproduces that locally."""
    gt = GpsTool(lla_origin=(34.0, 113.0, 72.0))
    ref = jeval.GpsTool(lla_origin=(34.0, 113.0, 72.0))
    np.testing.assert_allclose(gt.get_enu(np.array([34.0, 113.0, 72.0])), 0.0,
                               atol=1e-6)
    north = gt.get_enu(np.array([34.0001, 113.0, 72.0]))
    assert abs(north[1] - 11.09) < 0.05 and abs(north[0]) < 1e-3
    east = gt.get_enu(np.array([34.0, 113.0001, 72.0]))
    assert abs(east[0] - 9.19) < 0.05 and abs(east[1]) < 1e-3
    up = gt.get_enu(np.array([34.0, 113.0, 82.0]))
    assert abs(up[2] - 10.0) < 0.01
    for lla in ([34.0001, 113.0, 72.0], [33.99, 113.02, 80.0]):
        np.testing.assert_allclose(gt.get_enu(np.array(lla)),
                                   ref.get_enu(np.array(lla)), atol=1e-12,
                                   rtol=0)


def test_gps_to_tum_rtk_gating(tmp_path):
    stamps = np.arange(5, dtype=np.float64)
    lla = np.tile([34.0, 113.0, 72.0], (5, 1))
    lla[:, 0] += np.arange(5) * 1e-5
    gga = np.array([4, 1, 4, 5, 4])  # only gga == 4 rows survive
    out = str(tmp_path / "gps_tum.txt")
    rows = gps_to_tum(stamps, lla, gga, out_path=out)
    assert rows.shape == (3, 8)
    assert list(rows[:, 0]) == [0.0, 2.0, 4.0]
    np.testing.assert_allclose(np.loadtxt(out), rows, atol=1e-5)
    np.testing.assert_allclose(rows, jeval.gps_to_tum(stamps, lla, gga),
                               atol=1e-12, rtol=0)


def test_associate_nearest_stamp():
    a, b = np.array([0.0, 1.0, 2.0, 3.0]), np.array([0.005, 1.1, 2.004])
    ri, ei = associate(a, b, max_diff=0.02)
    assert list(ri) == [0, 2] and list(ei) == [0, 2]
    rj, ej = jassociate(a, b, max_diff=0.02)
    assert list(ri) == list(rj) and list(ei) == list(ej)


def _circle_traj(n=50, r=10.0):
    th = np.linspace(0, np.pi, n)
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, 0, 3] = r * np.cos(th)
    poses[:, 1, 3] = r * np.sin(th)
    return poses


def test_ape_rpe_stats():
    gt = _circle_traj()
    est = gt.copy()
    est[:, :3, 3] += 0.1  # constant offset: alignment removes it
    assert ape(gt, est, align=True).rmse < 1e-6
    assert abs(ape(gt, est, align=False).rmse - np.sqrt(3) * 0.1) < 1e-6
    r = rpe(gt, est, delta=1)  # constant offset has zero relative error
    assert r.rmse < 1e-9 and r.n == len(gt) - 1


@pytest.mark.parametrize("align", [True, False])
def test_metrics_equal_the_reference(align):
    rng = np.random.default_rng(4)
    gt = _circle_traj()
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.05, (len(gt), 3))
    c, s = np.cos(0.3), np.sin(0.3)
    est = np.array([[c, -s, 0, 1.0], [s, c, 0, -2.0], [0, 0, 1, 0.5],
                    [0, 0, 0, 1]]) @ est
    a_t, a_j = ape(gt, est, align=align), jeval.ape(gt, est, align=align)
    r_t, r_j = rpe(gt, est, delta=5), jeval.rpe(gt, est, delta=5)
    for got, want in ((a_t, a_j), (r_t, r_j)):
        for name, value in vars(want).items():
            np.testing.assert_allclose(getattr(got, name), value, atol=1e-12,
                                       rtol=0)
    for with_scale in (False, True):
        np.testing.assert_allclose(
            umeyama_align(est[:, :3, 3], gt[:, :3, 3], with_scale),
            jeval.umeyama_align(est[:, :3, 3], gt[:, :3, 3], with_scale),
            atol=1e-12, rtol=0)


def test_evaluate_tum_files(tmp_path):
    gt = _circle_traj()
    stamps = np.arange(len(gt)) * 0.1
    est = gt.copy()
    est[:, :3, 3] += np.random.default_rng(0).normal(0, 0.05, (len(gt), 3))
    g, e = str(tmp_path / "gt.txt"), str(tmp_path / "est.txt")
    fileio.write_tum(g, stamps, gt)
    fileio.write_tum(e, stamps + 0.001, est)
    a, r = evaluate(g, e, delta=5)
    assert 0.0 < a.rmse < 0.2
    assert 0.0 < r.rmse < 0.3
    a_j, r_j = jeval.evaluate(g, e, delta=5)
    np.testing.assert_allclose([a.rmse, r.rmse], [a_j.rmse, r_j.rmse],
                               atol=1e-12, rtol=0)
    fileio.write_tum(str(tmp_path / "far.txt"), stamps + 99.0, est)
    with pytest.raises(ValueError, match="associated pose pairs"):
        evaluate(g, str(tmp_path / "far.txt"))


def test_eval_cli(tmp_path):
    """``python -m simpleslam_tpu_torch.eval GT EST`` prints the APE and RPE
    tables of the two files."""
    gt = _circle_traj()
    stamps = np.arange(len(gt)) * 0.1
    est = gt.copy()
    est[:, 0, 3] += 0.05 * np.sin(np.arange(len(gt)))
    g, e = str(tmp_path / "gt.txt"), str(tmp_path / "est.txt")
    fileio.write_tum(g, stamps, gt)
    fileio.write_tum(e, stamps, est)
    r = subprocess.run([sys.executable, "-m", "simpleslam_tpu_torch.eval", g,
                        e, "--delta", "5"], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert "APE" in r.stdout and "RPE" in r.stdout
    a, rp = evaluate(g, e, delta=5)
    assert r.stdout.splitlines() == [f"APE: {a.row()}",
                                     f"RPE(delta=5): {rp.row()}"]
