"""The plain reference on hand-made inputs, and its control: bfloat16 in
the reference's place fails the limits the cells hold the program to."""

import json
import os
import types

import numpy as np
import pytest

from slambench import judge, reference as ref, run


def _plane_world(rng, n=4000):
    """Points on a floor, two walls and a box face: a scene that pins all
    six degrees of freedom."""
    parts = [np.c_[rng.uniform(-15, 15, (n, 2)), np.full(n, -2.0)],
             np.c_[np.full(n, 9.0), rng.uniform(-15, 15, n),
                   rng.uniform(-2, 4, n)],
             np.c_[rng.uniform(-15, 15, n), np.full(n, -8.0),
                   rng.uniform(-2, 4, n)],
             np.c_[rng.uniform(-3, 1, n), np.full(n, 5.0),
                   rng.uniform(-2, 1, n)],
             np.c_[np.full(n, -6.0), rng.uniform(-5, 5, n),
                   rng.uniform(-2, 3, n)]]
    return np.concatenate(parts)


def _pose(x, y, yaw):
    T = np.eye(4)
    T[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    T[:2, 3] = x, y
    return T


def test_downsample_is_the_first_twenty_points_centroid():
    pts = np.array([[0.1, 0.1, 0.1], [0.3, 0.3, 0.3], [1.2, 0.2, 0.2],
                    [0.2, 0.2, 0.2]], np.float32)
    got = ref.downsample(pts, 0.5)
    np.testing.assert_allclose(got, [[0.2, 0.2, 0.2], [1.2, 0.2, 0.2]],
                               atol=1e-7)
    many = np.tile(np.float32([[0.1, 0.1, 0.1]]), (25, 1))
    many[20:] = 0.4          # past the first 20: not in the centroid
    np.testing.assert_allclose(ref.downsample(many, 0.5), [[0.1] * 3],
                               atol=1e-7)


def test_se3_exp_log_round_trip():
    rng = np.random.default_rng(0)
    xi = rng.normal(size=(20, 6)) * [3, 3, 3, 0.5, 0.5, 0.5]
    np.testing.assert_allclose(ref.se3_log(ref.se3_exp(xi)), xi, atol=1e-10)


def test_register_finds_the_scan_pose():
    rng = np.random.default_rng(1)
    world = _plane_world(rng)
    truth = _pose(1.0, -0.5, 0.3)
    mp = ref.downsample(world.astype(np.float32), 0.25)
    scan = (world - truth[:3, 3]) @ truth[:3, :3]        # sensor frame
    got = ref.register(ref.downsample(scan.astype(np.float32), 0.25), mp,
                       _pose(1.06, -0.55, 0.31))
    assert np.linalg.norm(got[:3, 3] - truth[:3, 3]) < 2e-3
    assert ref.rot_angle(got[:3, :3], truth[:3, :3]) < 2e-4


def test_graph_at_its_optimum_stays_and_a_bent_one_moves():
    poses = np.stack([_pose(k, 0.1 * k * k, 0.05 * k) for k in range(6)])
    ei, ej = np.arange(5), np.arange(1, 6)
    eT = np.linalg.inv(poses[ei]) @ poses[ej]
    info = np.tile(1.0 / np.array([0.1] * 3 + [1e-4] * 3), (5, 1))
    pinfo = 1.0 / ref.PRIOR_VAR
    same = ref.solve_graph(poses, poses[0], pinfo, ei, ej, eT, info)
    assert np.abs(same - poses).max() < 1e-9
    # a loop edge 0 -> 5 that disagrees by 0.5 m pulls the chain
    eT2 = np.concatenate([eT, (np.linalg.inv(poses[0]) @ poses[5]
                               @ _pose(0.5, 0, 0))[None]])
    info2 = np.concatenate([info, np.full((1, 6), 10.0)])
    bent = ref.solve_graph(poses, poses[0], pinfo, np.r_[ei, 0], np.r_[ej, 5],
                           eT2, info2)
    assert np.linalg.norm(bent[5, :3, 3] - poses[5, :3, 3]) > 0.05


@pytest.mark.parametrize("cell", ["vlp16_lo.city_drive",
                                  "vlp16_full.city_drive"])
def test_control_fails_the_cells_limits(cell):
    """The bfloat16 reference in the program's place, judged as the program
    is, at a size a test run holds: it fails a limit of the cell."""
    limits = run.Cell(cell).limits["limits"]
    rng = np.random.default_rng(2)
    world = _plane_world(rng) + [20.0, 30.0, 0.0]      # away from the origin
    truth = _pose(21.0, 29.5, 0.3)
    kf = _pose(20.5, 29.8, 0.25)
    scan = ((world - truth[:3, 3]) @ truth[:3, :3]).astype(np.float32)
    kf_scan = ((world - kf[:3, 3]) @ kf[:3, :3]).astype(np.float32)
    f64, low = ref.Prec(), ref.Prec("bfloat16")
    mp64 = ref.submap(truth, kf[None], [ref.downsample(kf_scan, 0.5)], 24,
                      0.5)
    mplow = ref.submap(truth, kf[None], [ref.downsample(kf_scan, 0.5, low)],
                       24, 0.5, low)
    c = ref.register(ref.downsample(scan, 0.5, low), mplow, truth, low)
    r, H, n = ref.register(ref.downsample(scan, 0.5), mp64, c, info=True)
    # the bfloat16 registration moves the scan off its alignment
    assert ref.residual_gap(c, r, H, n) > 1e-3
    prep_gap = judge._cloud_gap(ref.downsample(scan, 0.5, low),
                                ref.downsample(scan, 0.5))
    assert prep_gap > limits["prep_gap_m"]


@pytest.mark.parametrize("yaw", [0.0, 1.0, np.pi - 1e-4, np.pi, -np.pi + 1e-4])
def test_planar_clamp_keeps_the_heading(yaw):
    """The clamp holds at a half turn, where a scan heading the other way
    round a loop lies."""
    tilt = ref.se3_exp(np.array([0.0, 0.0, 0.3, 0.004, -0.003, 0.0]))
    T = _pose(3.0, -2.0, yaw) @ tilt
    got = ref.planar(T)
    assert ref.rot_angle(got[:3, :3], _pose(0, 0, yaw)[:3, :3]) < 1e-5
    np.testing.assert_allclose(got[:2, 3], T[:2, 3])
    assert got[2, 3] == 0.0


def test_an_accepted_closure_fails_a_drive_without_revisit():
    """A cell whose drive never revisits a place holds its closures at 0:
    one accepted closure there is false, and the run is not correct."""
    limits = run.Cell("vlp16_full.city_drive").limits["limits"]
    assert limits["closures"] == 0
    eye = np.tile(np.eye(4), (3, 1, 1))
    graph = {"prior_pose": np.eye(4), "prior_info": 1.0 / ref.PRIOR_VAR,
             "ei": np.zeros(0, np.int64), "ej": np.zeros(0, np.int64),
             "eT": np.zeros((0, 4, 4)), "einfo": np.zeros((0, 6))}
    drv = types.SimpleNamespace(scans=[np.zeros((0, 3), np.float32)] * 3,
                                scan_stamps=np.arange(3.0), gt_poses=eye)
    out = [judge.DriveOut(eye, np.zeros(0, np.int64), np.zeros((0, 4, 4)),
                          [], 100, graph, {"closures": k}) for k in (0, 1)]
    j = judge.Judge(drv, 0.5, 24, 7)
    assert j.numbers(out[:1])["closures"] == 0
    assert j.numbers(out)["closures"] == 1 > limits["closures"]
