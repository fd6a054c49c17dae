"""The PyTorch port as a package: it stands alone (no jax, no triton, no
reference package, host helpers built from its own source in a directory
that holds nothing else), copies the simulator and config schema exactly,
refuses the parts it has not ported, runs its CLI (offline and streamed,
backend and loop closure on, lio mode, the NDT register, a profiler trace),
reports which host-helper path it runs, and its GPU smoke script fails
cleanly where there is no GPU."""

import copy
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from simpleslam_tpu.ops import roofline as jroof
from simpleslam_tpu.pipeline import simulate as jsim
from simpleslam_tpu.utils.config import DEFAULT_PARAMS as J_DEFAULTS
from simpleslam_tpu_torch import native
from simpleslam_tpu_torch.ops import roofline as troof
from simpleslam_tpu_torch.pipeline import app as tapp
from simpleslam_tpu_torch.pipeline import simulate as tsim
from simpleslam_tpu_torch.utils.config import DEFAULT_PARAMS as T_DEFAULTS
from simpleslam_tpu_torch.utils.config import Params as TParams
from simpleslam_tpu_torch.utils.logging import Logger as TLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def test_imports_without_jax_triton_or_reference():
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'triton', 'simpleslam_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import simpleslam_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert len(names) >= 32, names\n"
        "for n in ('models.filter', 'ops.ndt', 'ops.vgicp', 'pipeline.threaded',\n"
        "          'utils.profiling', 'pipeline.bagio', 'pipeline.vis', 'eval',\n"
        "          'eval.metrics', 'eval.gps', 'eval.__main__', 'ops.roofline',\n"
        "          'memcheck'):\n"
        "    assert p.__name__ + '.' + n in names, n\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "print('ok', len(names))\n")
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="", CUDA_PATH="")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("ok")


def test_simulator_copy_is_bit_identical():
    kw = dict(n_scans=3, seed=3, n_az=180, n_el=8)
    a = jsim.simulate_sequence(jsim.make_world(seed=3), **kw)
    b = tsim.simulate_sequence(tsim.make_world(seed=3), **kw)
    for name in ("scan_stamps", "gt_poses", "wheel_stamps", "wheel_poses",
                 "imu_stamps", "imu_quats"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
    assert len(a.scans) == len(b.scans)
    for sa, sb in zip(a.scans, b.scans):
        np.testing.assert_array_equal(sb, sa)


def test_config_schema_is_the_reference_one_plus_the_device_key():
    port = copy.deepcopy(T_DEFAULTS)
    assert port.pop("torch") == {"device": "cuda"}
    assert port == J_DEFAULTS


def test_roofline_counts_are_the_reference_ones_against_the_cards_peaks():
    """``loam_batch_cost`` counts what the reference counts when given its
    f32 rows, and by default the int16 rows the port really reads (half the
    bytes); ``utilization`` divides by the H100's published peaks, not by
    the reference's."""
    kw = dict(n_queries=6144, slab_rows=1, lane_width=8 * 24 * 3, slab_pts=24,
              n_scans=32, mean_iters=2.03, mean_gathers=1.38)
    cost = troof.loam_batch_cost(**kw, lane_bytes=4.0)
    assert cost == jroof.loam_batch_cost(**kw)
    half = troof.loam_batch_cost(**kw)
    assert half["hbm_bytes"] == cost["hbm_bytes"] / 2
    assert half["flops"] == cost["flops"]
    assert troof.H100_SXM_HBM_BYTES_PER_S == 3.35e12
    assert troof.H100_SXM_F32_NON_TENSOR_FLOPS == 67e12
    assert not [n for n in vars(troof) if "V5E" in n.upper()]
    dev_s = 0.1
    u = troof.utilization(half, dev_s)
    assert u["mfu"] == pytest.approx(half["flops"] / dev_s / 67e12, rel=1e-2)
    assert u["hbm_util"] == pytest.approx(half["hbm_bytes"] / dev_s / 3.35e12,
                                          rel=1e-2)
    assert u["sol_frac"] == max(u["mfu"], u["hbm_util"])
    assert 0 < u["sol_frac"] <= 1
    # at the speed of light itself every share is at most 1, one of them 1
    sol = max(half["flops"] / 67e12, half["hbm_bytes"] / 3.35e12)
    at = troof.utilization(half, sol)
    assert at["sol_frac"] == 1.0 and max(at["mfu"], at["hbm_util"]) == 1.0
    assert troof.utilization(half, 0.0) == {"mfu": 0.0, "hbm_util": 0.0,
                                            "sol_frac": 0.0}


@pytest.mark.parametrize("cfg,item", [
    ({"tpu": {"mesh_devices": 2}}, "item 12"),
    ({"backend": {"enable": False}, "vis": {"enable": True}}, None),
], ids=["mesh", "vis"])
def test_unported_parts_are_refused(cfg, item):
    """Only multi-device execution is still refused. The visualizer, which
    earlier slices refused, is built and wired to the odometry now."""
    cfg = dict(cfg, torch={"device": "cpu"})
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            tapp.SlamSystem(cfg)
        return
    system = tapp.SlamSystem(cfg)
    assert system.vis is not None and system.vis.enabled
    assert system.lidar_odometry.vis is system.vis
    system.shutdown()


@pytest.mark.parametrize("cfg,kind", [
    ({"mode": "lio", "backend": {"enable": False}}, "loam"),
    ({"backend": {"enable": False}, "frontend": {"pcr": "ndt"}}, "ndt"),
    ({"backend": {"enable": False}, "frontend": {"pcr": "vgicp"}}, "vgicp"),
    ({"mode": "lio", "backend": {"enable": True},
      "frontend": {"pcr": "vgicp"}}, "vgicp"),
], ids=["lio", "ndt", "vgicp", "lio_vgicp_backend"])
def test_every_mode_and_register_is_accepted(cfg, kind):
    """What earlier slices refused: lio mode and the NDT / VGICP odometry
    registers build their object graph now (lio with its EKF proxy wired to
    the frontend's deque)."""
    system = tapp.SlamSystem(dict(cfg, torch={"device": "cpu"}))
    assert system.register.KIND == kind
    assert (system.ekf_proxy is not None) == (cfg.get("mode") == "lio")
    if system.ekf_proxy is not None:
        assert system.frontend.local_odom is system.ekf_proxy.local_odom


def test_cli_refuses_backend_config(tmp_path):
    """The backend runs now; its sharded form does not, and the CLI says so."""
    cfg = tmp_path / "mesh.json"
    cfg.write_text('{"torch": {"device": "cpu"}, "tpu": {"mesh_devices": 2}}')
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        tapp.main(["--synthetic", "--config", str(cfg), "--scans", "2",
                   "--out", str(tmp_path)])


def test_cli_streamed_run_with_backend_and_loop_closure(tmp_path, capsys):
    cfg = tmp_path / "full.json"
    cfg.write_text('{"torch": {"device": "cpu"}, "tpu": {"scan_capacity": '
                   '8192}, "backend": {"enable": true, "lc": {"enable": '
                   'true}}}')
    out = tmp_path / "map"
    assert tapp.main(["--synthetic", "--streamed", "--config", str(cfg),
                      "--scans", "12", "--out", str(out)]) == 0
    for name in ("fg.g2o", "tum.txt", "0.pcd"):
        assert (out / name).is_file(), name
    assert "dispatch" in capsys.readouterr().out


@pytest.mark.parametrize("flags,stage", [
    (["--mode", "lio", "--streamed"], "ekf_replay"),
    (["--pcr", "ndt"], "odometry"),
], ids=["lio_streamed", "ndt"])
def test_cli_mode_and_register_flags(tmp_path, capsys, flags, stage):
    cfg = tmp_path / "cpu.json"
    cfg.write_text('{"backend": {"enable": false}, "torch": {"device": "cpu"},'
                   ' "tpu": {"scan_capacity": 8192}}')
    out = tmp_path / "map"
    assert tapp.main(["--synthetic", "--config", str(cfg), "--scans", "4",
                      "--out", str(out)] + flags) == 0
    assert (out / "tum.txt").is_file()
    assert stage in capsys.readouterr().out
    want = {"--mode": ("mode",), "--pcr": ("frontend", "pcr")}[flags[0]]
    got = TParams.get_instance()
    for key in want:
        got = got[key]
    assert got == flags[1]


def test_cli_trace_writes_a_chrome_trace(tmp_path):
    """``python -m simpleslam_tpu_torch.pipeline.app --trace DIR`` captures
    the run under torch.profiler; the offline harness's stage annotations
    are on its timeline. (A process of its own, as a user runs it: this
    one has imported jax, whose profiler shares the tracing library.)"""
    cfg = tmp_path / "cpu.json"
    cfg.write_text('{"backend": {"enable": false}, "torch": {"device": "cpu"},'
                   ' "tpu": {"scan_capacity": 8192}}')
    r = subprocess.run(
        [sys.executable, "-m", "simpleslam_tpu_torch.pipeline.app",
         "--synthetic", "--config", str(cfg), "--scans", "10", "--out",
         str(tmp_path / "map"), "--trace", str(tmp_path / "tr")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    names = {e.get("name") for e in json.loads(
        (tmp_path / "tr" / "trace.json").read_text())["traceEvents"]}
    assert {"odometry", "map_update"} <= names
    assert any(n and n.startswith("aten::") for n in names)


def test_cli_synthetic_run(tmp_path, capsys):
    cfg = tmp_path / "lo.json"
    cfg.write_text('{"backend": {"enable": false}, "torch": {"device": "cpu"},'
                   ' // comments are allowed\n "tpu": {"scan_capacity": 8192}}')
    out = tmp_path / "map"
    assert tapp.main(["--synthetic", "--config", str(cfg), "--scans", "6",
                      "--out", str(out)]) == 0
    assert (out / "tum.txt").is_file() and (out / "0.pcd").is_file()
    assert "odometry" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# native host helpers: the C++ path and its numpy fallback
# ---------------------------------------------------------------------------

def _cloud():
    rng = np.random.default_rng(7)
    xyz = rng.uniform(-20, 20, size=(5000, 3)).astype(np.float32)
    xyz[::97] = np.nan                        # stripped on both paths
    xyz[1::89] = np.round(xyz[1::89] * 2) / 2  # exactly on voxel faces
    return xyz


def test_native_backend_is_reported():
    assert native.backend() in ("cpp", "numpy")
    assert native.available() == (native.backend() == "cpp")
    if native.backend() == "numpy":
        assert native._why_numpy


def test_native_source_is_the_ports_own():
    pkg = os.path.join(REPO, "simpleslam_tpu_torch")
    assert os.path.commonpath([native.SRC, pkg]) == pkg
    assert os.path.isfile(native.SRC)
    assert os.path.commonpath([native.BUILD_DIR, pkg]) == pkg


def test_host_helpers_build_with_no_other_package_beside(tmp_path):
    """A copy of the port's package alone in a directory (no reference
    package next to it) builds and loads its C++ host helpers from its own
    source, and they run."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host helpers")
    shutil.copytree(
        os.path.join(REPO, "simpleslam_tpu_torch"),
        tmp_path / "simpleslam_tpu_torch",
        ignore=shutil.ignore_patterns("build", "__pycache__"))
    code = (
        "import os, sys\n"
        "for m in ('jax', 'simpleslam_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from simpleslam_tpu_torch import native\n"
        "here = os.path.realpath(os.getcwd())\n"
        "assert os.path.realpath(native.SRC).startswith(here), native.SRC\n"
        "assert native.backend() == 'cpp', native._why_numpy\n"
        "out = native.pad_cloud(np.ones((5, 3), np.float32), 8, 1e6)\n"
        "assert np.asarray(out[0]).shape[0] == 8\n"
        "from simpleslam_tpu_torch.models import filter as flt\n"
        "tape = flt.pad_tape_chunk(np.arange(4.) * .1, np.array([0, 1, 0, 1], bool),\n"
        "                          np.zeros((4, 2)), np.zeros(4), np.zeros(4), 4, 0.)\n"
        "assert flt.ekf_replay(tape).emitted.tolist() == [False, False, False, True]\n"
        "print('ok', [f for f in os.listdir(native.BUILD_DIR)])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("ok") and "libhostops_" in r.stdout
    assert sorted(os.listdir(tmp_path)) == ["simpleslam_tpu_torch"]


def test_native_fallback_is_reported_not_silent(monkeypatch, caplog):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "SRC", os.path.join(REPO, "no_such.cpp"))
    with caplog.at_level("WARNING", logger="simpleslam_tpu_torch"):
        assert native.backend() == "numpy"
    assert "numpy" in caplog.text and "no_such.cpp" in caplog.text


@pytest.mark.parametrize("fn", ["voxel_downsample_first", "pad_cloud",
                                "transform_concat",
                                "voxel_downsample_sort_quant_batch",
                                "voxel_downsample_centroid_pad",
                                "voxel_downsample_centroid_pad_batch"])
def test_native_paths_agree(fn, monkeypatch):
    """Deviation from the reference loader: its numpy fallback of
    ``voxel_downsample_first`` kept NaN rows and keyed voxels by
    ``x / grid`` where the C++ path drops NaNs and keys by ``x * (1 / grid)``;
    the port's fallback does what the C++ does, so both paths agree."""
    if native.backend() != "cpp":
        pytest.skip("needs the C++ build of the host helpers (g++)")
    xyz = _cloud()
    pose = np.eye(4)
    pose[:3, 3] = [1.0, -2.0, 0.5]
    calls = {
        "voxel_downsample_first": lambda: native.voxel_downsample_first(xyz, 0.5),
        "pad_cloud": lambda: native.pad_cloud(xyz, 8192, 1e6),
        "transform_concat": lambda: native.transform_concat(
            [xyz[:100], xyz[200:260]], np.stack([pose, np.eye(4)])),
        # capacity 2048 < the voxel count: the stride subsample runs too
        "voxel_downsample_sort_quant_batch":
            lambda: native.voxel_downsample_sort_quant_batch(
                [xyz, xyz[:700] * 4.0], 0.5, 2048, 2.0, 0.01),
        # capacity below and above the voxel count: stride subsample, padding
        "voxel_downsample_centroid_pad":
            lambda: (*native.voxel_downsample_centroid_pad(xyz, 0.5, 2048, 1e6),
                     *native.voxel_downsample_centroid_pad(xyz, 2.0, 8192,
                                                           1e6, max_pts=3)),
        "voxel_downsample_centroid_pad_batch":
            lambda: native.voxel_downsample_centroid_pad_batch(
                [xyz, xyz[:700] * 4.0, xyz[:0]], 0.5, 2048, 1e6),
    }
    cpp = calls[fn]()
    monkeypatch.setattr(native, "_load", lambda: None)
    ref = calls[fn]()
    for a, b in zip(cpp if isinstance(cpp, tuple) else (cpp,),
                    ref if isinstance(ref, tuple) else (ref,)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-5, equal_nan=True)


# ---------------------------------------------------------------------------
# the GPU smoke script
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_gpu(tmp_path, where):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        with open(script) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
