"""The PyTorch port as a package: it stands alone (no jax, no triton, no
reference package), copies the simulator and config schema exactly, refuses
the parts it has not ported, reports which host-helper path it runs, and
its GPU smoke script fails cleanly where there is no GPU."""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from simpleslam_tpu.pipeline import simulate as jsim
from simpleslam_tpu.utils.config import DEFAULT_PARAMS as J_DEFAULTS
from simpleslam_tpu_torch import native
from simpleslam_tpu_torch.pipeline import app as tapp
from simpleslam_tpu_torch.pipeline import simulate as tsim
from simpleslam_tpu_torch.utils.config import DEFAULT_PARAMS as T_DEFAULTS
from simpleslam_tpu_torch.utils.config import Params as TParams
from simpleslam_tpu_torch.utils.logging import Logger as TLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
        "assert len(names) >= 20, names\n"
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


@pytest.mark.parametrize("cfg,item", [
    ({"backend": {"enable": True}}, "item 7"),
    ({"mode": "lio", "backend": {"enable": False}}, "item 9"),
    ({"backend": {"enable": False}, "frontend": {"pcr": "ndt"}}, "item 10"),
    ({"backend": {"enable": False}, "frontend": {"pcr": "vgicp"}}, "item 10"),
    ({"backend": {"enable": False}, "vis": {"enable": True}}, "item 11"),
], ids=["backend", "lio", "ndt", "vgicp", "vis"])
def test_unported_parts_are_refused(cfg, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tapp.SlamSystem(dict(cfg, torch={"device": "cpu"}))


def test_cli_refuses_backend_config(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        tapp.main(["--synthetic", "--scans", "2", "--out", str(tmp_path)])


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
    if native.backend() == "numpy":
        assert native._why_numpy


def test_native_fallback_is_reported_not_silent(monkeypatch, caplog):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "SRC", os.path.join(REPO, "no_such.cpp"))
    with caplog.at_level("WARNING", logger="simpleslam_tpu_torch"):
        assert native.backend() == "numpy"
    assert "numpy" in caplog.text and "no_such.cpp" in caplog.text


@pytest.mark.parametrize("fn", ["voxel_downsample_first", "pad_cloud",
                                "transform_concat"])
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
