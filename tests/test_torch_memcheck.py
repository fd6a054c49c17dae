"""The port's runtime-sanity harness (``simpleslam_tpu_torch/memcheck.py``,
the analogue of the root ``memcheck.py``) on the CPU: two short segments of
one sequence through one ``SlamSystem``. The steady-state segment builds
nothing anew and host RSS stays within the bound; the device checks need
the card and are made by ``chip_smoke.py`` there."""

import json
import sys

import pytest
import torch

from simpleslam_tpu_torch import memcheck
from simpleslam_tpu_torch.ops import _build
from simpleslam_tpu_torch.pipeline import simulate as sim
from simpleslam_tpu_torch.utils.config import Params as TParams
from simpleslam_tpu_torch.utils.logging import Logger as TLogger


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    TParams.reset()
    yield
    torch.set_num_threads(n)
    TParams.reset()
    TLogger.reset()


@pytest.fixture(scope="module")
def streams():
    world = sim.make_world(seed=1)
    return sim.cache_streams(
        "mem24s1", lambda: sim.simulate_sequence(world, n_scans=24, seed=1,
                                                 n_az=360, n_el=8))


def test_memcheck_steady_state_on_the_cpu(streams):
    out = memcheck.run_memcheck(2, 12, device="cpu", streams=streams)
    assert out["device"] == "cpu" and out["metric"] == "memcheck"
    seg = out["segments"]
    assert [s["registrations"] for s in seg] == [11, 12]  # scan 0 seeds the map
    assert seg[1]["new_builds"] == 0 and out["steady_state_builds_ok"]
    assert out["rss_ok"] and out["rss_growth_mb"] < 80.0 + out["map_footprint_mb"]
    assert all(s["plain_cuda_calls"] == 0 and s["k3_launches"] == 0
               for s in seg)          # CPU tensors launch no kernel
    assert "device_memory_ok" not in out   # host-side checks only
    assert out["ok"]
    json.dumps(out)


def test_memcheck_counts_builds(streams, monkeypatch):
    """A compiler run in a steady-state segment fails the check."""
    from simpleslam_tpu_torch.pipeline import streamed

    real = streamed.run_streamed
    calls = []

    def rebuilding(system, seg, **kw):
        calls.append(1)
        if len(calls) == 2:
            _build.note_build()
        return real(system, seg, **kw)

    monkeypatch.setattr(streamed, "run_streamed", rebuilding)
    out = memcheck.run_memcheck(2, 6, device="cpu", streams=streams)
    assert out["segments"][1]["new_builds"] == 1
    assert not out["steady_state_builds_ok"] and not out["ok"]


def test_memcheck_refuses_what_it_cannot_compare(streams):
    with pytest.raises(ValueError, match="at least 2 segments"):
        memcheck.run_memcheck(1, 6, device="cpu", streams=streams)
    with pytest.raises(ValueError, match="scans given"):
        memcheck.run_memcheck(3, 12, device="cpu", streams=streams)


def test_memcheck_cli_writes_its_json(tmp_path, monkeypatch, capsys):
    seen = {}

    def fake(n_segments, scans_per_segment, device=None):
        seen.update(n=n_segments, per=scans_per_segment, device=device)
        return {"metric": "memcheck", "ok": False}

    monkeypatch.setattr(memcheck, "run_memcheck", fake)
    out = tmp_path / "m.json"
    rc = memcheck.main(["3", "16", "--out", str(out), "--device", "cpu"])
    assert rc == 1 and seen == {"n": 3, "per": 16, "device": "cpu"}
    line = capsys.readouterr().out.strip()
    assert json.loads(line) == json.loads(out.read_text()) == {
        "metric": "memcheck", "ok": False}
    assert sys.modules["simpleslam_tpu_torch.memcheck"] is memcheck
