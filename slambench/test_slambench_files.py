"""The benchmark's files: nothing under ``slambench/`` imports JAX or the
JAX package, the reference imports nothing of the program, and every
configuration, traffic mix, metric and limit that ``BENCHMARK.json`` names
is a file the harness finds by that name."""

import ast
import json
import os

import pytest

from slambench import run

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _py_files():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_py_files()))
def test_no_jax_or_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "simpleslam_tpu"}, path


@pytest.mark.parametrize("name", ["reference", "judge", "sim", "drive",
                                  "roofline", "trace"])
def test_yardstick_imports_nothing_of_the_program(name):
    tops = {m.split(".")[0]
            for m in _imports(os.path.join(HERE, name + ".py"))}
    assert "simpleslam_tpu_torch" not in tops


def test_every_named_file_is_found():
    for w in BENCH["workloads"]:
        cell = run.Cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert {"world", "trajectory", "n_scans", "dt", "noise"} <= set(
            cell.traffic)
        assert cell.limits["limits"]
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        mod = run.load_reader(m)
        assert callable(mod.read) and mod.UNIT == m["unit"]


def test_config_files_match_benchmark():
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(run.ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_per_layer_cells_report_what_they_move():
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in run.Cell(w).end_to_end}


@pytest.mark.parametrize("world", ["loop", "courtyard"])
def test_frozen_ray_caster_matches_the_programs(world):
    """The benchmark's copy of the simulator (with its azimuth cull) casts
    the same points as the port's simulator, bit for bit."""
    import numpy as np

    from simpleslam_tpu_torch.pipeline import simulate as psim
    from slambench import sim

    if world == "loop":
        w = sim.make_loop_world(seed=7)
        wp = psim.make_loop_world(seed=7)
    else:
        w = sim.make_courtyard(seed=7, radius=9.0, ring=12.0)
        wp = psim.World(rects=[psim.Rect(r.axis, r.offset, r.bounds)
                               for r in w.rects])
    _, poses = sim.make_trajectory(300, 0.1, 3.0, 9.0)
    for i in (0, 150, 299):
        a = sim.simulate_scan(w, sim.sensor_from_body(poses[i]), n_az=600,
                              max_range=100.0, rng=np.random.default_rng(i))
        b = psim.simulate_scan(wp, psim.sensor_from_body(poses[i]),
                               n_az=600, max_range=100.0,
                               rng=np.random.default_rng(i))
        assert np.array_equal(a, b)
