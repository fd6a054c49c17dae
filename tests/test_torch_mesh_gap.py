"""Where a mesh pipeline parts from the single-rank one (ROADMAP §3, F6).

The single-rank pipeline registers with K3; a mesh registers with the
stepwise loop, which sums in another order. On the bench ``full`` sequence
the two part at one registration: a start gap of rounding size flips one
query's plane gate, that row moves the first GN step by millimetres, and
the loop stops before its second step. This holds the one-rank stepwise
run (the mesh's loop without a collective) against the K3 run and
reproduces that: the scan is the same, the two starts lie under 1e-4 m
apart, the iteration counts agree, the results lie over 1e-3 m apart, a
plane flag flips between the starts, and K3 from the other run's start
on this run's map gives the other result (the map alone does not). K3 runs
only on the card, so the test needs one; run it there with
``python -m pytest --noconftest -o addopts="" tests/test_torch_mesh_gap.py``
(the suite's conftest imports jax).
"""

import importlib.util
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gap_tool():
    spec = importlib.util.spec_from_file_location(
        "gn_loop_gap", os.path.join(ROOT, "tools", "gn_loop_gap.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_mesh_gap_opens_at_a_plane_gate():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3 has no CPU mode")
    from simpleslam_tpu_torch.pipeline import simulate as sim

    gap = _gap_tool()
    gap.cs.build()
    cfg, every = gap.cs.BENCH_FULL, gap.cs.BENCH_SYNC_EVERY
    streams = sim.simulate_sequence(sim.make_world(seed=0), n_scans=150,
                                    seed=0, n_az=1800, n_el=16)
    k3 = gap.run_variant(cfg, streams, every, "k3", False)
    sw = gap.run_variant(cfg, streams, every, "stepwise", False)
    part = gap.parting(k3["records"], sw["records"])
    assert part is not None
    assert part["start_gap_m"] < 1e-4 and part["result_gap_m"] > 1e-3
    assert (part["iters_ref"], part["gathers_ref"]) == \
        (part["iters_run"], part["gathers_run"])
    # on either run's own inputs the two loops agree
    assert part["same_input_ref"][1] < 1e-4
    assert part["same_input_run"][1] < 1e-4
    probe = gap.probe(cfg, streams, every, part["registration"])
    assert probe["same_scan"] and probe["planes_ok_flipped"] >= 1
    assert probe["k3_from"]["k3_map_stepwise_start"] > 1e-3
    assert probe["k3_from"]["stepwise_map_k3_start"] < 1e-4
