"""K1 (``fit_and_linearize_merged``) and K2 (``plane_normal_equations``):
the device time of one wrapper call over all its launches, and where a K1
warp spends its cycles, on one CUDA GPU.

    python3 tools/k1_breakdown.py [--tree DIR] [--csrc DIR] [--label NAME]
                                  [--skip-streamed]

Imports ``simpleslam_tpu_torch`` and ``chip_smoke`` from DIR (this
repository by default; another tree, e.g. a parent commit unpacked with
``git archive``, to measure it) and builds the kernel library twice from the
kernel sources of ``--csrc`` (that tree's own by default), both builds at
once: as it is, and with ``-DLOAM_K1_CLOCKS`` (every K1 warp adds SM clock
cycles per segment of its work; lane 0 writes them with the queries it
selected, its SM and its start and end on the global timer). To measure a
tree whose K1 has no probes, give ``--csrc`` a copy of its sources with the
same probes added: the slots (``kK3ClockSlots`` of
``csrc/loam_kernels.cu``) and ``loam_k1_set_clocks`` /
``loam_k1_clock_rows``.

It runs K1 through that tree's wrapper on two sets of inputs: those of
``chip_smoke.py``'s phase 3 (a merged map from a simulated submap, one
scan's 8192 queries) and the streamed full path's last target and last scan
prepped at its latched capacity (phase 6), each at the scan's pose and at
the 0.25 m offset; and K2 on the on-pose planes at the offset. Per case it
holds the sums against the plain version and prints the device time of one
wrapper call (torch.profiler: all the call's launches, by kernel), the
launches per call, the wrapper's CUDA-event median, the byte bound of
``chip_smoke.py``; and for K1, from the clock build, the mean cycles per
warp in each segment (prologue, stage: cp.async issue, wait: row loads,
select, tail: plane fit and row, block sums, finish: the last block's sum
of all blocks' partials) with its share, the queries a warp selected and
the launch's span. The probes cost time of their own: read the shares, not
the sum, against the first build's device time.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.dirname(os.path.abspath(__file__))
# (segment, its slot of kK3ClockSlots in csrc/loam_kernels.cu)
SEGMENTS = (("prologue", 0), ("stage", 3), ("wait", 1), ("select", 4),
            ("tail", 5), ("block sums", 8), ("finish", 10))
SLOTS = 18
QUERIES, SM, T0, T1 = 13, 14, 15, 16


def this_smoke():
    """This repository's ``chip_smoke.py`` (its ``call_device``), loaded by
    path: the measured tree's own may not have it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_lines(logs):
    """nvcc's -Xptxas -v lines of K1's, K2's and K3's kernels."""
    out = []
    for log in logs:
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" not in line:
                continue
            name = re.search(r"(fit_and_linearize_merged|plane_normal_"
                             r"equations|reduce_partials|gn_loop_kernel\w*?"
                             r"(Merged|Dense|Table))", line)
            if not name:
                continue
            for nxt in lines[i + 1:i + 4]:
                if "registers" in nxt or "spill" in nxt:
                    out.append(f"{name.group(0)}: {nxt.strip()}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="the repository tree to import (default: this one)")
    ap.add_argument("--csrc", default=None,
                    help="kernel sources to build (default: the tree's)")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--skip-streamed", action="store_true",
                    help="phase 3's inputs only (no streamed full run)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    sys.path.insert(1, TOOLS)
    import torch

    import chip_smoke as cs
    from k3_breakdown import streamed_targets
    from k4_breakdown import build_libraries, most_resident
    from simpleslam_tpu_torch.ops import _build
    from simpleslam_tpu_torch.ops import geometry as geo
    from simpleslam_tpu_torch.ops import loam
    from simpleslam_tpu_torch.ops import loam_kernels as lk

    if not cs.__file__.startswith(tree) or not lk.__file__.startswith(tree):
        raise SystemExit(f"k1_breakdown: did not import from {tree}")
    card = cs.environment()
    here = this_smoke()
    call_device, describe_call = here.call_device, here.describe_call
    dev = torch.device("cuda")
    logs = []
    timing, clock = build_libraries([[], ["-DLOAM_K1_CLOCKS"]], args.csrc,
                                    logs)
    for line in ptxas_lines(logs[:1]):
        print(f"ptxas ({args.label}), {line}")
    clock.loam_k1_clock_rows.argtypes = [ctypes.c_int]
    clock.loam_k1_clock_rows.restype = ctypes.c_int
    _build._lib = timing
    print(f"an empty launch ({args.label}): "
          f"{describe_call(call_device(lambda: lk.empty_launch(dev)))} "
          f"({card})")

    vm, src, sqrt_r, p_on, p_off, _ = cs.kernel_inputs(dev)
    sets = [("phase 3", vm, src, sqrt_r, p_on, p_off)]
    if not args.skip_streamed:
        targets, s6, pose6 = streamed_targets(dev, card)
        sets.append(("streamed full", targets["merged"], s6,
                     loam.source_sqrt_range(s6),
                     geo.transform_points(pose6, s6.xyz),
                     geo.transform_points(cs.offset_pose(pose6), s6.xyz)))
    for set_name, vm, src, sqrt_r, p_on, p_off in sets:
        n_q, n_valid = src.capacity, int(src.mask.sum())
        bd = cs.bounds(n_q, n_valid, 8 * vm.slab_pts)
        head = (f"({args.label}) on the {set_name} merged map, Q={n_q} "
                f"({n_valid} valid)")
        for tag, p_map in (("on-pose", p_on), ("offset", p_off)):

            def k1():
                return lk.fit_and_linearize_merged(vm, p_map, sqrt_r,
                                                   src.mask)

            _build._lib = timing
            got = k1()
            cs.compare(f"K1 {head}, {tag}", got,
                       lk.fit_and_linearize_merged_plain(vm, p_map, sqrt_r,
                                                         src.mask))
            t = call_device(k1)
            wrapper = cs.time_ms(k1)
            _build._lib = clock
            rows = clock.loam_k1_clock_rows(n_q)
            clocks = torch.zeros((rows, SLOTS), dtype=torch.int64, device=dev)
            if clock.loam_k1_set_clocks(clocks.data_ptr()) != 0:
                raise SystemExit("could not set the clock buffer")
            for _ in range(3):
                k1()
            clocks.zero_()
            torch.cuda.synchronize()
            again = k1()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(
                (*got[:3], *got[3]), (*again[:3], *again[3])))
            c = clocks.cpu().numpy()
            seg = np.stack([c[:, s] for _, s in SEGMENTS], 1).astype(
                np.float64)
            busy = seg.sum(axis=1).mean()
            mean = seg.mean(axis=0)
            t0, t1 = c[:, T0], c[:, T1]
            share = ("" if t is None else
                     f" = {100 * bd['k1'][0] / t[0]:.2f} % of the bound's rate")
            print(f"K1 {head}, {tag}: {describe_call(t)}{share}, wrapper "
                  f"{wrapper:.4f} ms per call (CUDA events), bound "
                  f"{1e3 * bd['k1'][0]:.3f} us by {bd['k1'][1]}; with the "
                  f"probes (outputs {'bit-identical' if same else 'DIFFERENT'}"
                  f"): {rows} warps, launch span "
                  f"{(t1.max() - t0.min()) / 1e3:.2f} us, "
                  f"{most_resident(c[:, SM], t0, t1)} warps on one SM at "
                  f"once, queries selected per warp {c[:, QUERIES].mean():.2f}"
                  f" mean, {c[:, QUERIES].max()} most; mean cycles per warp: "
                  + ", ".join(f"{n} {m:.0f} ({100 * m / busy:.1f} %)"
                              for (n, _), m in zip(SEGMENTS, mean))
                  + f" ({card})")
        _build._lib = timing
        planes = lk.fit_and_linearize_merged(vm, p_on, sqrt_r, src.mask)[3]

        def k2():
            return lk.plane_normal_equations(planes, p_off, sqrt_r)

        cs.compare(f"K2 {head}, frozen planes", k2(),
                   lk.plane_normal_equations_plain(planes, p_off, sqrt_r))
        t = call_device(k2)
        share = ("" if t is None else
                 f" = {100 * bd['k2'][0] / t[0]:.2f} % of the bound's rate")
        print(f"K2 {head}, on-pose planes at the offset: {describe_call(t)}"
              f"{share}, wrapper {cs.time_ms(k2):.4f} ms per call (CUDA "
              f"events), bound {1e3 * bd['k2'][0]:.3f} us by {bd['k2'][1]} "
              f"({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
