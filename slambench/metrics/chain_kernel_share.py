"""Share of the window's scans whose prediction and pose chain ran in the
program's hand kernels (``csrc/pose_chain.cu``) rather than in torch ops:
the program's ``chain_kernel`` counter, one entry per scan (1.0 or 0.0),
booked when the executor retires a batch. None where the program keeps no
such counter."""

import numpy as np

LAYER = "streamed executor"
MOVES = "scans_per_s"
UNIT = "%"
SOURCE = "program_counter"

COUNTER = "chain_kernel"


def read(ctx):
    runs = [getattr(d.timers, "counters", {}).get(COUNTER) for d in ctx.drives]
    if not runs or any(not r for r in runs):
        return None
    return 100.0 * float(np.mean([x for r in runs for x in r]))
