"""90th percentile, over every registration of the drives of the window, of
K3's Gauss-Newton iterations (the program's ``gn_iters`` counter: one entry
per registration, from the packed rows the executor retires): the tail of
the work each K3 launch does, where ``k3_roofline`` reads the drive means.
None where the program keeps no such counter."""

import numpy as np

LAYER = "kernels"
MOVES = "scans_per_s"
UNIT = "iters"
SOURCE = "program_counter"

COUNTER = "gn_iters"


def read(ctx):
    runs = [getattr(d.timers, "counters", {}).get(COUNTER) for d in ctx.drives]
    if not runs or any(not r for r in runs):
        return None
    return float(np.percentile([x for r in runs for x in r], 90))
