"""90th percentile, over every registration of the drives of the window, of
K3's K1 phases (the table searches a registration runs; the program's
``k1_phases`` counter, one entry per registration): the tail of K3's
gathers, where ``k3_roofline`` reads the drive means. None where the program
keeps no such counter."""

import numpy as np

LAYER = "kernels"
MOVES = "scans_per_s"
UNIT = "phases"
SOURCE = "program_counter"

COUNTER = "k1_phases"


def read(ctx):
    runs = [getattr(d.timers, "counters", {}).get(COUNTER) for d in ctx.drives]
    if not runs or any(not r for r in runs):
        return None
    return float(np.percentile([x for r in runs for x in r], 90))
