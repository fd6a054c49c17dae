"""K3's device time per launch, over the profiled drives whose trace kept
every K3 launch the program counted."""

LAYER = "kernels"
MOVES = "scans_per_s"
UNIT = "us"
SOURCE = "device_trace"


def read(ctx):
    n = sum(s.k3_seen for s in ctx.sessions)
    return 1e6 * sum(s.k3_s for s in ctx.sessions) / n if n else None
