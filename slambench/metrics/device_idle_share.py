"""1 minus the union of device operation intervals over the profiled
windows that kept every K3 launch."""

LAYER = "device"
MOVES = "scans_per_s"
UNIT = "%"
SOURCE = "device_trace"


def read(ctx):
    w = sum(s.window_s for s in ctx.sessions)
    if w <= 0:
        return None
    return 100.0 * (1.0 - sum(s.busy_s for s in ctx.sessions) / w)
