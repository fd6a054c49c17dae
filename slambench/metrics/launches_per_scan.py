"""Kernel launches (copies and fills apart) per scan in the profiled drives
that kept every K3 launch."""

LAYER = "device"
MOVES = "scans_per_s"
UNIT = "launches/scan"
SOURCE = "device_trace"


def read(ctx):
    scans = sum(d.n_scans for d in ctx.drives
                if d.session is not None and d.session.accepted)
    return sum(s.kernels for s in ctx.sessions) / scans if scans else None
