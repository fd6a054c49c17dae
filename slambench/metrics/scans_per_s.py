"""All scans of all drives of the window over the window's time."""

UNIT = "scans/s"
SOURCE = "host_clock"


def read(ctx):
    scans = sum(d.n_scans for d in ctx.drives)
    return scans / ctx.window_s if ctx.window_s > 0 else None
