"""StageTimers ``prep`` per scan: the executor waiting for the host scan
preparation (downsample, sort, int16 rows), over the drives of the window
that ran without the profiler."""

LAYER = "host helpers"
MOVES = "scans_per_s"
UNIT = "ms"
SOURCE = "program_span"


def read(ctx):
    drives = ctx.span_drives()
    scans = sum(d.n_scans for d in drives)
    return (1e3 * sum(d.total("prep") for d in drives) / scans
            if scans else None)
