"""StageTimers ``map_update`` per scan: the device submap rebuilds, over
the drives of the window that ran without the profiler."""

LAYER = "submap rebuild"
MOVES = "scans_per_s"
UNIT = "ms"
SOURCE = "program_span"


def read(ctx):
    drives = ctx.span_drives()
    scans = sum(d.n_scans for d in drives)
    return (1e3 * sum(d.total("map_update") for d in drives) / scans
            if scans else None)
