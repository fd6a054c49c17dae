"""StageTimers ``lc``, mean over its events: the loop-closure turn
(ScanContext retrieval, VGICP verification) per keyframe event, over the
drives of the window that ran without the profiler."""

LAYER = "loop closure"
MOVES = "scans_per_s"
UNIT = "ms"
SOURCE = "program_span"


def read(ctx):
    drives = ctx.span_drives()
    n = sum(d.count("lc") for d in drives)
    return 1e3 * sum(d.total("lc") for d in drives) / n if n else None
