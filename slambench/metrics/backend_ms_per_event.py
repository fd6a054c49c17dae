"""StageTimers ``backend``, mean over its events: the backend worker's pass
(factors, solve, write-back) per keyframe event, over the drives of the
window that ran without the profiler."""

LAYER = "backend"
MOVES = "scans_per_s"
UNIT = "ms"
SOURCE = "program_span"


def read(ctx):
    drives = ctx.span_drives()
    n = sum(d.count("backend") for d in drives)
    return 1e3 * sum(d.total("backend") for d in drives) / n if n else None
