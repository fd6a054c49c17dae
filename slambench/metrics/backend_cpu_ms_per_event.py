"""StageTimers ``cpu["backend"]`` over ``count["backend"]``: the backend
worker's own CPU time per keyframe event, that is how much of the
interpreter its pass takes, over the drives of the window that ran without
the profiler. None where the program books no CPU time for its spans."""

LAYER = "backend"
MOVES = "scans_per_s"
UNIT = "ms"
SOURCE = "program_span"


def read(ctx):
    drives = ctx.span_drives()
    cpu = [getattr(d.timers, "cpu", {}) for d in drives]
    n = sum(d.count("backend") for d in drives)
    if not n or not all("backend" in c for c in cpu):
        return None
    return 1e3 * sum(c["backend"] for c in cpu) / n
