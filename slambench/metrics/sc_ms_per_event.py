"""StageTimers ``sc_ingest`` (the ScanContext descriptor build) and
``sc_query`` (the queued retrieval), both inside the backend worker's pass,
over ``count["backend"]``: ScanContext's share of the pass per keyframe
event, over the drives of the window that ran without the profiler. None
where the program books neither span."""

LAYER = "loop closure"
MOVES = "scans_per_s"
UNIT = "ms"
SOURCE = "program_span"

STAGES = ("sc_ingest", "sc_query")


def read(ctx):
    drives = ctx.span_drives()
    n = sum(d.count("backend") for d in drives)
    if not n or not sum(d.count(s) for d in drives for s in STAGES):
        return None
    return 1e3 * sum(d.total(s) for d in drives for s in STAGES) / n
