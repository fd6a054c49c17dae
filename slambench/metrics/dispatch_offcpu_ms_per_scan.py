"""StageTimers ``dispatch`` wall time less its thread CPU time (``cpu``),
per scan: how long the front end's thread was off the CPU while it enqueued
its batches (waits for the interpreter's lock and the driver's, preemption),
over the drives of the window that ran without the profiler. None where the
program books no CPU time for its spans."""

LAYER = "streamed executor"
MOVES = "scans_per_s"
UNIT = "ms"
SOURCE = "program_span"


def read(ctx):
    drives = ctx.span_drives()
    cpu = [getattr(d.timers, "cpu", {}) for d in drives]
    scans = sum(d.n_scans for d in drives)
    if not scans or not all("dispatch" in c for c in cpu):
        return None
    off = sum(d.total("dispatch") - c["dispatch"] for d, c in zip(drives, cpu))
    return 1e3 * off / scans
