"""StageTimers ``dispatch`` per scan: the streamed executor enqueueing each
batch (prediction, K3, the pose chain), over the drives of the window that
ran without the profiler."""

LAYER = "streamed executor"
MOVES = "scans_per_s"
UNIT = "ms"
SOURCE = "program_span"


def read(ctx):
    drives = ctx.span_drives()
    scans = sum(d.n_scans for d in drives)
    return (1e3 * sum(d.total("dispatch") for d in drives) / scans
            if scans else None)
