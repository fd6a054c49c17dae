"""StageTimers ``register`` per scan: the host side of each registration
(K3's wrapper: its checks, its workspace and the cooperative launch) inside
``dispatch``, over the drives of the window that ran without the profiler.
None where the program books no such span."""

LAYER = "kernels"
MOVES = "scans_per_s"
UNIT = "ms"
SOURCE = "program_span"


def read(ctx):
    drives = ctx.span_drives()
    scans = sum(d.n_scans for d in drives)
    if not scans or not sum(d.count("register") for d in drives):
        return None
    return 1e3 * sum(d.total("register") for d in drives) / scans
