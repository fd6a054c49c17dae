"""Share of the front end's ``dispatch`` wall time during which the backend
worker's ``backend`` span was open, from the program's span records (start
and length of each span on one clock, whatever thread booked it), over the
drives of the window that ran without the profiler: how much of the batch
enqueueing runs beside the worker's pass and competes with it. The mean
``dispatch`` of the batches mostly beside a pass and of those mostly not is
printed. None where the program keeps no records, a drive's ring dropped
some, or no drive booked a ``backend`` span."""

import numpy as np

LAYER = "streamed executor"
MOVES = "scans_per_s"
UNIT = "%"
SOURCE = "program_span"


def _intervals(records, name):
    iv = np.array([(r[2], r[2] + r[3]) for r in records if r[0] == name],
                  np.float64).reshape(-1, 2)
    return iv[np.argsort(iv[:, 0])]


def read(ctx):
    drives = ctx.span_drives()
    if not drives or any(getattr(d.timers, "records", None) is None
                         or d.timers.dropped for d in drives):
        return None
    disp, over, n_backend = [], [], 0
    for d in drives:
        recs = list(d.timers.records)
        dsp, bk = _intervals(recs, "dispatch"), _intervals(recs, "backend")
        n_backend += len(bk)
        # overlap of each dispatch with each backend pass (the passes are
        # one thread's, so they do not overlap one another)
        lo = np.maximum(dsp[:, None, 0], bk[None, :, 0])
        hi = np.minimum(dsp[:, None, 1], bk[None, :, 1])
        disp.append(dsp[:, 1] - dsp[:, 0])
        over.append(np.clip(hi - lo, 0.0, None).sum(axis=1))
    if not n_backend:
        return None
    disp, over = np.concatenate(disp), np.concatenate(over)
    beside = over > 0.5 * disp
    for tag, sel in (("beside a pass", beside), ("alone", ~beside)):
        mean = 1e-6 * disp[sel].mean() if sel.any() else float("nan")
        ctx.log(f"dispatch_backend_overlap_share: {int(sel.sum())} batches "
                f"{tag}, mean dispatch {mean:.3f} ms")
    return 100.0 * over.sum() / disp.sum()
