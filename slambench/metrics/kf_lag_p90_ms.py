"""90th percentile, over every keyframe-event burst of the drives of the
window that ran without the profiler, of the backend worker's lag
(``StageTimers`` ``backend_lag``: from the start of the burst to the
worker's pass over it): how stale the optimised graph is. The sample count
is printed."""

import numpy as np

LAYER = "backend"
MOVES = "scans_per_s"
UNIT = "ms"
SOURCE = "program_span"


def read(ctx):
    lags = [x for d in ctx.span_drives() for x in d.series("backend_lag")]
    ctx.log(f"kf_lag_p90_ms: {len(lags)} keyframe-event bursts")
    if len(lags) < 10:
        return None
    return 1e3 * float(np.percentile(lags, 90))
