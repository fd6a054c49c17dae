"""K3's share of its roofline: the least time the card could take for the
registrations of the accepted profiled drives (``roofline.k3_bound_s`` per
registration: the scan capacity, the scan's valid rows, the drive's mean
Gauss-Newton iterations and K1 phases), over K3's measured device time
there."""

from slambench import roofline

LAYER = "kernels"
MOVES = "scans_per_s"
UNIT = "%"
SOURCE = "device_trace"


def read(ctx):
    t = sum(s.k3_s for s in ctx.sessions)
    if t <= 0:
        return None
    bound, by = 0.0, {}
    for d in ctx.drives:
        if d.session is None or not d.session.accepted:
            continue
        n_cand = 8 * int(ctx.slab)
        for n_valid in d.valid_rows():
            b, what = roofline.k3_bound_s(d.scan_capacity, n_valid, n_cand,
                                         d.gn_gathers, d.gn_iters)
            bound += b
            by[what] = by.get(what, 0) + 1
    ctx.log(f"k3_roofline: bound by {by} over {sum(by.values())} "
            f"registrations")
    return 100.0 * bound / t
