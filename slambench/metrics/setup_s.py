"""Process start to the window's start: the drive's simulation, the
program's import and kernel library load, and the warm-up drive."""

UNIT = "s"
SOURCE = "host_clock"


def read(ctx):
    return ctx.setup_s
