"""Seconds from the process's start to the end of warm-up: imports, the
card, the kernel library (built on a checkout's first run), weights,
calibration, convert and the warm-up forwards (host clock)."""


def read(ctx):
    return ctx.setup_s
