"""Seconds from the process's start to the first timed cycle: imports,
loading (and in a checkout's first run, building) the kernels, making the
batch, and the warm-up cycles."""


def read(ctx):
    return ctx.setup_s
