"""Scenario-cycles completed in the window over its wall seconds, the window
ending in a device synchronization."""


def read(ctx):
    return ctx.attempted / ctx.window_s if ctx.window_s > 0 else None
