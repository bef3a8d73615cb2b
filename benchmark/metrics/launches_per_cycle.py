"""Calls a cycle that put work on the device's queue (kernel and graph
launches, copies, fills), from the profiler's trace; a graph launch counts
once, and device work with no such call in the trace counts once too."""

from benchmark.layers import launches_per_cycle


def read(ctx):
    return launches_per_cycle(ctx)
