"""Share of the profiled window in which no work ran on the device:
100 (1 - busy union / window), the window on the host clock."""

from benchmark.layers import device_idle_pct


def read(ctx):
    return device_idle_pct(ctx)
