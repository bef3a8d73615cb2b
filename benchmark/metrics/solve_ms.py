"""Host milliseconds a cycle of the solve stage (``mpc_cycle_batch(profile=)``)."""

from benchmark.layers import stage_ms


def read(ctx):
    return stage_ms(ctx, "solve")
