"""Device idle ms a cycle while the host is inside the solve (``mpc.solve``
spans), by the innermost ``mpc.solve.*`` span at each idle stretch's middle
(``idle_ms.<span>``), with the launches a cycle inside the solve; and the
idle ms a cycle inside ``mpc.cycle`` beside the window's, the share the
spans cover."""

from benchmark.spans import cycle_idle, stage_idle


def read(ctx):
    out = stage_idle(ctx, "solve")
    if out is None:
        return None
    return {**out, **(cycle_idle(ctx) or {})}
