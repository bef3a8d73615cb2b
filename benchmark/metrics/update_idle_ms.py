"""Device idle ms a cycle while the host is inside the update (``mpc.update``
spans), by the innermost ``mpc.update.*`` span at each idle stretch's
middle, with the launches a cycle inside it; and the same two for the apply
stage (``mpc.apply``)."""

from benchmark.spans import stage_idle


def read(ctx):
    out = stage_idle(ctx, "update")
    if out is None:
        return None
    apply = stage_idle(ctx, "apply") or {}
    return {**out, "apply_idle_ms": apply.get("value"), "apply_launches": apply.get("launches"),
            **{k.replace("idle_ms.", "apply_idle_ms.", 1): v for k, v in apply.items()
               if k.startswith("idle_ms.")}}
