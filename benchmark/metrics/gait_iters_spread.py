"""How far one gait's scenarios set the batch-global solve's length: the
largest per-gait mean of the ADMM iterations a scenario a cycle
(``CycleLog.solver_iters`` over the window's cycles) over the smallest,
with the scenarios grouped by their gait (``ctx.gaits``); each gait's mean
beside it, as ``iters.<gait>``. A batch of one gait reads 1."""

import numpy as np


def read(ctx):
    iters = np.asarray(ctx.iters, dtype=np.float64)
    gaits = np.asarray(getattr(ctx, "gaits", ()))
    if iters.size == 0 or gaits.size == 0:
        return None
    per_row = iters.reshape(-1, gaits.size).mean(0)
    means = {str(g): float(per_row[gaits == g].mean()) for g in np.unique(gaits)}
    low = min(means.values())
    if low <= 0:
        return None
    return {"value": max(means.values()) / low, **{f"iters.{g}": v for g, v in means.items()}}
