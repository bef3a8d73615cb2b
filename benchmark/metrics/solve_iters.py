"""Mean ADMM iterations a scenario a cycle (``CycleLog.solver_iters``)."""


def read(ctx):
    return None if ctx.iters.size == 0 else float(ctx.iters.mean())
