"""KKT factorizations a cycle (``mpc/admm.py::_factorize``: the first and
each refactor), from the program's counter over the profiled cycles. Beside
it, where the benchmark counts the solve's ``spd_inverse`` calls for kernel
1's roofline, those calls a cycle: factorizations and polish solves add up
to them."""

from benchmark.spans import counts_a_cycle
from benchmark.spans import reset_counts as install  # noqa: F401


def read(ctx):
    c = counts_a_cycle()
    if c is None:
        return None
    out = {"value": c.get("kkt_factorizations", 0.0)}
    calls = ctx.counters.get("spd_inverse")
    if calls is not None and ctx.trace is not None and ctx.trace.cycles > 0:
        out["spd_inverse_calls"] = len(calls) / ctx.trace.cycles
    return out
