"""Scenarios a cycle whose update ran on its own MPC step (a (B,) ``mpc_dt``:
a batch of gaits of different periods over one horizon), from the program's
``mpc_dt_rows`` counter of ``sim/engine.py::cycle_update`` over the profiled
cycles. A program without the counter, or one handed a single step, reads
nothing."""

from benchmark.spans import counts_a_cycle
from benchmark.spans import reset_counts as install  # noqa: F401


def read(ctx):
    c = counts_a_cycle()
    if c is None or "mpc_dt_rows" not in c:
        return None
    return c["mpc_dt_rows"]
