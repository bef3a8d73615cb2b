"""The polish's reduced solves a cycle (``mpc/admm.py::_polish_core`` with
``reduced=True``, one ``spd_inverse`` each), from the program's counters over
the profiled cycles; with the rows they solved and the polish attempts, a
cycle."""

from benchmark.spans import counts_a_cycle
from benchmark.spans import reset_counts as install  # noqa: F401


def read(ctx):
    c = counts_a_cycle()
    if c is None:
        return None
    return {"value": c.get("polish_solves", 0.0), "rows": c.get("polish_rows", 0.0),
            "attempts": c.get("polish_attempts", 0.0)}
