"""Matrices the KKT factorizations invert a cycle (``mpc/admm.py``: the
first factorization the whole batch, each refactor the scenarios whose rho
moved), from the program's ``kkt_rows`` counter over the profiled cycles;
with the rows a factorization beside it."""

from benchmark.spans import counts_a_cycle
from benchmark.spans import reset_counts as install  # noqa: F401


def read(ctx):
    c = counts_a_cycle()
    if c is None or "kkt_rows" not in c:
        return None
    out = {"value": c["kkt_rows"]}
    if c.get("kkt_factorizations"):
        out["per_factorization"] = c["kkt_rows"] / c["kkt_factorizations"]
    return out
