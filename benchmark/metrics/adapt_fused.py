"""Chunks a cycle whose adapt step ran as the two kernels of
``csrc/admm_adapt.cu`` (``adapt_check`` and ``adapt_rho``), from the
program's ``adapt_fused`` counter over the profiled cycles; with the
chunks a cycle (``host_reads.flags``, one read a chunk) beside it."""

from benchmark.spans import counts_a_cycle
from benchmark.spans import reset_counts as install  # noqa: F401


def read(ctx):
    c = counts_a_cycle()
    if c is None or "adapt_fused" not in c:
        return None
    out = {"value": c["adapt_fused"]}
    if "host_reads.flags" in c:
        out["chunks"] = c["host_reads.flags"]
    return out
