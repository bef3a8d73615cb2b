"""Chunks a cycle whose kernel 2 (``csrc/admm_structured.cu``) ran more than
one scenario in each CTA, from the program's ``admm_slotted`` counter over
the profiled cycles (one count a launch on the multi-slot route, nz > 256);
with the chunks a cycle (``host_reads.flags``, one read a chunk) beside it.
A program without the counter reads nothing."""

from benchmark.spans import counts_a_cycle
from benchmark.spans import reset_counts as install  # noqa: F401


def read(ctx):
    c = counts_a_cycle()
    if c is None or "admm_slotted" not in c:
        return None
    out = {"value": c["admm_slotted"]}
    if "host_reads.flags" in c:
        out["chunks"] = c["host_reads.flags"]
    return out
