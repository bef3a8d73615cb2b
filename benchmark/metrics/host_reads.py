"""Blocking reads of device values by the host a cycle (the solve's
batch-global decisions: ``host_reads.<site>`` counters of
``mpc/admm.py``), from the program's counters over the profiled cycles;
with the reads a cycle at each site."""

from benchmark.spans import counts_a_cycle
from benchmark.spans import reset_counts as install  # noqa: F401

PREFIX = "host_reads."


def read(ctx):
    c = counts_a_cycle()
    if c is None:
        return None
    sites = {k[len(PREFIX):]: v for k, v in sorted(c.items()) if k.startswith(PREFIX)}
    return {"value": sum(sites.values()), **sites}
