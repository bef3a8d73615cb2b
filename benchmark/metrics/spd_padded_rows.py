"""Matrices kernel 1 inverts on a panel grid larger than their order, a
cycle (``ops/chol_kernel.py``'s ``spd_inverse.padded`` counter over the
profiled cycles), with ``pad_ops_pct`` beside it: the pad's share of the
operations kernel 1 runs, 100 pad / (n^3 + pad) from ``spd_inverse.pad_ops``
and ``spd_inverse.ops``. A program without these counters reads None."""

from benchmark.spans import counts_a_cycle
from benchmark.spans import reset_counts as install  # noqa: F401


def read(ctx):
    c = counts_a_cycle()
    if c is None or "spd_inverse.padded" not in c:
        return None
    out = {"value": c["spd_inverse.padded"]}
    ops, pad = c.get("spd_inverse.ops", 0.0), c.get("spd_inverse.pad_ops", 0.0)
    if ops + pad > 0:
        out["pad_ops_pct"] = 100.0 * pad / (ops + pad)
    return out
