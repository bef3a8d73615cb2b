"""Kernel 2 (``csrc/admm_structured.cu``, the solve's ADMM iterations): its
share of the roofline. The work is the iterations each profiled cycle ran
on the whole batch (the largest of ``CycleLog.solver_iters``), the QP data
read once and the iterates written once a cycle."""

from benchmark.layers import admm_structured_share as read  # noqa: F401
