"""Kernel 1 (``csrc/spd_inverse.cu``, the KKT inverse and the polish's
reduced solve): its share of the roofline. The work is the matrices the
solve inverted in the profiled cycles, counted at the solver's calls of
``spd_inverse``, each n^3 operations and 2 n^2 floats."""

from benchmark.layers import spd_inverse_install as install  # noqa: F401
from benchmark.layers import spd_inverse_share as read  # noqa: F401
