"""Kernel 3 (``csrc/tick_window.cu``, the fused 20-tick apply stage): its
share of the roofline. The operations follow the legs' phases and contacts
that the profiled windows' logs show."""

from benchmark.layers import tick_window_share as read  # noqa: F401
