"""Reading a ``torch.profiler`` trace of a few cycles: device busy time,
kernel times by name, host launches, and where the device sat idle.

Only the profiler's own event list is read (``kineto_results.events()``);
nothing is written to disk.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

# host-side calls that put work on the device's queue
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cuGraphLaunch",
                   "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")
TOP = 10


class Trace:
    """The device and host events of ``cycles`` profiled cycles, the host
    clock's length of that window, and the sums read from them."""

    def __init__(self, events, cycles: int, window_s: float):
        self.cycles = cycles
        self.window_s = window_s
        dev = torch.autograd.DeviceType.CUDA
        self.device = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                               e.correlation_id(), e.linked_correlation_id())
                              for e in events if e.device_type() == dev), key=lambda d: d[0])
        host = [e for e in events if e.device_type() != dev]
        launch = [e for e in host if e.name().startswith(LAUNCH_PREFIXES)]
        self.host_launches = len(launch)
        known = {e.correlation_id() for e in launch}
        # device work whose enqueueing call the trace does not show (a
        # launch from a library that the runtime's callbacks do not see)
        self.unmatched_device = sum(1 for d in self.device
                                    if d[3] not in known and d[4] not in known)
        self.host = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                            for e in host if e.duration_ns() > 0), key=lambda h: h[0])
        self.busy_s, self.gaps = self._union()

    def _union(self):
        busy, gaps = 0, []
        cur_s = cur_e = None
        for s, e, *_ in self.device:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((s - cur_e, cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy / 1e9, gaps

    @property
    def launches(self) -> int:
        """Calls that enqueue device work (a graph launch counts once), and
        device work no call in the trace accounts for."""
        return self.host_launches + self.unmatched_device

    def kernel_s(self, names) -> float:
        """Device seconds of the kernels whose name contains one of ``names``."""
        return sum(e - s for s, e, n, *_ in self.device if any(k in n for k in names)) / 1e9

    def device_ops(self) -> list:
        tot = defaultdict(int)
        for s, e, n, *_ in self.device:
            tot[n[:160]] += e - s
        return [[n, t / 1e9] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]

    def _host_at(self, t_ns: int) -> str:
        """The innermost host event running at ``t_ns`` (host events nest, so
        the latest one started that has not ended)."""
        i = bisect.bisect_right(self.host, (t_ns, float("inf"), ""))
        for j in range(i - 1, max(i - 64, -1), -1):
            s, e, n = self.host[j]
            if e >= t_ns:
                return n[:160]
        return "(no host op: Python between operations)"

    def idle_gaps(self) -> list:
        """The idle time between device work, summed by the host operation
        running in the middle of each gap."""
        tot = defaultdict(int)
        for g, s, e in self.gaps:
            tot[self._host_at((s + e) // 2)] += g
        return [[n, t / 1e9] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]


def profile_cycles(run_cycle, cycles: int, device) -> Trace:
    """Run ``run_cycle()`` ``cycles`` times under ``torch.profiler`` (host and,
    on a CUDA ``device``, device activity); the window is timed on the host
    clock between two device synchronizations."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    sync = lambda: None  # noqa: E731
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        sync = lambda: torch.cuda.synchronize(device)  # noqa: E731
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(cycles):
            run_cycle()
        sync()
        window_s = time.perf_counter() - t0
    return Trace(prof.profiler.kineto_results.events(), cycles, window_s)
