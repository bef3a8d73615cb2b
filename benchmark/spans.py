"""Reading the program's own spans and counters in the traced run.

The program names the stages and solve phases of ``mpc_cycle_batch`` with
host-only spans (``mpc.cycle``, ``mpc.update``, ``mpc.solve``, ``mpc.apply``
and their children ``mpc.<stage>.*``) on the clock of the profiler's device
events, and counts its work in ``utils.profiling.counts()``. Here the
device's idle gaps (``Trace.gaps``) are put down to the spans running on the
host, and the counts are taken a cycle. A program without the spans or the
counters reads None, and nothing raises.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from benchmark.trace import LAUNCH_PREFIXES
from convex_mpc_tpu_torch.utils import profiling


def reset_counts(ctx) -> None:
    """Start the program's counters from zero (a reader's ``install``, which
    runs just before the profiled cycles)."""
    reset = getattr(profiling, "reset_counts", None)
    if reset is not None:
        reset()


def counts_a_cycle() -> dict | None:
    """The program's counters over the profiled cycles, each divided by the
    cycles it counted; None where the program keeps no counters."""
    read = getattr(profiling, "counts", None)
    if read is None:
        return None
    c = read()
    cycles = c.get("cycles", 0)
    if cycles <= 0:
        return None
    return {k: v / cycles for k, v in c.items() if k != "cycles"}


def intervals(trace, name: str) -> list[tuple[int, int]]:
    """Host intervals (ns) of the spans called ``name``, by start."""
    return [(s, e) for s, e, n in trace.host if n == name]


def _innermost(spans, points):
    """For each of the sorted ``points``, the name of the innermost of
    ``spans`` ((start, end, name) by start, properly nested) running there,
    or None."""
    out, stack, i = [], [], 0
    for t in points:
        while i < len(spans) and spans[i][0] <= t:
            s, e, n = spans[i]
            while stack and stack[-1][1] < s:
                stack.pop()
            stack.append((s, e, n))
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def idle_in(trace, name: str):
    """Device idle time inside the host intervals of the spans ``name``:
    (idle ns in all, idle ns by the innermost ``name`` or ``name.*`` span at
    the middle of each idle stretch, host launches that start inside)."""
    iv = intervals(trace, name)
    starts = [s for s, _ in iv]
    pieces = []  # (middle, ns) of each gap's part inside a span
    for _, gs, ge in trace.gaps:
        j = max(bisect.bisect_right(starts, gs) - 1, 0)
        while j < len(iv) and iv[j][0] < ge:
            lo, hi = max(gs, iv[j][0]), min(ge, iv[j][1])
            if hi > lo:
                pieces.append(((lo + hi) // 2, hi - lo))
            j += 1
    pieces.sort()
    # outer before inner where two start together
    family = sorted((h for h in trace.host if h[2] == name or h[2].startswith(name + ".")),
                    key=lambda h: (h[0], -h[1]))
    by = defaultdict(int)
    for (_, ns), who in zip(pieces, _innermost(family, [m for m, _ in pieces])):
        by[who or name] += ns
    launches = 0
    for s, _, n in trace.host:
        if n.startswith(LAUNCH_PREFIXES):
            j = bisect.bisect_right(starts, s) - 1
            launches += j >= 0 and s <= iv[j][1]
    return sum(ns for _, ns in pieces), dict(by), launches


def stage_idle(ctx, stage: str) -> dict | None:
    """Idle ms a cycle inside ``mpc.<stage>`` spans, with the launches a
    cycle inside them and the idle ms a cycle by innermost span; None where
    the trace has no device work or no such span."""
    t = ctx.trace
    if t is None or not t.device or t.cycles <= 0 or not intervals(t, f"mpc.{stage}"):
        return None
    idle, by, launches = idle_in(t, f"mpc.{stage}")
    per = lambda ns: ns / 1e6 / t.cycles  # noqa: E731
    return {"value": per(idle), "launches": launches / t.cycles,
            **{f"idle_ms.{n}": per(ns) for n, ns in sorted(by.items(), key=lambda kv: -kv[1])}}


def cycle_idle(ctx) -> dict | None:
    """Idle ms a cycle inside ``mpc.cycle`` spans beside the window's idle ms
    a cycle (window less busy union, as ``device_idle_pct`` counts it)."""
    t = ctx.trace
    if t is None or not t.device or t.cycles <= 0 or not intervals(t, "mpc.cycle"):
        return None
    idle, _, _ = idle_in(t, "mpc.cycle")
    return {"cycle_idle_ms": idle / 1e6 / t.cycles,
            "window_idle_ms": 1e3 * (t.window_s - t.busy_s) / t.cycles}
