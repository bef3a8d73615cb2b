"""Profiling and observability hooks.

Port of ``convex_mpc_tpu/utils/profiling.py``:

- :func:`trace` wraps a region with ``torch.profiler`` (CPU and CUDA
  activities) and writes a Chrome trace, viewable in Perfetto or
  ``chrome://tracing``;
- :func:`time_fn` measures the steady-state wall time of a callable (the
  first call excluded, best-of-k windows against host interference);
- :class:`SolveStats` accumulates per-cycle solver iteration / residual
  counters from engine logs (``CycleLog``);
- :func:`device_busy_ms` is the union of the device intervals in a trace;
- :func:`span` names a stretch of the host's work in a ``torch.profiler``
  trace, and :func:`count` / :func:`counts` / :func:`reset_counts` keep the
  production cycle's counts of its work (``mpc_cycle_batch`` and what it
  calls: cycles, KKT factorizations, polish attempts and solves, host reads).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir):
    """Trace the enclosed region with ``torch.profiler``; yields the profiler.

    CPU activity always, CUDA activity when the process has a CUDA device.
    On exit the Chrome trace is written to ``log_dir/trace.json``; the
    profiler's ``events()`` stay readable after the region.
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


_NULL_SPAN = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context naming the enclosed host work ``name`` in a ``torch.profiler``
    trace; the span that encloses it on the host thread is its parent.

    With no profiler running it returns one shared null context and records
    nothing. Under the profiler it records a host-only event (a plain
    ``cpu_op``, not a user annotation: ``record_function``'s annotations are
    mirrored onto the device's track, where they would read as device
    work), on the clock the device events use. It never synchronizes.
    """
    if not _profiler_enabled():
        return _NULL_SPAN
    return _RecordFunctionFast(name)


_COUNTS: dict[str, int] = {}


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the counter ``name`` (a plain int, always on)."""
    _COUNTS[name] = _COUNTS.get(name, 0) + k


def counts() -> dict[str, int]:
    """A copy of the counters."""
    return dict(_COUNTS)


def reset_counts() -> None:
    """Set every counter back to zero."""
    _COUNTS.clear()


def device_busy_ms(prof) -> float:
    """Union length (ms) of the device intervals (kernels, copies) in a trace."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def _sync(out) -> None:
    """Wait for the devices that hold ``out``'s tensors (nothing for the CPU)."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _sync(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _sync(v)


def time_fn(fn, *args, windows: int = 3, reps: int = 5) -> float:
    """Steady-state seconds per call of ``fn(*args)`` (best window mean).

    One warm call, then ``windows`` windows of ``reps`` calls; each window
    ends by synchronizing the device of the result (``torch.cuda.synchronize``
    for CUDA tensors, nothing for the CPU).
    """
    out = fn(*args)
    _sync(out)
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        _sync(out)
        best = min(best, (time.perf_counter() - t0) / reps)
    return best


def _host(v) -> list:
    return np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v).ravel().tolist()


@dataclass
class SolveStats:
    """Accumulates solver telemetry from engine CycleLogs."""

    iters: list = field(default_factory=list)
    prim: list = field(default_factory=list)
    dual: list = field(default_factory=list)
    max_iter: int = 0

    def update(self, logs, max_iter: int):
        self.iters.extend(_host(logs.solver_iters))
        self.prim.extend(_host(logs.prim_res))
        self.dual.extend(_host(logs.dual_res))
        self.max_iter = max(self.max_iter, max_iter)

    def summary(self) -> dict:
        it = np.asarray(self.iters)
        if it.size == 0:
            return {}
        return {
            "cycles": int(it.size),
            "iters_mean": float(it.mean()),
            "iters_p50": float(np.percentile(it, 50)),
            "iters_p95": float(np.percentile(it, 95)),
            "converged_frac": float((it < self.max_iter).mean()) if self.max_iter else None,
            "prim_res_p95": float(np.percentile(np.asarray(self.prim), 95)),
            "dual_res_p95": float(np.percentile(np.asarray(self.dual), 95)),
        }
