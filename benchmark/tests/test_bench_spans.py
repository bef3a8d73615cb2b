"""The readers of the program's spans and counters: ``benchmark/spans.py`` on
a made-up trace (idle time inside spans, by innermost span, launches inside
them), and a traced CPU run that reports the counter metrics, with the idle
metrics silent where there is no device work."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, spans
from benchmark.trace import Trace

from conftest import small_cell

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class Ev:
    """The few methods of a profiler event that ``Trace`` reads."""

    def __init__(self, name, start, end, device=CPU, corr=0):
        self._n, self._s, self._d, self._dev, self._c = name, start, end - start, device, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return 0


def _trace():
    """Two cycles of 100 ns. Device work at [0, 10], [30, 40], [60, 70] in
    each, and at [195, 200]; the host's spans: update [0, 20], solve [20, 80]
    with a chunk [25, 45] and a read [50, 65], apply [80, 95]; launches at
    26 and 55 (solve) and 85 (apply)."""
    ev = []
    for c in range(2):
        o = 100 * c
        ev += [Ev("mpc.cycle", o, o + 99), Ev("mpc.update", o, o + 20),
               Ev("mpc.update.observe", o, o + 12), Ev("mpc.solve", o + 20, o + 80),
               Ev("mpc.solve.chunk", o + 25, o + 45), Ev("mpc.solve.read.flags", o + 50, o + 65),
               Ev("mpc.apply", o + 80, o + 95),
               Ev("cudaLaunchKernel", o + 26, o + 28, corr=o + 1),
               Ev("cudaLaunchKernel", o + 55, o + 57, corr=o + 2),
               Ev("cudaLaunchKernel", o + 85, o + 86, corr=o + 3)]
        ev += [Ev("k", o + s, o + s + 10, CUDA, o + k + 1) for k, s in enumerate((0, 30, 60))]
    ev.append(Ev("k", 195, 200, CUDA, 7))
    return Trace(ev, 2, 200e-9)


def test_idle_by_span_and_launches():
    t = _trace()
    # gaps: [10, 30], [40, 60], [70, 100], [110, 130], [140, 160], [170, 195]
    assert [g for g, *_ in t.gaps] == [20, 20, 30, 20, 20, 25]
    idle, by, launches = spans.idle_in(t, "mpc.solve")
    # inside solve [20, 80]: [20, 30] + [40, 60] + [70, 80] = 40 a cycle
    assert idle == 80 and launches == 4
    # middles: 25 -> solve.chunk's start, 50 -> read.flags, 75 -> solve
    assert by == {"mpc.solve.chunk": 20, "mpc.solve.read.flags": 40, "mpc.solve": 20}
    idle_u, by_u, launches_u = spans.idle_in(t, "mpc.update")
    assert idle_u == 20 and by_u == {"mpc.update": 20} and launches_u == 0  # [10, 20] a cycle
    ctx = SimpleNamespace(trace=t)
    out = spans.stage_idle(ctx, "solve")
    assert out["value"] == pytest.approx(40e-6) and out["launches"] == 2
    assert out["idle_ms.mpc.solve.read.flags"] == pytest.approx(20e-6)
    # inside the cycles: 20 + 20 + 29 and 20 + 20 + 25; the window's idle 200 - 65
    cyc = spans.cycle_idle(ctx)
    assert cyc["cycle_idle_ms"] == pytest.approx(67e-6)
    assert cyc["window_idle_ms"] == pytest.approx(67.5e-6)
    apply = spans.stage_idle(ctx, "apply")
    assert apply["value"] == pytest.approx(15e-6) and apply["launches"] == 1
    assert spans.stage_idle(ctx, "nothing") is None


def test_no_device_work_reads_none():
    t = Trace([Ev("mpc.solve", 0, 10), Ev("mpc.cycle", 0, 20)], 1, 1e-6)
    assert spans.stage_idle(SimpleNamespace(trace=t), "solve") is None
    assert spans.cycle_idle(SimpleNamespace(trace=t)) is None


def test_traced_cpu_run_reports_the_counters():
    res = harness.run_cell(small_cell("h16_sweep1k.fused", batch=2), 2**31 + 91, 1.0, True,
                           torch.device("cpu"), time.perf_counter())
    assert res["correct"] is True
    m = res["metrics"]
    for name in ("kkt_factorizations.batch", "polish_solves.batch", "host_reads.batch"):
        assert m[name]["value"] > 0, name
    # every matrix handed to spd_inverse is a factorization or a polish solve
    k = m["kkt_factorizations.batch"]
    assert k["value"] + m["polish_solves.batch"]["value"] == k["spd_inverse_calls"]
    assert m["host_reads.batch"]["flags"] >= 1
    assert "solve_idle_ms.batch" not in m and "update_idle_ms.batch" not in m


def test_program_without_counters_reads_none(monkeypatch):
    """A program whose ``utils.profiling`` keeps no counters (an older one):
    the installer does nothing and the counter readers read None."""
    monkeypatch.setattr(spans, "profiling", SimpleNamespace())
    ctx = SimpleNamespace(trace=None, counters={})
    spans.reset_counts(ctx)
    assert spans.counts_a_cycle() is None
    for name in ("kkt_factorizations", "polish_solves", "host_reads"):
        assert harness.load_metric(harness.HERE / "metrics", name).read(ctx) is None
