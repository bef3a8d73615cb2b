"""The production cycle's spans and counters (``utils/profiling.py``): the
spans off outside the profiler, every stage and solve phase named inside
``mpc.cycle`` as host-only events, the cycle's result unchanged by the
profiler, and the counts of KKT factorizations, polish solves and host
reads against what the solve's own calls show. B = 2 on the CPU, two
production cycles from one start (one traced) and one snap-first solve."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import start_batch  # noqa: E402

from convex_mpc_tpu_torch.mpc import admm, kernels  # noqa: E402
from convex_mpc_tpu_torch.sim import engine as E  # noqa: E402
from convex_mpc_tpu_torch.utils import config as C  # noqa: E402
from convex_mpc_tpu_torch.utils import interop  # noqa: E402
from convex_mpc_tpu_torch.utils import profiling as PR  # noqa: E402

# the spans of every production cycle, and the span each lies inside
SPANS = {
    "mpc.cycle": None,
    "mpc.update": "mpc.cycle",
    "mpc.update.observe": "mpc.update",
    "mpc.update.reference": "mpc.update",
    "mpc.update.condense": "mpc.update",
    "mpc.solve": "mpc.cycle",
    "mpc.solve.setup": "mpc.solve",
    "mpc.solve.factor": "mpc.solve",
    "mpc.solve.chunk": "mpc.solve",
    "mpc.solve.adapt": "mpc.solve",
    "mpc.solve.read.want_polish": "mpc.solve",
    "mpc.solve.read.flags": "mpc.solve",
    "mpc.solve.polish": "mpc.solve",
    "mpc.solve.polish.round": "mpc.solve.polish",
    "mpc.solve.finish": "mpc.solve",
    "mpc.apply": "mpc.cycle",
    "mpc.apply.ticks": "mpc.apply",
    "mpc.apply.carry": "mpc.apply",
}
# spans a cycle has only when its work happens
SOMETIMES = {"mpc.solve.read.ladder": "mpc.solve.polish"}


def _calls(module, attr, box):
    """Wrap ``module.attr`` so each call appends to ``box``; returns the restorer."""
    inner = getattr(module, attr)

    def counted(*args, **kwargs):
        box.append(1)
        return inner(*args, **kwargs)

    setattr(module, attr, counted)
    return lambda: setattr(module, attr, inner)


@pytest.fixture(scope="module")
def cycles():
    """Two production cycles from one start, the second under a CPU profiler:
    the states, the profiler's events, and per cycle the counters' change
    and the solve's own calls of ``spd_inverse`` and of the ADMM chunk."""
    torch.set_num_threads(2)
    kw = C.engine_kwargs_batched(C.DEFAULT_CONFIG)
    dyn, gait, contact, sched, state0 = start_batch(2, torch.device("cpu"))
    spd, chunks = [], []
    undo = [_calls(admm, "spd_inverse", spd),
            _calls(kernels, "admm_iterations_structured", chunks)]
    PR.reset_counts()
    out = []
    try:
        for traced in (False, True):
            before = PR.counts()
            n_spd, n_chunks = len(spd), len(chunks)
            if traced:
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                    state, log = E.mpc_cycle_batch(dyn, gait, contact, sched, state0, **kw)
                events = prof.profiler.kineto_results.events()
            else:
                state, log = E.mpc_cycle_batch(dyn, gait, contact, sched, state0, **kw)
                events = None
            after = PR.counts()
            delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
            out.append(dict(state=state, log=log, events=events, counts=delta,
                            spd=len(spd) - n_spd, chunks=len(chunks) - n_chunks))
    finally:
        for u in undo:
            u()
    return dict(runs=out, totals=PR.counts(), spd=len(spd), kw=kw)


def test_span_off_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = PR.span("mpc.cycle"), PR.span("mpc.solve")
    assert a is b
    with a:
        pass


def test_counters():
    PR.reset_counts()
    PR.count("x")
    PR.count("x", 3)
    c = PR.counts()
    assert c == {"x": 4}
    c["x"] = 0
    assert PR.counts() == {"x": 4}
    PR.reset_counts()
    assert PR.counts() == {}


def test_spans_nest_inside_the_cycle(cycles):
    events = cycles["runs"][1]["events"]
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
             if e.name().startswith("mpc.")]
    names = {n for _, _, n in spans}
    assert set(SPANS) <= names, set(SPANS) - names
    assert names <= set(SPANS) | set(SOMETIMES), names - set(SPANS) - set(SOMETIMES)
    assert ("mpc.solve.read.ladder" in names) == (
        cycles["runs"][1]["counts"].get("host_reads.ladder", 0) > 0)
    for e in events:
        if e.name().startswith("mpc."):
            assert e.device_type() == torch.autograd.DeviceType.CPU
            assert not e.is_user_annotation(), e.name()
    parents = {**SPANS, **SOMETIMES}
    for s, e, n in spans:
        if parents[n] is None:
            continue
        assert any(ps <= s and e <= pe for ps, pe, pn in spans if pn == parents[n]), n
    assert sum(n == "mpc.cycle" for _, _, n in spans) == 1


def test_profiler_leaves_the_cycle_unchanged(cycles):
    off, on = cycles["runs"]
    for key in ("state", "log"):
        a_leaves, b_leaves = interop.tree_leaves(off[key]), interop.tree_leaves(on[key])
        assert len(a_leaves) == len(b_leaves) > 0
        for a, b in zip(a_leaves, b_leaves):
            assert torch.equal(a, b)


def test_counts_match_the_solves_own_calls(cycles):
    tot = cycles["totals"]
    assert tot["cycles"] == 2
    assert tot["kkt_factorizations"] + tot["polish_solves"] == cycles["spd"]
    assert tot["polish_rows"] == 2 * tot["polish_solves"]  # B = 2, no compaction
    cap = cycles["kw"]["solver_iters"] // cycles["kw"]["check_every"]
    for run in cycles["runs"]:
        c, chunks = run["counts"], run["chunks"]
        assert chunks == int(run["log"].solver_iters.max()) // cycles["kw"]["check_every"]
        assert c["host_reads.flags"] == chunks
        assert c.get("host_reads.want_polish", 0) == chunks - (chunks == cap)
        assert c["polish_attempts"] >= 1 and c["kkt_factorizations"] >= 1
        assert c["kkt_factorizations"] + c["polish_solves"] == run["spd"]
        assert 2 <= c["kkt_rows"] <= 2 * c["kkt_factorizations"]  # B = 2: all, then those moved
        assert c.get("host_reads.ladder", 0) <= c["polish_solves"]


def test_snap_first_count_read_once_per_polish():
    """The snap proposal's host read: once per polish attempt (B = 2 < 16, so
    the ladder runs on the whole batch and no rows are gathered)."""
    kw = C.engine_kwargs_batched(C.DEFAULT_CONFIG)
    dyn, gait, contact, sched, state = start_batch(2, torch.device("cpu"))
    qd = torch.as_tensor(kw["q_diag"], dtype=torch.float32)
    data = E.cycle_update(dyn, gait, sched, state, qd, kw["n"], kw["mpc_dt"], kw["r_value"],
                          kw["mu_mpc"], kw["fz_min"])[0]
    PR.reset_counts()
    admm.solve_adaptive(data, state.solver, max_iter=kw["solver_iters"], box_tail=kw["n"] * 12,
                        nu=12, snap_first=True)
    c = PR.counts()
    assert c["polish_attempts"] >= 1
    assert c["host_reads.snap_count"] == c["polish_attempts"]
    assert "host_reads.snap_rows" not in c
