"""A per-scenario MPC step: BASELINE config 5's five horizon-16 gaits in one batch.

Config 5's gaits at horizon 16 have three periods (3.0, 3.5 and 2.5 Hz), so
their MPC steps (the period over the horizon: 1/48, 1/56 and 1/40 s) differ
by scenario. ``mpc_cycle_batch`` then takes ``mpc_dt`` as a (B,) float32
tensor, and the update's reference generation, contact table and
discretization use each row's own step.

(a) The three update functions with a (B,) step equal, in each row, the
same call with that row's step as a float.
(b) The five gaits, two scenarios each, run three production cycles
(fused ticks) in one batch of ten with a (B,) step, and each gait's
scenarios alone with their float step. Bars as tests/test_torch_gaits.py:
applied forces u0 within 2.0 N and plant q within 1e-2. The batch-global
solver runs every scenario until the slowest of the batch has converged,
so a scenario's iterate in the mixed batch differs from its run alone by up
to the solver's tolerance, not bit for bit.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from convex_mpc_tpu_torch.control import gait as G
from convex_mpc_tpu_torch.control import reference as R
from convex_mpc_tpu_torch.control import srb
from convex_mpc_tpu_torch.models import dynamics as D
from convex_mpc_tpu_torch.sim import engine as E
from convex_mpc_tpu_torch.sim import scenarios as S
from convex_mpc_tpu_torch.utils import profiling as PR
from convex_mpc_tpu_torch.utils.interop import tree_leaves, tree_map

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from torch_multi_config_bench import CONFIGS  # noqa: E402

CPU = torch.device("cpu")
N = 16
# config 5's horizon-16 entries: name, phase offsets, Hz, duty, vx
GAITS = [(name, po, hz, duty, vx) for name, po, hz, duty, n, vx in CONFIGS if n == N]
STEPS = (1 / 48, 1 / 56, 1 / 40)
# Bd and gd hold dt^2 / 2 (srb.discretize's E). As a float it is formed in
# float64 and rounded to float32 once; as a float32 tensor it is the
# product of two float32 numbers, so the two differ by an ulp of that
# factor, a few ulps of float32 after the contractions. Every other output
# takes the same float32 operations in both calls.
RTOL = 2.0**-20


@pytest.fixture(scope="module")
def dyn():
    return D.build_dyn(device=CPU)


def _gait(rows) -> G.GaitParams:
    """Each scenario's gait from its index into ``GAITS``."""
    table = [G.make_gait_params(hz, duty, po, device=CPU) for _, po, hz, duty, _ in GAITS]
    idx = torch.as_tensor(rows)
    return G.GaitParams(*(torch.stack(f).index_select(0, idx) for f in zip(*table)))


def _batch(dyn, rows, t0):
    """Scenarios of the gaits ``rows`` (indices into ``GAITS``): each
    gait's command, x offsets of +-1 cm, clocks ``t0``."""
    cmds = np.array([[GAITS[r][4], 0.0, 0.0] for r in rows], np.float32)
    b = S.make_batch(dyn, cmds, n_horizon=N)
    q = b.state.plant.q.clone()
    q[:, 0] += torch.linspace(-0.01, 0.01, len(rows))
    state = b.state._replace(plant=b.state.plant._replace(q=q),
                             t=torch.as_tensor(t0, dtype=torch.float32))
    return b._replace(gait=_gait(rows)), state


def _steps(rows) -> torch.Tensor:
    return torch.as_tensor([1.0 / GAITS[r][2] / N for r in rows], dtype=torch.float32)


def _assert_rows(mixed: tuple, alone: tuple, rows, close=False):
    """Each leaf of the trees ``mixed`` equal to ``alone``'s in ``rows``:
    bit for bit, or with ``close`` within a few float32 ulps of its largest
    entry."""
    flat = lambda trees: [x for t in trees for x in tree_leaves(t)]  # noqa: E731
    for a, b in zip(flat(mixed), flat(alone), strict=True):
        a, b = a.index_select(0, rows), b.index_select(0, rows)
        if close:
            torch.testing.assert_close(a, b, rtol=RTOL, atol=RTOL * float(b.abs().max()))
        else:
            assert torch.equal(a, b)


def _update_inputs(dyn):
    """Six scenarios of the three trots (three steps), mid-gait, with a
    braking velocity command carried in."""
    rows = [0, 1, 2, 2, 0, 1]
    b, state = _batch(dyn, rows, [0.013, 0.21, 0.377, 0.05, 0.6, 0.33])
    obs, _, _ = E.observe(dyn, state.plant, state.yaw_cont, state.yaw_prev, state.vel_filt)
    cmd = E.lookup_command(b.sched, state.t)
    refgen = state.refgen._replace(vel_cmd=torch.tensor([[0.9, 0.1, 1.0]]).expand(6, 3))
    return b.gait, obs, cmd, refgen, state.t, _steps(rows)


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("what", ["contact_table", "discretize", "generate",
                                  "generate_braking"])
def test_tensor_step_equals_float_rows(dyn, what, step):
    gait, obs, cmd, refgen, t, steps = _update_inputs(dyn)
    rows = torch.nonzero(steps == torch.tensor(step, dtype=torch.float32)).flatten()
    assert rows.numel() == 2

    if what == "contact_table":
        call = lambda dt: G.contact_table(gait, t, dt, N)  # noqa: E731
    elif what == "discretize":
        # foot levers that change along the horizon
        r = obs.foot_levers[:, None] * torch.linspace(0.9, 1.1, N)[:, None, None]
        call = lambda dt: srb.discretize(obs.x_vec[:, 5], r, obs.mass,  # noqa: E731
                                         obs.inertia_world, dt)
    else:
        brake = dict(brake_accel=1.5, brake_alpha=6.0) if what == "generate_braking" else {}
        call = lambda dt: R.generate(refgen, gait, obs, cmd, t, dt, N, **brake)  # noqa: E731
    mixed, alone = call(steps), call(step)

    if what == "contact_table":
        _assert_rows((mixed,), (alone,), rows)
        return
    dyn_m, dyn_a = (mixed, alone) if what == "discretize" else (mixed[0].dyn, alone[0].dyn)
    assert torch.equal(dyn_m.Ad.index_select(0, rows), dyn_a.Ad.index_select(0, rows))
    _assert_rows((dyn_m.Bd, dyn_m.gd), (dyn_a.Bd, dyn_a.gd), rows, close=True)
    if what != "discretize":
        _assert_rows((mixed[0]._replace(dyn=None), mixed[1]),
                     (alone[0]._replace(dyn=None), alone[1]), rows)


CYCLES = 3
KW = dict(n=N, solver_iters=1000, use_fused_ticks=True)


def _run(dyn, b, state, mpc_dt):
    """``CYCLES`` production cycles; the per-cycle (u0, plant q) and the
    ``mpc_dt_rows`` count a cycle."""
    PR.reset_counts()
    out = []
    for _ in range(CYCLES):
        state, _ = E.mpc_cycle_batch(dyn, b.gait, b.contact, b.sched, state, mpc_dt=mpc_dt, **KW)
        out.append((state.u0.clone(), state.plant.q.clone()))
    return out, PR.counts().get("mpc_dt_rows", 0) / CYCLES


@pytest.fixture(scope="module")
def mixed(dyn):
    """The five gaits, two scenarios each, in one batch of ten."""
    rows = [g for g in range(len(GAITS)) for _ in range(2)]
    b, state = _batch(dyn, rows, [0.0, 0.05] * len(GAITS))
    return rows, b, state, _run(dyn, b, state, _steps(rows))


@pytest.mark.parametrize("gait", [g[0] for g in GAITS])
def test_gait_mix_cycles_match_each_gait_alone(dyn, mixed, gait):
    rows, b, state, (got, per_cycle) = mixed
    assert len(GAITS) == 5 and per_cycle == len(rows)
    g = [g[0] for g in GAITS].index(gait)
    mine = torch.as_tensor([i for i, r in enumerate(rows) if r == g])
    pick = lambda tree: tree_map(lambda x: x.index_select(0, mine), tree)  # noqa: E731
    b1, s1 = pick(b), pick(state)
    # the gait alone: the same scenarios, one step as a float
    want, counted = _run(dyn, b1, s1, 1.0 / GAITS[g][2] / N)
    assert counted == 0
    for c, ((u_m, q_m), (u_a, q_a)) in enumerate(zip(got, want, strict=True)):
        du0 = float((u_m.index_select(0, mine) - u_a).abs().max())
        assert du0 < 2.0, (gait, c, du0)  # Newtons
        dq = float((q_m.index_select(0, mine) - q_a).abs().max())
        assert dq < 1e-2, (gait, c, dq)
        assert torch.isfinite(q_m).all()
