"""Port parity: the fused tick window (``sim/tick_fused.py``) against the JAX package.

Inputs: the battery of tests/test_tick_fused.py (a random mid-gait batch
covering swing/stance edges and contact), made from a numpy seed and passed
to both packages. Bars:

- ``_model_soa`` (the plain version's model with its ``torch.func.jvp``
  tangent) against JAX ``_model_soa``: every field within 1e-5 of its
  per-channel scale;
- ``run_ticks_fused`` (CPU tensors: the plain version) against
  ``jax.vmap(engine._run_ticks)``: 5e-3 over 20 ticks and 2e-4 over one
  tick, per-channel scales, integer fields exactly (the JAX suite's bars,
  tests/test_tick_fused.py); the same at duty = 1 (no leg swings, a zero
  swing time), also against the port's own ``engine._run_ticks``;
- the slice as a whole: the port's ``mpc_cycle_batch(use_fused_ticks=True)``
  against JAX ``mpc_cycle_batch(use_fused_ticks=True)`` (its Pallas kernel
  run by the interpreter) at B = 4 for two cycles: plant q and dq within
  5e-3 per channel, applied forces u0 within 2.0 N (the JAX suite's
  batched-vs-single bar). The JAX fused cycle does not trace under its own
  jit (ROADMAP.md §3), so its Python body is jitted with every keyword
  static.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parity import assert_close_scaled, t, to_port  # noqa: E402
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import launches  # noqa: E402
from test_tick_fused import _battery  # noqa: E402
from test_torch_ticks import _Traj, _assert_window, _jax_window, _port_window  # noqa: E402

from convex_mpc_tpu.control import gait as JG
from convex_mpc_tpu.models import dynamics as JD
from convex_mpc_tpu.sim import engine as JE
from convex_mpc_tpu.sim import physics as JP
from convex_mpc_tpu.sim import tick_fused as JTF
from convex_mpc_tpu.utils.config import DEFAULT_CONFIG as J_CONFIG
from convex_mpc_tpu.utils.config import engine_kwargs_batched as j_kwargs
from convex_mpc_tpu_torch.sim import engine as TE
from convex_mpc_tpu_torch.sim import tick_fused as TTF
from convex_mpc_tpu_torch.utils.config import DEFAULT_CONFIG, engine_kwargs_batched


def _port_fused(args, steps):
    dyn, gait, contact, cmd, traj, u0, plant, leg, yc, yp, vf, t0 = args
    ptraj = _Traj(t(traj.pos_des_world), t(traj.vel_des_world))
    return TTF.run_ticks_fused(
        to_port(dyn), to_port(gait), to_port(contact), to_port(cmd), ptraj, t(u0),
        to_port(plant), to_port(leg), t(yc), t(yp), t(vf), t(t0), steps, 45.0, 1e-3, 30.0,
    )


def test_model_soa_matches_jax():
    """The hand-written split-Jacobian model and its one tangent, batch-last."""
    args = _battery(B=6, seed=0)
    dyn, plant = args[0], args[6]
    q, dq = np.asarray(plant.q).T, np.asarray(plant.dq).T
    ref = jax.jit(JTF._model_soa)(JTF.make_consts(dyn, 45.0), jnp.asarray(q), jnp.asarray(dq))
    out = TTF._model_soa(TTF.make_consts(to_port(dyn), 45.0), t(q), t(dq))
    for f in ref._fields:
        a = getattr(out, f).numpy()
        d = np.broadcast_to(np.asarray(getattr(ref, f)), a.shape)
        # per-channel: the batch axis is last here, so channels are all leading axes
        scale = np.abs(d).reshape(-1, d.shape[-1]).max(axis=-1, keepdims=True) + 1e-6
        err = np.abs(a - d).reshape(-1, d.shape[-1])
        assert (err <= 1e-5 * scale).all(), (f, float((err / scale).max()))


# one compiled JAX window per (shapes, steps), shared by the cases below
_jax_window_jit = jax.jit(_jax_window, static_argnames=("steps",))


@pytest.mark.parametrize("B, seed, steps, rel", [(5, 0, 20, 5e-3), (5, 1, 20, 5e-3),
                                                 (4, 2, 1, 2e-4)],
                         ids=["20-ticks", "20-ticks-seed1", "one-tick"])
def test_run_ticks_fused_matches_jax(B, seed, steps, rel):
    """Two seeds of a 20-tick window at B = 5, and one tick at B = 4."""
    args = _battery(B=B, seed=seed)
    before = launches()
    _assert_window(_jax_window_jit(args, steps=steps), _port_fused(args, steps), rel)
    assert not any(launches(before).values())  # CPU tensors: the plain version


def test_fused_window_matches_port_tick_loop():
    """The fused window and the port's own tick loop (engine._run_ticks)
    agree at the same bar, and keep the (B, steps, ...) log layout."""
    args = _battery(B=3, seed=4)
    fused = _port_fused(args, 20)
    loop = _port_window(args, 20)
    to_np = lambda tree: jax.tree.map(lambda x: x.numpy(), tree)  # noqa: E731
    _assert_window(to_np(loop), fused, 5e-3)
    assert tuple(fused[1].force.shape) == (3, 20, 4, 3)
    assert fused[1].contact_mask.dtype == torch.int32


def test_fused_window_duty_one():
    """A duty = 1 gait: no leg ever swings and the swing time is 0, so the
    early-contact phase t_since / t_swing is inf or NaN (port tick_fused.py
    and csrc/tick_window.cu divide by the raw swing time, as JAX
    leg.compute_torques does; JAX tick_fused.py clamps it). It only gates
    swing legs, so the fused window matches both tick loops."""
    B = 4
    args = list(_battery(B=B, seed=6))
    args[1] = JE.broadcast_batch(JG.make_gait_params(3.0, 1.0), B)
    fused = _port_fused(args, 20)
    assert (fused[1].contact_mask == 1).all()
    _assert_window(_jax_window_jit(tuple(args), steps=20), fused, 5e-3)
    to_np = lambda tree: jax.tree.map(lambda x: x.numpy(), tree)  # noqa: E731
    _assert_window(to_np(_port_window(args, 20)), fused, 5e-3)


@pytest.fixture(scope="module")
def start_batch():
    """B = 4 standing starts at different gait phases, x offsets and small
    random body rates (numpy seed), as JAX trees."""
    dyn = JD.build_dyn()
    contact = JP.default_contact(kn=30000, dn=1000)
    state = JE.init_state(dyn, n=16)._replace(plant=JP.init_plant(dyn, contact=contact))
    B = 4
    sb = JE.broadcast_batch(state, B)
    rng = np.random.default_rng(12)
    sb = sb._replace(
        plant=sb.plant._replace(
            q=sb.plant.q.at[:, 0].add(jnp.linspace(-0.02, 0.02, B)),
            dq=jnp.asarray(rng.normal(0, 0.05, (B, 18)), jnp.float32)),
        t=jnp.asarray([0.0, 0.05, 0.11, 0.2], jnp.float32),
    )
    # strong types throughout, as a cycle returns them: the jitted cycle then
    # compiles once for both cycles
    sb = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), sb)
    args = (JE.broadcast_batch(JG.make_gait_params(3.0, 0.6), B), JE.broadcast_batch(contact, B),
            JE.broadcast_batch(JE.constant_schedule(vx=0.4, wz=0.3), B), sb)
    return dyn, args


def test_fused_cycle_matches_jax(start_batch):
    """Two production cycles with the fused window in both packages."""
    dyn, (gb, cb, scb, sb) = start_batch
    pdyn, pg, pc, psc, ps = to_port(dyn), to_port(gb), to_port(cb), to_port(scb), to_port(sb)
    jkw = dict(j_kwargs(J_CONFIG), use_fused_ticks=True)
    tkw = dict(engine_kwargs_batched(DEFAULT_CONFIG), use_fused_ticks=True)
    # JAX's fused window takes vel_filter_hz as a Python float (tick_fused.py:948
    # calls math.exp on it), which JE.mpc_cycle_batch's jit traces: jit its
    # Python body with every keyword static instead
    jax_cycle = jax.jit(JE.mpc_cycle_batch.__wrapped__, static_argnames=tuple(jkw))
    for cycle in range(2):
        sb, jlog = jax_cycle(dyn, gb, cb, scb, sb, **jkw)
        ps, tlog = TE.mpc_cycle_batch(pdyn, pg, pc, psc, ps, **tkw)
        print(f"cycle {cycle}: solver_iters jax {np.asarray(jlog.solver_iters)} "
              f"port {tlog.solver_iters.numpy()}")
        du0 = np.abs(ps.u0.numpy() - np.asarray(sb.u0)).max()
        assert du0 < 2.0, (cycle, du0)  # Newtons
        assert_close_scaled(ps.plant.q.numpy(), sb.plant.q, 5e-3, f"q, cycle {cycle}",
                            per_channel=True)
        assert_close_scaled(ps.plant.dq.numpy(), sb.plant.dq, 5e-3, f"dq, cycle {cycle}",
                            per_channel=True)
        assert tuple(tlog.ticks.q.shape) == (4, 20, 19)
