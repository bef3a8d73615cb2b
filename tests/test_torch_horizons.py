"""Port parity at longer horizons: ``mpc_cycle_batch`` at horizons 24 and 32 against JAX.

At horizon 24 the condensed QP has nz = 288 (nb = 96 friction blocks), at
32 nz = 384 (nb = 128), both multiples of 32, so the solver factors its KKT
matrix with ``spd_inverse`` and runs the structured chunk at nb = 96 or 128:
on the card, ``spd_inverse.cu`` with its working set on chip (288) or in
device memory (384) and ``admm_structured.cu`` in clusters of 2 or 3 CTAs;
here on the CPU, their plain versions. ``mpc_dt`` is the gait period over
the horizon (``EngineConfig.mpc_dt``), as ``tools/multi_config_bench.py``
sets it.

A carried state: B = 2 standing starts at two gait phases and x offsets run
3 JAX cycles (the one jitted cycle, compiled once: the start state is
strongly typed, as a cycle returns it), then one cycle runs in each package.
Bars as tests/test_torch_engine.py: applied forces u0 within 2.0 N (the JAX
suite's batched-vs-single bar), plant q after the 20 ticks within 1e-2.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parity import to_port  # noqa: E402

from convex_mpc_tpu.control import gait as JG
from convex_mpc_tpu.models import dynamics as JD
from convex_mpc_tpu.sim import engine as JE
from convex_mpc_tpu.sim import physics as JP
from convex_mpc_tpu.utils import config as JCFG
from convex_mpc_tpu_torch.sim import engine as TE
from convex_mpc_tpu_torch.utils import config as TCFG

CARRY_CYCLES = 3


def _carried(horizon: int):
    jkw = JCFG.engine_kwargs_batched(JCFG.EngineConfig(mpc=JCFG.MpcConfig(horizon=horizon)))
    dyn = JD.build_dyn()
    contact = JP.default_contact(kn=30000, dn=1000)
    state = JE.init_state(dyn, n=horizon)._replace(plant=JP.init_plant(dyn, contact=contact))
    B = 2
    sb = JE.broadcast_batch(state, B)
    sb = sb._replace(plant=sb.plant._replace(q=sb.plant.q.at[:, 0].add(jnp.asarray([-0.01, 0.01]))),
                     t=jnp.asarray([0.0, 0.05], jnp.float32))
    sb = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), sb)
    args = (JE.broadcast_batch(JG.make_gait_params(3.0, 0.6), B), JE.broadcast_batch(contact, B),
            JE.broadcast_batch(JE.constant_schedule(vx=0.5), B))
    for _ in range(CARRY_CYCLES):
        sb, _ = JE.mpc_cycle_batch(dyn, *args, sb, **jkw)
    return dyn, args, sb, jkw


def _cycle_matches_jax(horizon: int):
    dyn, args, sb, jkw = _carried(horizon)
    tkw = TCFG.engine_kwargs_batched(TCFG.EngineConfig(mpc=TCFG.MpcConfig(horizon=horizon)))
    assert tkw["n"] == jkw["n"] == horizon and tkw["mpc_dt"] == jkw["mpc_dt"]
    s1, l1 = JE.mpc_cycle_batch(dyn, *args, sb, **jkw)
    s2, l2 = TE.mpc_cycle_batch(to_port(dyn), *[to_port(a) for a in args], to_port(sb), **tkw)
    print("solver_iters jax", np.asarray(l1.solver_iters), "port", l2.solver_iters.numpy())
    assert tuple(s2.solver.x.shape) == (2, 12 * horizon)
    du0 = np.abs(s2.u0.numpy() - np.asarray(s1.u0)).max()
    assert du0 < 2.0, du0  # Newtons
    dq = np.abs(s2.plant.q.numpy() - np.asarray(s1.plant.q)).max()
    assert dq < 1e-2, dq
    assert np.isfinite(s2.plant.q.numpy()).all()


def test_horizon24_cycle_matches_jax():
    _cycle_matches_jax(24)


def test_horizon32_cycle_matches_jax():
    """nz = 384: kernel 1's device-memory route and kernel 2 at nb = 128 on
    the card; here their plain versions against JAX."""
    _cycle_matches_jax(32)
