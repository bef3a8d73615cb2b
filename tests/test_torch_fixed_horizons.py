"""Port parity: the legacy cycle ``mpc_cycle_fixed`` at horizons 24 and 32 against JAX.

The legacy fixed-segment solver at horizon N runs the dense iterations
(``mpc/kernels.py::admm_iterations``; here on the CPU, its plain version) on
A (28 N, 12 N) for the condensed QP and (40 N, 24 N) for the full form: A
(672, 288) and (896, 384), (960, 576) and (1280, 768). On the card these are
``csrc/admm_dense.cu``'s on-chip and streamed instances; JAX runs its default
``use_pallas=False`` route. ``mpc_dt`` is the gait period over the horizon
(``EngineConfig.mpc_dt``), ``solver_iters=150``.

A carried state: B = 2 standing starts at two gait phases and x offsets run
one JAX cycle (the jitted vmapped cycle, compiled once: the start state is
strongly typed, as a cycle returns it), then one cycle runs in each package
from it. Bars as tests/test_torch_horizons.py: applied forces u0 within
2.0 N, plant q after the 20 ticks within 1e-2.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parity import to_port  # noqa: E402

from convex_mpc_tpu.control import gait as JG
from convex_mpc_tpu.models import dynamics as JD
from convex_mpc_tpu.sim import engine as JE
from convex_mpc_tpu.sim import physics as JP
from convex_mpc_tpu.utils import config as JCFG
from convex_mpc_tpu_torch.sim import engine as TE
from convex_mpc_tpu_torch.utils import config as TCFG

B = 2


def _kwargs(cfg_mod, horizon: int, formulation: str) -> dict:
    cfg = cfg_mod.EngineConfig(mpc=cfg_mod.MpcConfig(horizon=horizon))
    return dict(cfg_mod.engine_kwargs_fixed(cfg), solver_iters=150, formulation=formulation)


@pytest.mark.parametrize("formulation, horizon", [
    ("condensed", 24), ("condensed", 32), ("full", 24), ("full", 32)])
def test_mpc_cycle_fixed_horizon_matches_jax(formulation, horizon):
    jkw = _kwargs(JCFG, horizon, formulation)
    tkw = _kwargs(TCFG, horizon, formulation)
    assert tkw == jkw and jkw["n"] == horizon
    dyn = JD.build_dyn()
    contact = JP.default_contact(kn=30000, dn=1000)
    state = JE.init_state(dyn, n=horizon, formulation=formulation)._replace(
        plant=JP.init_plant(dyn, contact=contact))
    sb = JE.broadcast_batch(state, B)
    sb = sb._replace(plant=sb.plant._replace(q=sb.plant.q.at[:, 0].add(jnp.asarray([-0.01, 0.01]))),
                     t=jnp.asarray([0.0, 0.05], jnp.float32))
    sb = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), sb)
    args = (JE.broadcast_batch(JG.make_gait_params(3.0, 0.6), B), JE.broadcast_batch(contact, B),
            JE.broadcast_batch(JE.constant_schedule(vx=0.4, wz=0.3), B))
    jcycle = jax.jit(jax.vmap(lambda g, c, s, st: JE.mpc_cycle_fixed(dyn, g, c, s, st, **jkw)))
    sb, _ = jcycle(*args, sb)  # the carried cycle

    s1, l1 = jcycle(*args, sb)
    s2, l2 = TE.mpc_cycle_fixed(to_port(dyn), *[to_port(a) for a in args], to_port(sb), **tkw)
    n_vars, n_rows = (12 * horizon, 28 * horizon) if formulation == "condensed" else (
        24 * horizon, 40 * horizon)
    assert tuple(s2.solver.x.shape) == (B, n_vars) and tuple(s2.solver.z.shape) == (B, n_rows)
    du0 = np.abs(s2.u0.numpy() - np.asarray(s1.u0)).max()
    dq = np.abs(s2.plant.q.numpy() - np.asarray(s1.plant.q)).max()
    print(f"{formulation} horizon {horizon}: |du0| {du0:.4f} N, |dq| {dq:.2e}; iters jax "
          f"{np.asarray(l1.solver_iters)} port {l2.solver_iters.numpy()}")
    assert du0 < 2.0, du0  # Newtons
    assert dq < 1e-2, dq
    assert np.isfinite(s2.plant.q.numpy()).all()
