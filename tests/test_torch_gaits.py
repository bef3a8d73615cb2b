"""Port parity on BASELINE config 5's new shapes: horizon 10, the bound and the pace gait.

``tools/torch_multi_config_bench.py`` runs three configurations no other
port test drives through ``mpc_cycle_batch``: trot at horizon 10 (nz = 120,
nb = 40: JAX's KKT inverse takes its own non-kernel branch, nz % 32 != 0;
on the card the port's kernel 1 pads it to 128 and the structured chunk
runs its generic instance) and the bound
and pace gaits at horizon 16 (``make_gait_params(phase_offset=...)``). Each
runs as the tool runs it: default contact, ``solver_iters`` 1000, ``mpc_dt``
the gait period over the horizon, vx 0.5 (trot) or 0.3 (bound, pace).

A carried state: B = 2 standing starts at two gait phases and x offsets run
2 JAX cycles, then 2 cycles run in each package from that state. Bars as
tests/test_torch_horizons.py: applied forces u0 within 2.0 N (the JAX
suite's batched-vs-single bar), plant q after each cycle's 20 ticks within
1e-2.
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
from convex_mpc_tpu_torch.sim import engine as TE

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from torch_multi_config_bench import CONFIGS  # noqa: E402

CARRY_CYCLES = 2
CYCLES = 2
CASES = ("trot_n10", "bound_n16", "pace_n16")


@pytest.fixture(scope="module")
def dyn():
    return JD.build_dyn()


@pytest.mark.parametrize("name", CASES)
def test_config_cycles_match_jax(dyn, name):
    _, po, freq, duty, n, vx = next(c for c in CONFIGS if c[0] == name)
    kw = dict(n=n, solver_iters=1000, mpc_dt=(1.0 / freq) / n)
    contact = JP.default_contact()
    B = 2
    sb = JE.broadcast_batch(JE.init_state(dyn, n=n)._replace(
        plant=JP.init_plant(dyn, contact=contact)), B)
    sb = sb._replace(plant=sb.plant._replace(q=sb.plant.q.at[:, 0].add(jnp.asarray([-0.01, 0.01]))),
                     t=jnp.asarray([0.0, 0.05], jnp.float32))
    sb = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), sb)
    args = (JE.broadcast_batch(JG.make_gait_params(freq, duty, phase_offset=po), B),
            JE.broadcast_batch(contact, B), JE.broadcast_batch(JE.constant_schedule(vx=vx), B))
    for _ in range(CARRY_CYCLES):
        sb, _ = JE.mpc_cycle_batch(dyn, *args, sb, **kw)

    targs = [to_port(a) for a in args]
    tdyn, st = to_port(dyn), to_port(sb)
    for c in range(CYCLES):
        sb, lj = JE.mpc_cycle_batch(dyn, *args, sb, **kw)
        st, lt = TE.mpc_cycle_batch(tdyn, *targs, st, **kw)
        print(name, "cycle", c, "solver_iters jax", np.asarray(lj.solver_iters), "port",
              lt.solver_iters.numpy())
        assert tuple(st.solver.x.shape) == (B, 12 * n)
        du0 = np.abs(st.u0.numpy() - np.asarray(sb.u0)).max()
        assert du0 < 2.0, (c, du0)  # Newtons
        dq = np.abs(st.plant.q.numpy() - np.asarray(sb.plant.q)).max()
        assert dq < 1e-2, (c, dq)
        assert np.isfinite(st.plant.q.numpy()).all()
