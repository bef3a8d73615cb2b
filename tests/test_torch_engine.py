"""Whole-slice parity: the port's ``mpc_cycle_batch`` against the JAX package.

A representative state is reached with 5 JAX cycles (as in
tests/test_adaptive.py::test_mpc_cycle_batch_matches_single), carried
across with ``interop.from_numpy``, and one batched cycle runs in each
package at B = 2, horizon 16. Bars: applied forces u0 within 2.0 N (the JAX
suite's own batched-vs-single bar) and the plant configuration after the
20 ticks within 1e-2.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parity import to_np, to_port  # noqa: E402

from convex_mpc_tpu.control import gait as JG
from convex_mpc_tpu.models import dynamics as JD
from convex_mpc_tpu.sim import engine as JE
from convex_mpc_tpu.sim import physics as JP
from convex_mpc_tpu_torch.mpc import kernels as TK
from convex_mpc_tpu_torch.ops import chol_kernel as TCK
from convex_mpc_tpu_torch.sim import engine as TE
from convex_mpc_tpu_torch.utils import interop
from convex_mpc_tpu_torch.utils.config import DEFAULT_CONFIG, engine_kwargs_batched


@pytest.fixture(scope="module")
def carried():
    dyn = JD.build_dyn()
    contact = JP.default_contact(kn=30000, dn=1000)
    gait = JG.make_gait_params(3.0, 0.6)
    sched = JE.constant_schedule(vx=0.4)
    state = JE.init_state(dyn, n=16)._replace(plant=JP.init_plant(dyn, contact=contact))
    for _ in range(5):
        state, _ = JE.mpc_cycle(dyn, gait, contact, sched, state, solver_iters=400)
    B = 2
    args = (JE.broadcast_batch(gait, B), JE.broadcast_batch(contact, B),
            JE.broadcast_batch(sched, B), JE.broadcast_batch(state, B))
    return dyn, args


def test_one_cycle_matches_jax(carried):
    dyn, args = carried
    s1, l1 = JE.mpc_cycle_batch(dyn, *args, solver_iters=800)
    s2, l2 = TE.mpc_cycle_batch(to_port(dyn), *[to_port(a) for a in args], solver_iters=800)
    print("solver_iters jax", np.asarray(l1.solver_iters), "port", l2.solver_iters.numpy())
    du0 = np.abs(s2.u0.numpy() - np.asarray(s1.u0)).max()
    assert du0 < 2.0, du0  # Newtons
    dq = np.abs(s2.plant.q.numpy() - np.asarray(s1.plant.q)).max()
    assert dq < 1e-2, dq
    for f in l1.ticks._fields:  # vmap-of-scan layout
        assert tuple(getattr(l2.ticks, f).shape) == np.asarray(getattr(l1.ticks, f)).shape, f
    assert tuple(s2.solver.rho.shape) == (2,)


def test_config_kwargs_and_short_run(carried):
    """engine_kwargs_batched(DEFAULT_CONFIG) drives the port; simulate_batched
    stacks logs as (n_cycles, B, ...) and the batch stays upright. The CPU
    run launches no CUDA kernel."""
    dyn, args = carried
    kw = engine_kwargs_batched(DEFAULT_CONFIG)
    before = (TCK.spd_inverse.launches, TK.admm_iterations_structured.launches)
    state, logs = TE.simulate_batched(to_port(dyn), *[to_port(a) for a in args], 2, **kw)
    assert (TCK.spd_inverse.launches, TK.admm_iterations_structured.launches) == before
    assert tuple(logs.ticks.q.shape) == (2, 2, 20, 19)
    assert tuple(logs.solver_iters.shape) == (2, 2)
    z = state.plant.q[:, 2].numpy()
    assert np.isfinite(z).all() and ((z > 0.1) & (z < 0.6)).all(), z


def test_single_scenario_wrapper(carried):
    """mpc_cycle is the B = 1 wrapper: unbatched in, unbatched out."""
    dyn, args = carried
    one = [interop.tree_map(lambda x: x[0], to_port(a)) for a in args]
    s, log = TE.mpc_cycle(to_port(dyn), *one, solver_iters=400)
    assert tuple(s.u0.shape) == (4, 3) and tuple(log.ticks.q.shape) == (20, 19)
    assert s.solver.rho.ndim == 0


def test_interop_roundtrip(carried):
    """from_numpy keeps int32/bool leaves and casts floats to f32;
    to_numpy inverts it."""
    _, args = carried
    state = to_np(args[-1])
    port = interop.from_numpy(state, "cpu")
    assert port.leg.last_mask.dtype == torch.int32
    assert port.plant.q.dtype == torch.float32
    back = interop.to_numpy(port)
    for a, b in zip(interop.tree_leaves(back), jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_kernel_launchers_refuse_cpu_tensors():
    """The CUDA kernel entry points raise on CPU tensors: no silent fallback
    below the wrappers (the wrappers pick the plain version by device)."""
    A = torch.eye(64).expand(2, 64, 64).contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        TCK._launch(A, torch.empty_like(A))
    nb = 4
    C = torch.zeros(1, nb, 4, 3)
    v = torch.zeros(1, 3 * nb)
    r = torch.ones(1, 7 * nb)
    with pytest.raises(ValueError, match="CUDA"):
        TK._launch(C, v, torch.zeros(1, 3 * nb, 3 * nb), v, r, r, r, v, r, r, 1, 1e-6, 1.6)
    with pytest.raises(ValueError):
        TCK.spd_inverse(A.to("meta"))
