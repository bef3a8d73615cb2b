"""Scenario batches: gait x velocity-command x terrain sweeps.

Port of ``convex_mpc_tpu/sim/scenarios.py``. The configurations its users
run in batch (BASELINE.json configs 3-5):

- batched velocity-command sweeps (1k+ parallel (vx, vy, wz) scenarios),
- friction/terrain randomization (per-scenario mu and contact stiffness),
- multi-gait duty/frequency variants,

each one batch of the closed loop. A ``ScenarioBatch`` holds everything the
engine takes per scenario (gait, contact/terrain, command schedule, engine
state), every leaf with a leading batch axis, on the device of the model
constants ``dyn`` it was built from (``device="cpu"`` in ``build_dyn`` for a
CPU run). ``simulate_batch`` runs it on the legacy fixed-segment cycle or
on the production adaptive cycle.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from convex_mpc_tpu_torch._device import F32, as_f32
from convex_mpc_tpu_torch.control import gait as G
from convex_mpc_tpu_torch.models import dynamics as D
from convex_mpc_tpu_torch.sim import engine as E
from convex_mpc_tpu_torch.sim import physics as P
from convex_mpc_tpu_torch.utils.interop import tree_leaves, tree_unflatten


class ScenarioBatch(NamedTuple):
    gait: G.GaitParams  # leaves (B, ...)
    contact: P.ContactParams  # leaves (B,)
    sched: E.CommandSchedule  # leaves (B, K)
    state: E.EngineState  # leaves (B, ...)

    @property
    def size(self) -> int:
        return self.sched.t_start.shape[0]


def make_batch(
    dyn: D.Go2Dyn,
    commands: np.ndarray,  # (B, 3) [vx, vy, wz] per scenario
    z_des: float = 0.27,
    gait_hz: np.ndarray | float = 3.0,  # scalar or (B,)
    gait_duty: np.ndarray | float = 0.6,
    mu: np.ndarray | float = 0.8,
    kn: np.ndarray | float = 30000.0,
    dn: np.ndarray | float = 1000.0,
    n_horizon: int = 16,
) -> ScenarioBatch:
    """A batch from per-scenario commands and (optionally) per-scenario
    gait/terrain parameters, on ``dyn``'s device."""
    dev = dyn.mass.device
    commands = np.atleast_2d(np.asarray(commands, np.float32))
    b = commands.shape[0]

    def vec(v):
        return as_f32(np.broadcast_to(np.asarray(v, np.float32), (b,)).copy(), dev)

    gait = G.GaitParams(
        period=1.0 / vec(gait_hz),
        duty=vec(gait_duty),
        phase_offset=as_f32([0.5, 0.0, 0.0, 0.5], dev).expand(b, 4).clone(),
        swing_height=vec(0.1),
        touchdown_z=vec(0.02),
    )
    base = P.default_contact(device=dev)
    contact = P.ContactParams(
        kn=vec(kn), dn=vec(dn), mu=vec(mu), vtol=vec(float(base.vtol)), ground_z=vec(0.0),
        foot_radius=vec(float(base.foot_radius)), armature=vec(float(base.armature)),
        joint_damping=vec(float(base.joint_damping)),
    )
    cmd = torch.as_tensor(commands, dtype=F32, device=dev)
    sched = E.CommandSchedule(
        t_start=torch.zeros((b, 1), dtype=F32, device=dev),
        t_end=torch.full((b, 1), 1e9, dtype=F32, device=dev),
        vx=cmd[:, 0:1].clone(), vy=cmd[:, 1:2].clone(),
        z_pos=torch.full((b, 1), z_des, dtype=F32, device=dev),
        yaw_rate=cmd[:, 2:3].clone(),
    )
    state = E.broadcast_batch(E.init_state(dyn, n=n_horizon), b)
    return ScenarioBatch(gait=gait, contact=contact, sched=sched, state=state)


def velocity_sweep(dyn: D.Go2Dyn, n: int, vx_range=(-0.3, 0.8), vy_range=(-0.2, 0.2),
                   wz_range=(-1.5, 1.5), seed: int = 0, **kw) -> ScenarioBatch:
    """BASELINE config 3: n parallel (vx, vy, wz) scenarios, shared gait."""
    rng = np.random.default_rng(seed)
    cmds = np.stack([rng.uniform(*vx_range, size=n), rng.uniform(*vy_range, size=n),
                     rng.uniform(*wz_range, size=n)], axis=1)
    return make_batch(dyn, cmds, **kw)


def friction_randomization(dyn: D.Go2Dyn, n: int, mu_range=(0.4, 1.0),
                           kn_range=(15000.0, 45000.0), vx: float = 0.5, seed: int = 0,
                           **kw) -> ScenarioBatch:
    """BASELINE config 4: domain-randomized terrain, fixed forward command."""
    rng = np.random.default_rng(seed)
    cmds = np.tile([vx, 0.0, 0.0], (n, 1))
    return make_batch(dyn, cmds, mu=rng.uniform(*mu_range, size=n),
                      kn=rng.uniform(*kn_range, size=n), **kw)


def gait_sweep(dyn: D.Go2Dyn, freqs=(2.5, 3.0, 3.5), duties=(0.5, 0.6, 0.7), vx: float = 0.5,
               **kw) -> ScenarioBatch:
    """BASELINE config 5 (gait part): trot duty/frequency variants, one
    scenario per (duty, frequency) pair."""
    hz, duty = np.meshgrid(freqs, duties)
    hz, duty = hz.ravel(), duty.ravel()
    cmds = np.tile([vx, 0.0, 0.0], (len(hz), 1))
    return make_batch(dyn, cmds, gait_hz=hz, gait_duty=duty, **kw)


def simulate_batch(
    dyn: D.Go2Dyn,
    batch: ScenarioBatch,
    n_cycles: int,
    solver_iters: int = 300,
    collect_logs: bool = False,
    adaptive: bool = False,
    **cycle_kwargs,
):
    """Run every scenario for ``n_cycles`` MPC periods.

    ``adaptive=False`` loops the legacy fixed-segment cycle
    (``engine.mpc_cycle_fixed``, the dense ADMM kernel); ``adaptive=True``
    loops the production batch-global cycle (``engine.mpc_cycle_batch``:
    ``solver_iters`` is its escalation cap; ``use_fused_ticks=True`` among
    ``cycle_kwargs`` runs the fused tick window). Each cycle runs eagerly on
    the batch's device: the JAX package keeps a cache of compiled runners
    here, and the port has nothing to compile.

    Returns (the batch with advanced states, per-scenario metrics, logs):
    ``height`` (final z), ``upright`` (z > 0.12 and every |dq| < 30),
    ``vx_err`` (|body-frame filtered vx - commanded vx|, the world-frame
    estimate rotated by the accumulated yaw) and ``wz_err``. Logs, when
    ``collect_logs``, are stacked (B, n_cycles, ...) on the fixed path and
    (n_cycles, B, ...) on the adaptive one, as the JAX package's ``vmap`` of
    a scan and scan of the batch give them; else None.
    """
    cycle = E.mpc_cycle_batch if adaptive else E.mpc_cycle_fixed
    states = batch.state
    logs = []
    for _ in range(n_cycles):
        states, log = cycle(dyn, batch.gait, batch.contact, batch.sched, states,
                            solver_iters=solver_iters, **cycle_kwargs)
        if collect_logs:
            logs.append(log)
    stacked = None
    if logs:
        axis = 0 if adaptive else 1
        stacked = tree_unflatten(logs[0], [torch.stack(v, dim=axis) for v in zip(
            *(tree_leaves(lg) for lg in logs))])

    q = states.plant.q
    cmd_now = E.lookup_command(batch.sched, states.t)
    vf = states.vel_filt
    # commands are body-frame: rotate the world-frame filtered velocity by the
    # accumulated yaw (turning scenarios reach arbitrary headings)
    c, s_ = torch.cos(states.yaw_cont), torch.sin(states.yaw_cont)
    vx_b = c * vf[:, 0] + s_ * vf[:, 1]
    metrics = {
        "height": q[:, 2],
        "upright": (q[:, 2] > 0.12) & (torch.abs(states.plant.dq).amax(dim=1) < 30.0),
        "vx_err": torch.abs(vx_b - cmd_now.vx),
        "wz_err": torch.abs(vf[:, 5] - cmd_now.yaw_rate),
    }
    return batch._replace(state=states), metrics, stacked
