"""Closed-loop simulation engine: MPC at ~48 Hz, leg control + physics at 1 kHz.

Port of ``convex_mpc_tpu/sim/engine.py``. One ``mpc_cycle_batch`` =
per-scenario update (command lookup, observation, reference generation,
condensed QP assembly) + one batch-global adaptive QP solve +
``steps_per_mpc`` 1 kHz ticks of leg control and plant stepping, with every
state NamedTuple batched on its leading axis. The JAX ``vmap`` becomes that
batch axis and the tick ``lax.scan`` a Python loop (or, with
``use_fused_ticks``, one fused window: ``sim/tick_fused.py``); the logs keep
the ``vmap``-of-``scan`` layout (``CycleLog.ticks.*`` is
``(B, steps_per_mpc, ...)``). ``mpc_cycle_fixed`` is the same period on the
legacy fixed-segment solver, on the condensed QP or on the full form
(``formulation="full"``, ``mpc/qp.py``).

``mpc_cycle_batch`` names its stages in a ``torch.profiler`` trace
(``mpc.cycle``, ``mpc.update``, ``mpc.solve``, ``mpc.apply`` and their
children, ``utils.profiling.span``) and counts its cycles
(``utils.profiling.count``); outside the profiler the spans record nothing.

The CUDA kernels run when the tensors are on a CUDA device and their plain
versions when they are on the CPU; there is no other switch.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from convex_mpc_tpu_torch._device import F32, as_f32, const, default_device
from convex_mpc_tpu_torch.control import gait as G
from convex_mpc_tpu_torch.control import leg as L
from convex_mpc_tpu_torch.control import reference as R
from convex_mpc_tpu_torch.models import dynamics as D
from convex_mpc_tpu_torch.models import kinematics as K
from convex_mpc_tpu_torch.models.go2_params import DEFAULT_PARAMS
from convex_mpc_tpu_torch.mpc import admm, condensed, qp
from convex_mpc_tpu_torch.ops.rotations import quat_to_rpy, yaw_unwrap_step
from convex_mpc_tpu_torch.sim import physics as P
from convex_mpc_tpu_torch.sim import tick_fused
from convex_mpc_tpu_torch.utils.interop import tree_leaves, tree_map, tree_unflatten
from convex_mpc_tpu_torch.utils.profiling import count, span


class CommandSchedule(NamedTuple):
    """Piecewise-constant body command schedule ((K,) or batched (B, K))."""

    t_start: torch.Tensor
    t_end: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    z_pos: torch.Tensor
    yaw_rate: torch.Tensor


def reference_schedule(device=None) -> CommandSchedule:
    """The reference's 10 s command schedule."""
    rows = [
        (0.0, 1.0, 0.7, 0.0, 0.27, 0.0),
        (1.0, 1.5, 0.0, 0.0, 0.27, 0.0),
        (1.5, 3.0, 0.0, 0.3, 0.27, 0.0),
        (3.0, 4.0, 0.0, 0.0, 0.27, 0.0),
        (4.0, 6.0, 0.0, 0.0, 0.27, 2.0),
        (6.0, 6.5, 0.0, 0.0, 0.27, 0.0),
        (6.5, 8.0, 0.6, 0.0, 0.27, 2.0),
        (8.0, 9.0, 0.8, 0.0, 0.27, 0.0),
        (9.0, 10.0, 0.0, 0.0, 0.27, 0.0),
    ]
    device = default_device(device)
    return CommandSchedule(*[as_f32(c, device) for c in zip(*rows)])


def constant_schedule(vx=0.0, vy=0.0, z=0.27, wz=0.0, t_end=1e9, device=None) -> CommandSchedule:
    device = default_device(device)
    f = lambda v: as_f32([v], device)
    return CommandSchedule(t_start=f(0.0), t_end=f(t_end), vx=f(vx), vy=f(vy),
                           z_pos=f(z), yaw_rate=f(wz))


def ramp_schedule(sched: CommandSchedule, max_acc: float = 1.5, max_alpha: float = 6.0,
                  step: float = 0.1) -> CommandSchedule:
    """Slew-rate-limit an unbatched (K,) step schedule into piecewise-constant
    ramps of ``step`` seconds: vx and vy change by at most ``max_acc`` m/s^2,
    the yaw rate by at most ``max_alpha`` rad/s^2, z follows its target.
    Computed on the host in float64 as the JAX package does; returns the
    denser schedule on ``sched``'s device."""
    col = {f: np.asarray(v.detach().cpu()) for f, v in zip(sched._fields, sched)}
    ts = np.arange(0.0, float(col["t_end"].max()) + step, step)

    def raw(t):
        inp = (col["t_start"] <= t) & (t < col["t_end"])
        if inp.any():
            i = int(np.argmax(inp))
            return np.array([col["vx"][i], col["vy"][i], col["z_pos"][i], col["yaw_rate"][i]],
                            float)
        return np.array([0.0, 0.0, 0.27, 0.0])

    cur = raw(0.0)
    rows = []
    for t in ts:
        tgt = raw(t)
        dv = np.clip(tgt[:2] - cur[:2], -max_acc * step, max_acc * step)
        dw = np.clip(tgt[3] - cur[3], -max_alpha * step, max_alpha * step)
        cur = np.array([cur[0] + dv[0], cur[1] + dv[1], tgt[2], cur[3] + dw])
        rows.append((t, t + step, *cur))
    dev = sched.t_start.device
    return CommandSchedule(*[as_f32(np.asarray(c), dev) for c in zip(*rows)])


def lookup_command(sched: CommandSchedule, t) -> R.BodyCommand:
    """Piecewise lookup for a batch (sched (B, K), t (B,)); default
    (0, 0, 0.27, 0) outside all phases."""
    in_phase = (sched.t_start <= t[:, None]) & (t[:, None] < sched.t_end)
    any_in = torch.any(in_phase, dim=-1)

    def pick(v, default):
        return torch.where(any_in, torch.sum(torch.where(in_phase, v, 0.0), dim=-1), default)

    return R.BodyCommand(vx=pick(sched.vx, 0.0), vy=pick(sched.vy, 0.0),
                         z_pos=pick(sched.z_pos, 0.27), yaw_rate=pick(sched.yaw_rate, 0.0))


class EngineState(NamedTuple):
    plant: P.PlantState
    leg: L.LegControlState
    refgen: R.RefGenState
    solver: admm.AdmmState
    yaw_cont: torch.Tensor  # continuous yaw
    yaw_prev: torch.Tensor  # previous raw yaw measurement
    u0: torch.Tensor  # (4, 3) applied MPC forces
    t: torch.Tensor  # sim time
    vel_filt: torch.Tensor  # (6,) low-passed [vcom_world, omega_world]


class TickLog(NamedTuple):
    x_vec: torch.Tensor  # (12,) centroidal state
    q: torch.Tensor  # (19,)
    tau: torch.Tensor  # (4, 3) applied (saturated) torques
    force: torch.Tensor  # (4, 3) MPC contact forces in effect
    foot_pos_des: torch.Tensor  # (4, 3)
    foot_pos_now: torch.Tensor  # (4, 3)
    contact_mask: torch.Tensor  # (4,)


class CycleLog(NamedTuple):
    ticks: TickLog  # (B, steps_per_mpc, ...)
    solver_iters: torch.Tensor
    prim_res: torch.Tensor
    dual_res: torch.Tensor


def init_state(dyn: D.Go2Dyn, n: int, x=0.0, y=0.0, formulation: str = "condensed") -> EngineState:
    """Unbatched initial state (tile with :func:`broadcast_batch`); the solver
    state has the sizes of the ``formulation``'s QP ("condensed" or "full")."""
    mod = {"condensed": condensed, "full": qp}[formulation]
    dev = dyn.mass.device
    plant = P.init_plant(dyn, x=x, y=y)
    com, _ = D.com_state(dyn, plant.q[None], torch.zeros((1, 18), dtype=F32, device=dev))
    x_vec0 = torch.cat([com[0], torch.zeros(9, dtype=F32, device=dev)])
    nz, m = mod.n_vars(n), mod.n_rows(n)
    zero = lambda *s: torch.zeros(s, dtype=F32, device=dev)
    return EngineState(
        plant=plant,
        leg=L.init_state(dev),
        refgen=R.init_state(x_vec0),
        solver=admm.AdmmState(x=zero(nz), z=zero(m), y=zero(m), rho=as_f32(0.1, dev)),
        yaw_cont=as_f32(0.0, dev), yaw_prev=as_f32(0.0, dev), u0=zero(4, 3),
        t=as_f32(0.0, dev), vel_filt=zero(6),
    )


def observe(dyn: D.Go2Dyn, plant: P.PlantState, yaw_cont, yaw_prev, vel_filt=None):
    """Centroidal observation for a batch -> (CentroidalObs, yaw_cont, yaw_prev)."""
    q, dq = plant.q, plant.dq
    rpy = quat_to_rpy(q[:, 3:7])
    new_cont, new_prev = yaw_unwrap_step(rpy[:, 2], yaw_prev, yaw_cont)
    poses = K.fk(dyn.kin, q)
    R_bw = poses.R[:, 0]
    com, vcom = D.com_state(dyn, q, dq)
    omega_world = torch.einsum("bij,bj->bi", R_bw, dq[:, 3:6])
    vel6 = torch.cat([vcom, omega_world], dim=-1) if vel_filt is None else vel_filt
    x_vec = torch.cat([com, torch.stack([rpy[:, 0], rpy[:, 1], new_cont], dim=-1), vel6], dim=-1)
    obs = R.CentroidalObs(
        x_vec=x_vec, R_body_to_world=R_bw, foot_levers=poses.foot_w - com[:, None, :],
        mass=dyn.total_mass, inertia_world=D.centroidal_inertia(dyn, q),
    )
    return obs, new_cont, new_prev


def _filter_alpha(vel_filter_hz: float, sim_dt: float) -> float:
    """1 - exp(-2 pi f dt), with the exponential taken in f32 as JAX does."""
    e = torch.exp(torch.tensor(-2.0 * math.pi * vel_filter_hz * sim_dt, dtype=F32))
    return float(1.0 - e)


def _torque_limits(tau_max: float, device) -> torch.Tensor:
    gp = DEFAULT_PARAMS
    lim = const("joint_torque_max", device, lambda d: torch.tensor(
        [gp.hip_torque_max, gp.thigh_torque_max, gp.calf_torque_max],
        dtype=F32, device=d).repeat(4).reshape(4, 3))
    return torch.clamp(lim, max=tau_max)


def _run_ticks(dyn, gait, contact, cmd, traj, u0, plant0, leg0, yaw_cont, yaw_prev,
               vel_filt0, t0, steps_per_mpc: int, tau_max: float, sim_dt: float,
               vel_filter_hz: float):
    """The 1 kHz inner loop of one MPC period for a batch.

    Returns ((plant, leg, yaw_cont, yaw_prev, vel_filt, t), TickLog) with
    the log stacked as (B, steps_per_mpc, ...).
    """
    B = u0.shape[0]
    alpha = _filter_alpha(vel_filter_hz, sim_dt)
    lim = _torque_limits(tau_max, u0.device)
    plant, leg_state, yc, yp, vfilt, t = plant0, leg0, yaw_cont, yaw_prev, vel_filt0, t0
    logs = []
    for _ in range(steps_per_mpc):
        rpy = quat_to_rpy(plant.q[:, 3:7])
        yc, yp = yaw_unwrap_step(rpy[:, 2], yp, yc)
        leg_obs = L.make_leg_obs(dyn, plant.q, plant.dq, yc)
        omega_w = torch.einsum("bij,bj->bi", leg_obs.base_R, plant.dq[:, 3:6])
        raw6 = torch.cat([leg_obs.vel_com_world, omega_w], dim=-1)
        vfilt = vfilt + alpha * (raw6 - vfilt)
        leg_obs = leg_obs._replace(vel_com_world=vfilt[:, 0:3])
        out, leg_state = L.compute_torques(
            leg_state, gait, leg_obs, u0, traj.pos_des_world, traj.vel_des_world,
            cmd.yaw_rate, t,
        )
        tau = torch.clamp(out.tau, -lim, lim)
        x_vec = torch.cat(
            [leg_obs.pos_com_world, torch.stack([rpy[:, 0], rpy[:, 1], yc], dim=-1), raw6], dim=-1)
        q_pre = plant.q
        plant = P.step(
            dyn, contact, plant, tau.reshape(B, 12), sim_dt,
            J=leg_obs.J_feet, M=leg_obs.M, bias=leg_obs.bias, base_R=leg_obs.base_R,
            foot_pos=leg_obs.foot_pos, foot_vel=leg_obs.foot_vel,
        )
        logs.append(TickLog(
            x_vec=x_vec, q=q_pre, tau=tau, force=u0, foot_pos_des=out.pos_des,
            foot_pos_now=out.pos_now, contact_mask=G.current_mask(gait, t),
        ))
        t = t + sim_dt
    ticks = TickLog(*(torch.stack(f, dim=1) for f in zip(*logs)))
    return (plant, leg_state, yc, yp, vfilt, t), ticks


def cycle_update(dyn, gait, sched, state, qd, n, mpc_dt, r_value, mu_mpc, fz_min,
                 brake_accel=0.0, brake_alpha=0.0):
    """Batched "update" stage: command lookup + observation + reference
    generation + condensed QP assembly. ``mpc_dt``: a float, or a (B,)
    tensor of each scenario's step (counted as ``mpc_dt_rows``)."""
    if torch.is_tensor(mpc_dt):
        count("mpc_dt_rows", mpc_dt.numel())
    with span("mpc.update.observe"):
        cmd = lookup_command(sched, state.t)
        obs, yaw_cont, yaw_prev = observe(dyn, state.plant, state.yaw_cont, state.yaw_prev,
                                          state.vel_filt)
    with span("mpc.update.reference"):
        traj, refgen = R.generate(state.refgen, gait, obs, cmd, state.t, mpc_dt, n,
                                  brake_accel=brake_accel, brake_alpha=brake_alpha)
    with span("mpc.update.condense"):
        p0 = traj.x0[:, 0:3]
        x0_s = torch.cat([torch.zeros_like(p0), traj.x0[:, 3:]], dim=-1)
        x_ref_s = torch.cat([traj.x_ref[:, :, 0:3] + (-p0[:, None, :]), traj.x_ref[:, :, 3:]],
                            dim=-1)
        data, _ = condensed.build_condensed_structured(
            traj.dyn, x0_s, x_ref_s, traj.contact, qd, r_value, mu_mpc, fz_min)
    return data, traj, refgen, cmd, yaw_cont, yaw_prev


def cycle_apply(dyn, gait, contact, state, sol, traj_b, refgen_b, cmd_b, yc_b, yp_b,
                solver_iters, steps_per_mpc=20, tau_max=45.0, sim_dt=1e-3,
                vel_filter_hz=30.0, use_fused_ticks=None):
    """Batched "apply" stage: 1 kHz ticks from the solved forces + next-cycle
    state assembly with the rho warm-carry.

    ``use_fused_ticks``: run the window as one fused launch
    (``tick_fused.run_ticks_fused``) instead of the tick loop; the same
    semantics at f32 reassociation level. ``None`` means off, the JAX
    package's default, which keeps it off pending closed-loop certification.
    """
    u0_b = sol.x[:, 0:12].reshape(-1, 4, 3)
    ticks_fn = tick_fused.run_ticks_fused if use_fused_ticks else _run_ticks
    with span("mpc.apply.ticks"):
        (plant, leg_state, yaw_cont, yaw_prev, vel_filt, t), ticks = ticks_fn(
            dyn, gait, contact, cmd_b, traj_b, u0_b, state.plant, state.leg, yc_b, yp_b,
            state.vel_filt, state.t, steps_per_mpc, tau_max, sim_dt, vel_filter_hz,
        )
    with span("mpc.apply.carry"):
        # carry the adapted rho only out of cycles that converged before the cap
        rho_carry = torch.where(
            sol.iters < solver_iters, torch.clamp(sol.state.rho, 1e-5, 0.1),
            torch.full_like(sol.state.rho, 0.1),
        )
        new_state = EngineState(
            plant=plant, leg=leg_state, refgen=refgen_b,
            solver=sol.state._replace(rho=rho_carry), yaw_cont=yaw_cont, yaw_prev=yaw_prev,
            u0=u0_b, t=t, vel_filt=vel_filt,
        )
        log = CycleLog(ticks=ticks, solver_iters=sol.iters, prim_res=sol.prim_res,
                       dual_res=sol.dual_res)
    return new_state, log


def _stage_mark(profile, key, t_prev, device):
    """Accumulate the host time of a stage (synchronizing the device)."""
    if profile is None:
        return None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    now = time.perf_counter()
    if t_prev is not None:
        profile[key] = profile.get(key, 0.0) + (now - t_prev)
    return now


def mpc_cycle_batch(
    dyn: D.Go2Dyn,
    gait: G.GaitParams,
    contact: P.ContactParams,
    sched: CommandSchedule,
    state: EngineState,
    n: int = 16,
    steps_per_mpc: int = 20,
    solver_iters: int = 1000,
    tau_max: float = 45.0,
    mpc_dt: float | torch.Tensor = (1.0 / 3.0) / 16,
    sim_dt: float = 1e-3,
    q_diag=(1, 1, 50, 10, 20, 1, 2, 2, 1, 1, 1, 1),
    r_value: float = 1e-5,
    mu_mpc: float = 0.8,
    fz_min: float = 10.0,
    vel_filter_hz: float = 30.0,
    check_every: int = 25,
    stall_tol: float = 0.02,
    polish: bool = True,
    return_polished: bool = True,
    brake_accel: float = 0.0,
    brake_alpha: float = 0.0,
    use_fused_ticks: bool | None = None,
    profile: dict | None = None,
) -> tuple[EngineState, CycleLog]:
    """One MPC period for a scenario batch with the batch-global adaptive solver.

    ``gait``/``contact``/``sched``/``state`` leaves carry a leading batch
    axis. ``mpc_dt`` is a float, one MPC step for every scenario, or a (B,)
    float32 tensor on the batch's device, each scenario's own step (a mix of
    gait periods over one horizon). ``use_fused_ticks`` as in
    :func:`cycle_apply`. ``profile``, when a dict, accumulates the seconds
    of the update, solve and apply stages under those keys (each stage then
    ends in a device synchronization; the apply stage covers the fused
    window too). The stages' spans
    (``utils.profiling.span``) never synchronize.
    """
    count("cycles")
    with span("mpc.cycle"):
        dev = state.plant.q.device
        qd = const(("q_diag", tuple(float(v) for v in q_diag)), dev,
                   lambda d: torch.as_tensor(q_diag, dtype=F32, device=d))
        t_mark = _stage_mark(profile, None, None, dev)
        with span("mpc.update"):
            data_b, traj_b, refgen_b, cmd_b, yc_b, yp_b = cycle_update(
                dyn, gait, sched, state, qd, n, mpc_dt, r_value, mu_mpc, fz_min,
                brake_accel=brake_accel, brake_alpha=brake_alpha,
            )
        t_mark = _stage_mark(profile, "update", t_mark, dev)
        with span("mpc.solve"):
            sol = admm.solve_adaptive(
                data_b, state.solver, max_iter=solver_iters, check_every=check_every,
                box_tail=n * 12, stall_tol=stall_tol, polish=polish, nu=condensed.NU,
                return_polished=return_polished,
            )
        t_mark = _stage_mark(profile, "solve", t_mark, dev)
        with span("mpc.apply"):
            out = cycle_apply(
                dyn, gait, contact, state, sol, traj_b, refgen_b, cmd_b, yc_b, yp_b,
                solver_iters, steps_per_mpc, tau_max, sim_dt, vel_filter_hz,
                use_fused_ticks=use_fused_ticks,
            )
        _stage_mark(profile, "apply", t_mark, dev)
    return out


def mpc_cycle_fixed(
    dyn: D.Go2Dyn,
    gait: G.GaitParams,
    contact: P.ContactParams,
    sched: CommandSchedule,
    state: EngineState,
    n: int = 16,
    steps_per_mpc: int = 20,
    solver_iters: int = 200,
    tau_max: float = 45.0,
    mpc_dt: float | torch.Tensor = (1.0 / 3.0) / 16,
    sim_dt: float = 1e-3,
    q_diag=(1, 1, 50, 10, 20, 1, 2, 2, 1, 1, 1, 1),
    r_value: float = 1e-5,
    mu_mpc: float = 0.8,
    fz_min: float = 10.0,
    vel_filter_hz: float = 30.0,
    formulation: str = "condensed",
) -> tuple[EngineState, CycleLog]:
    """One MPC period for a scenario batch on the LEGACY fixed-segment solver
    (``admm.solve_batch``).

    ``formulation="condensed"``: the dense condensed QP, rho reset to 0.1
    each cycle, (x, z, y) warm-started, OSQP's scaled termination.
    ``formulation="full"``: the full-form QP (``qp.build_qp``, states and
    forces as variables) under the solver's defaults, the whole solver state
    (rho included) carried from the last cycle; u0 is the first step's
    forces (``qp.split_solution``).

    Kept as the iteration->throughput reference curve and for solver
    comparisons; production runs :func:`mpc_cycle_batch`. Inputs carry a
    leading batch axis, and ``mpc_dt`` is a float or a (B,) tensor, as there.
    """
    if formulation not in ("condensed", "full"):
        raise ValueError(f"formulation is 'condensed' or 'full', got {formulation!r}")
    dev = state.plant.q.device
    cmd = lookup_command(sched, state.t)
    obs, yaw_cont, yaw_prev = observe(dyn, state.plant, state.yaw_cont, state.yaw_prev,
                                      state.vel_filt)
    traj, refgen = R.generate(state.refgen, gait, obs, cmd, state.t, mpc_dt, n)
    # solve in the frame of the current COM (the QP is translation-invariant)
    p0 = traj.x0[:, 0:3]
    x0_s = torch.cat([torch.zeros_like(p0), traj.x0[:, 3:]], dim=-1)
    x_ref_s = torch.cat([traj.x_ref[:, :, 0:3] + (-p0[:, None, :]), traj.x_ref[:, :, 3:]], dim=-1)
    qd = const(("q_diag", tuple(float(v) for v in q_diag)), dev,
               lambda d: torch.as_tensor(q_diag, dtype=F32, device=d))
    qargs = (traj.dyn, x0_s, x_ref_s, traj.contact, qd, r_value, mu_mpc, fz_min)
    if formulation == "condensed":
        data, _ = condensed.build_condensed(*qargs)
        # warm (x, z, y), but rho restarts at 0.1 every solve
        warm = state.solver._replace(rho=torch.full_like(state.solver.rho, 0.1))
        sol = admm.solve_batch(data, warm, max_iter=solver_iters, scaled_termination=True,
                               eps_abs=1e-4, eps_rel=1e-4, box_tail=n * 12)
        u0 = sol.x[:, 0:12].reshape(-1, 4, 3)
    else:
        sol = admm.solve_batch(qp.build_qp(*qargs), state.solver, max_iter=solver_iters)
        u0 = qp.split_solution(sol.x, n)[1][:, 0].reshape(-1, 4, 3)
    (plant, leg_state, yaw_cont, yaw_prev, vel_filt, t), ticks = _run_ticks(
        dyn, gait, contact, cmd, traj, u0, state.plant, state.leg, yaw_cont, yaw_prev,
        state.vel_filt, state.t, steps_per_mpc, tau_max, sim_dt, vel_filter_hz,
    )
    new_state = EngineState(plant=plant, leg=leg_state, refgen=refgen, solver=sol.state,
                            yaw_cont=yaw_cont, yaw_prev=yaw_prev, u0=u0, t=t,
                            vel_filt=vel_filt)
    log = CycleLog(ticks=ticks, solver_iters=sol.iters, prim_res=sol.prim_res,
                   dual_res=sol.dual_res)
    return new_state, log


def broadcast_batch(tree, batch: int):
    """Tile an unbatched NamedTuple (EngineState, GaitParams, ...) to a batch."""
    return tree_map(lambda x: x.expand((batch,) + tuple(x.shape)).clone(), tree)


def mpc_cycle(dyn, gait, contact, sched, state, **kwargs):
    """One MPC period for ONE scenario: a B = 1 wrapper over mpc_cycle_batch."""
    b1 = lambda tree: tree_map(lambda x: x[None], tree)
    new_b, log_b = mpc_cycle_batch(dyn, b1(gait), b1(contact), b1(sched), b1(state), **kwargs)
    sq = lambda tree: tree_map(lambda x: x[0], tree)
    return sq(new_b), sq(log_b)


def _simulate(cycle, dyn, gait, contact, sched, state, n_cycles: int, **cycle_kwargs):
    logs = []
    for _ in range(n_cycles):
        state, log = cycle(dyn, gait, contact, sched, state, **cycle_kwargs)
        logs.append(log)
    if not logs:
        return state, None
    stacked = [torch.stack(v, dim=0) for v in zip(*(tree_leaves(lg) for lg in logs))]
    return state, tree_unflatten(logs[0], stacked)


def simulate(dyn, gait, contact, sched, state, n_cycles: int, **cycle_kwargs):
    """``n_cycles`` MPC periods of ONE scenario (unbatched inputs) through
    :func:`mpc_cycle`; logs stacked as (n_cycles, ...)."""
    return _simulate(mpc_cycle, dyn, gait, contact, sched, state, n_cycles, **cycle_kwargs)


def simulate_batched(dyn, gait, contact, sched, state, n_cycles: int, **cycle_kwargs):
    """``n_cycles`` batched MPC periods; logs stacked as (n_cycles, B, ...)."""
    return _simulate(mpc_cycle_batch, dyn, gait, contact, sched, state, n_cycles,
                     **cycle_kwargs)


def simulate_fixed(dyn, gait, contact, sched, state, n_cycles: int, **cycle_kwargs):
    """:func:`simulate_batched` on the legacy fixed-segment solver
    (:func:`mpc_cycle_fixed`) — solver-comparison use only."""
    return _simulate(mpc_cycle_fixed, dyn, gait, contact, sched, state, n_cycles,
                     **cycle_kwargs)
