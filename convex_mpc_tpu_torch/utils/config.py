"""Typed configuration tree for the whole engine (copy of the JAX package's).

The dataclasses, ``DEFAULT_CONFIG`` / ``TUNED_CONFIG``, the kwargs adapters
``engine_kwargs_batched`` / ``engine_kwargs_fixed`` and the constructors
``contact_from_config`` / ``gait_from_config`` of
``convex_mpc_tpu/utils/config.py``, kept as the port's own copy. The port has
no ``use_pallas`` knob: the engine picks the CUDA kernels by the tensors'
device, and the two constructors take the device as its entry points do.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class GaitConfig:
    """Trot gait schedule (reference gait.py:8-19, test_MPC.py:50-52)."""

    frequency_hz: float = 3.0
    duty: float = 0.6
    # per-leg phase offsets, order [FL, FR, RL, RR] (reference gait.py:8)
    phase_offset: Tuple[float, float, float, float] = (0.5, 0.0, 0.0, 0.5)
    swing_height: float = 0.1  # swing apex height, m (reference gait.py:9)
    touchdown_z: float = 0.02  # nominal touchdown height, m (reference gait.py:57)

    @property
    def period(self) -> float:
        return 1.0 / self.frequency_hz

    @property
    def stance_time(self) -> float:
        return self.duty * self.period

    @property
    def swing_time(self) -> float:
        return (1.0 - self.duty) * self.period


@dataclasses.dataclass(frozen=True)
class MpcConfig:
    """Centroidal MPC weights/limits (reference centroidal_mpc.py:12-38,122-176)."""

    horizon: int = 16  # steps; one full gait cycle (reference com_trajectory.py:66)
    # state cost diag [p(3), rpy(3), v(3), omega(3)] (reference centroidal_mpc.py:12)
    q_diag: Tuple[float, ...] = (1, 1, 50, 10, 20, 1, 2, 2, 1, 1, 1, 1)
    r_diag_value: float = 1e-5  # input cost (reference centroidal_mpc.py:13)
    mu: float = 0.8  # friction coefficient (reference centroidal_mpc.py:15)
    fz_min: float = 10.0  # stance min normal force, N (reference centroidal_mpc.py:127)
    fz_max: float = float("inf")
    max_pos_error: float = 0.1  # COM target clamp, m (reference com_trajectory.py:47)
    # deceleration limiter on the velocity REFERENCE into stops (m/s^2;
    # 0 = reference spec steps, control/reference.py generate). NOT
    # shipped in any default profile — ensemble-adjudicated neutral-to-
    # harmful on the reference schedule (see the TUNED_CONFIG note and
    # BRAKE_ACCEL_CANDIDATE); available per-run for schedules whose stops
    # genuinely exceed the torque budget.
    brake_accel: float = 0.0
    # yaw-deceleration limiter on the reference (rad/s^2; 0 = spec raw
    # steps). SHIPPED at 10.0 in TUNED_CONFIG — see its adjudication note.
    brake_alpha: float = 0.0


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Batched ADMM (OSQP-style) solver settings.

    Mirrors the semantics of the reference's OSQP options
    (centroidal_mpc.py:20-38) in a fixed-shape, jit-compatible form:
    termination is by residual threshold checked every ``check_every``
    iterations inside a ``lax.while_loop`` (single scenario) or by running
    ``max_iter`` fixed iterations with masked early-exit semantics (batched).
    """

    rho: float = 0.1  # base ADMM penalty
    rho_eq_scale: float = 1e3  # equality rows get rho * this (OSQP convention)
    sigma: float = 1e-6
    alpha: float = 1.6  # over-relaxation
    eps_abs: float = 1e-4
    eps_rel: float = 1e-4
    # Certified production values (admm.solve_adaptive): escalation cap 1000
    # completes the full 10 s reference schedule; OSQP-interval residual
    # checks every 25; the reference's own OSQP scaling=5 sweeps
    # (centroidal_mpc.py:33). bench.py and the engine defaults read THESE.
    max_iter: int = 1000
    check_every: int = 25
    adaptive_rho: bool = True
    warm_start: bool = True
    scaling_iters: int = 5  # Ruiz equilibration sweeps (reference scaling=5)
    stall_tol: float = 0.02  # N; fixed-point stall accept (solve_adaptive)
    polish: bool = True  # certified active-set polish accepts
    formulation: str = "condensed"  # "condensed" (fast path) or "full"


@dataclasses.dataclass(frozen=True)
class LegControlConfig:
    """Swing/stance leg controller gains (reference leg_controller.py:10-11)."""

    kp_swing: float = 500.0
    kd_swing: float = 200.0
    tau_max: float = 45.0  # joint torque saturation, Nm (reference test_MPC.py:71)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Closed-loop timing + plant settings (reference test_MPC.py:60-69)."""

    leg_ctrl_hz: int = 1000
    steps_per_mpc: int = 20  # 1000 // 48 (reference test_MPC.py:69)
    # Penalty-contact plant parameters (TPU-native plant; capability of
    # MuJoCo). Tuned values — see sim/physics.py design notes.
    contact_stiffness: float = 30000.0  # N/m
    contact_damping: float = 1000.0  # N/(m/s)
    friction_mu: float = 0.8  # ground Coulomb friction (reference README.md:116)
    friction_vel_tol: float = 0.05  # m/s tangential regularization velocity
    ground_height: float = 0.0
    armature: float = 0.01  # actuator rotor inertia, kg m^2
    joint_damping: float = 0.1  # Nm/(rad/s)
    vel_filter_hz: float = 30.0  # velocity estimator cutoff

    @property
    def dt(self) -> float:
        return 1.0 / self.leg_ctrl_hz


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level config tree."""

    gait: GaitConfig = GaitConfig()
    mpc: MpcConfig = MpcConfig()
    solver: SolverConfig = SolverConfig()
    leg: LegControlConfig = LegControlConfig()
    sim: SimConfig = SimConfig()
    # desired standing height, m (reference test_MPC.py:57)
    z_des: float = 0.27

    @property
    def mpc_dt(self) -> float:
        """MPC step = gait period / horizon (reference test_MPC.py:67)."""
        return self.gait.period / self.mpc.horizon


def engine_kwargs_batched(cfg: "EngineConfig") -> dict:
    """Static kwargs for the PRODUCTION engine paths from the config tree:
    sim.engine.mpc_cycle_batch / mpc_cycle / simulate_batched."""
    return dict(
        n=cfg.mpc.horizon,
        steps_per_mpc=cfg.sim.steps_per_mpc,
        solver_iters=cfg.solver.max_iter,
        tau_max=cfg.leg.tau_max,
        mpc_dt=cfg.mpc_dt,
        sim_dt=cfg.sim.dt,
        q_diag=cfg.mpc.q_diag,
        r_value=cfg.mpc.r_diag_value,
        mu_mpc=cfg.mpc.mu,
        fz_min=cfg.mpc.fz_min,
        vel_filter_hz=cfg.sim.vel_filter_hz,
        check_every=cfg.solver.check_every,
        stall_tol=cfg.solver.stall_tol,
        polish=cfg.solver.polish,
        brake_accel=cfg.mpc.brake_accel,
        brake_alpha=cfg.mpc.brake_alpha,
    )


# The per-scenario production wrapper consumes the same kwargs as the batch
# path (engine.mpc_cycle is a B=1 wrapper over mpc_cycle_batch).
engine_kwargs = engine_kwargs_batched


def engine_kwargs_fixed(cfg: "EngineConfig") -> dict:
    """Static kwargs for the LEGACY fixed-segment path
    (sim.engine.mpc_cycle_fixed / simulate_fixed) — solver-comparison use."""
    return dict(
        n=cfg.mpc.horizon,
        steps_per_mpc=cfg.sim.steps_per_mpc,
        solver_iters=cfg.solver.max_iter,
        tau_max=cfg.leg.tau_max,
        mpc_dt=cfg.mpc_dt,
        sim_dt=cfg.sim.dt,
        q_diag=cfg.mpc.q_diag,
        r_value=cfg.mpc.r_diag_value,
        mu_mpc=cfg.mpc.mu,
        fz_min=cfg.mpc.fz_min,
        vel_filter_hz=cfg.sim.vel_filter_hz,
        formulation=cfg.solver.formulation,
    )


def contact_from_config(cfg: "EngineConfig", device=None):
    """Unbatched ContactParams built from the config tree, on ``device``."""
    from convex_mpc_tpu_torch.sim.physics import default_contact

    return default_contact(
        kn=cfg.sim.contact_stiffness,
        dn=cfg.sim.contact_damping,
        mu=cfg.sim.friction_mu,
        vtol=cfg.sim.friction_vel_tol,
        ground_z=cfg.sim.ground_height,
        armature=cfg.sim.armature,
        joint_damping=cfg.sim.joint_damping,
        device=device,
    )


def gait_from_config(cfg: "EngineConfig", device=None):
    """Unbatched GaitParams built from the config tree, on ``device``."""
    from convex_mpc_tpu_torch.control.gait import make_gait_params

    return make_gait_params(
        frequency_hz=cfg.gait.frequency_hz,
        duty=cfg.gait.duty,
        phase_offset=cfg.gait.phase_offset,
        swing_height=cfg.gait.swing_height,
        touchdown_z=cfg.gait.touchdown_z,
        device=device,
    )


DEFAULT_CONFIG = EngineConfig()

# Tuned profile: reference weights except Q_vy 2 -> 8 and Q_vz 1 -> 4.
# With the reference's exact weights, lateral tracking overshoots ~+40-50%
# (on this plant AND on MuJoCo — controller-inherent; the f64 reference-
# semantics oracle overshoots worse) and the 10 s schedule's t=8 transition
# (2 rad/s turn -> 0.8 m/s) sits on a chaos-sensitive margin. Q_vy = 8
# restores lateral tracking to ~+10% and removes the combo-phase sideslip.
# Q_vz = 4 damps the vertical axis: with Q_z = 50 over Q_vz = 1 the height
# loop is underdamped at 48 Hz, and the t=8 turn-exit (body sinking under
# the combo phase, then a 3x-weight recovery push) launched the robot
# ballistic (z 0.25 -> 0.45) into a landing fall once the per-joint torque
# clip tightened authority; Q_vz = 4 keeps max z below 0.35 through the
# same transition at every solver cap tested (400/600/1000), with lateral
# tracking unchanged. DEFAULT_CONFIG keeps the reference weights for spec
# parity.
#
# Round-5 limiter adjudication (ensemble protocol, B = 64 perturbed
# starts of the 10 s reference schedule; artifacts/ensemble_*_r5.json):
#
# - brake_accel = 2.5 (linear-stop limiter) alone: 39/64 vs the tuned
#   baseline's 47/64 — stretching the t = 9 stop into a 0.32 s reference
#   ramp re-rolls the chaotic schedule without widening the margin (the
#   dominant failures were NOT at the stop). NOT shipped; available
#   per-run via BRAKE_ACCEL_CANDIDATE.
# - brake_alpha = 10 (yaw-deceleration limiter): 54/64 with CP95 0.75 vs
#   47/64 / CP95 0.63 — and, decisively, fail_time_s shows the t = 8-9
#   turn-exit failures (13 of the baseline's 17) are ELIMINATED; all
#   remaining failures move to the t = 9-10 braking window and stops
#   become clean (stop_resid p95 0.48 -> 0.035). Softening the 2 rad/s
#   angular-momentum dump over ~0.2 s is the effective controller-level
#   fix the round-4 verdict asked for. SHIPPED in TUNED_CONFIG.
TUNED_CONFIG = EngineConfig(
    mpc=MpcConfig(q_diag=(1, 1, 50, 10, 20, 1, 2, 8, 4, 1, 1, 1),
                  brake_alpha=10.0)
)
TUNED_Q_DIAG = TUNED_CONFIG.mpc.q_diag

# The adjudicated-but-not-shipped braking-limiter rate (see the
# TUNED_CONFIG note); tools that re-run the --brake experiment read this.
BRAKE_ACCEL_CANDIDATE = 2.5
