"""Closed-loop behavioral ground truth: the REFERENCE controller, re-implemented
in plain NumPy float64, driving host MuJoCo (the port's copy).

The port's counterpart of ``tools/reference_loop.py``, line for line: the
MuJoCo bridge, the Go2 parameters and the native f64 QP solver come from
the port's own copies (``convex_mpc_tpu_torch.sim.mujoco_bridge``,
``models.go2_params``, ``utils.native_oracle``); ``tests/qp_oracle.py``
stays its QP assembler. It needs ``mujoco`` and runs on the host CPU only.

The reference itself cannot run here (casadi / pinocchio / osqp are absent),
so this tool is the next-best thing: a maximally-faithful f64 port of the
reference's *whole* control stack —

  * ComTraj.generate_traj         (reference com_trajectory.py:27-211)
  * Gait schedule / Raibert / min-jerk swing (reference gait.py)
  * CentroidalMPC QP              (reference centroidal_mpc.py, assembled by
                                   tests/qp_oracle.assemble_qp, solved to
                                   convergence + polish by the independent
                                   native C++ f64 solver — OSQP-equivalent
                                   at the optimum)
  * LegController                 (reference leg_controller.py:43-112)

— with every model quantity (COM state, centroidal inertia, Jacobians,
J_dot*dq, bias forces, mass matrix) computed directly from host MuJoCo in
f64, replacing Pinocchio's computeAllTerms. Nothing in this file touches the
batched engine, so it adjudicates behavioral questions (e.g. the lateral-velocity
overshoot) independently of convex_mpc_tpu_torch's controller.

Reference quirks preserved on purpose:
  - predicted-touchdown drift term uses the dummy model's BODY-frame base
    velocity as if it were world-frame (com_trajectory.py:122-131 passes
    body-frame dq; gait.py:58 reads it as world xy drift);
  - predicted foot levers are taken relative to the predicted BASE position
    while the initial levers are COM-relative (com_trajectory.py:113,140);
  - horizon touchdown prediction uses the feedback-free Raibert variant
    (gait.py:40-74) while the executed swing uses the full-feedback variant
    (gait.py:77-136);
  - roll/pitch reference pinned to 0; COM xy target clamped to +-0.1 m;
  - velocities are UNFILTERED (the reference has no state estimator);
  - mask memories initialized to [2,2,2,2].

Usage:
  python tools/torch_reference_loop.py --schedule ref --seconds 10 --save ref_loop.npz
  python tools/torch_reference_loop.py --vy 0.4 --seconds 4       # lateral overshoot
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
from numpy import cos, sin

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

import qp_oracle  # noqa: E402

# MPC constants (reference centroidal_mpc.py:12-15,127)
Q_DIAG = np.array([1, 1, 50, 10, 20, 1, 2, 2, 1, 1, 1, 1], float)
R_VALUE = 1e-5
MU = 0.8
FZ_MIN = 10.0
# gait (reference gait.py:8-9)
PHASE_OFFSET = np.array([0.5, 0.0, 0.0, 0.5])
HEIGHT_SWING = 0.1
# leg controller (reference leg_controller.py:10-11)
KP_SWING = 500.0
KD_SWING = 200.0
LEGS = ("FL", "FR", "RL", "RR")

# reference command schedule (test_MPC.py:37-47): (t0, t1, vx, vy, z, wz)
REF_SCHEDULE = [
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


def rpy_from_R(R):
    """ZYX euler from rotation matrix (pin.rpy.matrixToRpy semantics)."""
    pitch = np.arcsin(np.clip(-R[2, 0], -1.0, 1.0))
    roll = np.arctan2(R[2, 1], R[2, 2])
    yaw = np.arctan2(R[1, 0], R[0, 0])
    return np.array([roll, pitch, yaw])


def skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def rz(yaw):
    return np.array([[cos(yaw), -sin(yaw), 0], [sin(yaw), cos(yaw), 0], [0, 0, 1]])


class MjModelOracle:
    """All PinGo2Model quantities, from host MuJoCo in f64.

    Mirrors reference go2_robot_data.py:108-380 (update_model accessors).
    """

    def __init__(self, bridge):
        import mujoco

        self.mj = mujoco
        self.b = bridge
        self.m, self.d = bridge.model, bridge.data
        self.nv = self.m.nv
        self.site_ids = [
            mujoco.mj_name2id(self.m, mujoco.mjtObj.mjOBJ_SITE, f"{leg}_foot_site")
            for leg in LEGS
        ]
        self.base_bid = bridge.base_bid
        # hip offsets in base frame (reference caches thigh-joint frame
        # translations at init, go2_robot_data.py:147-161): evaluate the
        # thigh body position at zero joint angles from the model itself
        d0 = mujoco.MjData(self.m)
        d0.qpos[:] = 0.0
        d0.qpos[3] = 1.0  # identity wxyz quat
        mujoco.mj_forward(self.m, d0)
        self.hip_offsets = []
        base0 = d0.xpos[self.base_bid].copy()
        for leg in LEGS:
            bid = mujoco.mj_name2id(self.m, mujoco.mjtObj.mjOBJ_BODY, f"{leg}_thigh")
            self.hip_offsets.append(d0.xpos[bid].copy() - base0)
        # yaw unwrap state (go2_robot_data.py:82-91)
        self._yaw_init = False
        self._yaw_prev = 0.0
        self._yaw_cont = 0.0
        # command attributes set by the traj generator (go2_robot_data.py:165-169)
        self.x_pos_des_world = 0.0
        self.y_pos_des_world = 0.0
        self.x_vel_des_world = 0.0
        self.y_vel_des_world = 0.0
        self.yaw_rate_des_world = 0.0

    # -- per-tick refresh -------------------------------------------------
    def update(self):
        mj, m, d = self.mj, self.m, self.d
        mj.mj_forward(m, d)
        mj.mj_subtreeVel(m, d)
        self.q_pin, self.dq_pin = self.b.get_q_dq_pin()
        self.base_pos = self.q_pin[0:3].copy()
        self.base_vel_body = self.dq_pin[0:3].copy()
        w, x, y, z = d.qpos[3:7]
        from convex_mpc_tpu_torch.sim.mujoco_bridge import _quat_wxyz_to_R

        self.R = _quat_wxyz_to_R(w, x, y, z)  # body -> world
        rpy = rpy_from_R(self.R)
        if not self._yaw_init:
            self._yaw_init = True
            self._yaw_prev = rpy[2]
            self._yaw_cont = rpy[2]
        else:
            delta = (rpy[2] - self._yaw_prev + np.pi) % (2 * np.pi) - np.pi
            self._yaw_cont += delta
            self._yaw_prev = rpy[2]
        self.rpy_cont = np.array([rpy[0], rpy[1], self._yaw_cont])
        self.R_z = rz(self._yaw_cont)
        self.pos_com_world = d.subtree_com[self.base_bid].copy()
        self.vel_com_world = d.subtree_linvel[self.base_bid].copy()
        self.omega_world = self.R @ self.dq_pin[3:6]
        # centroidal rotational inertia about the COM, world axes
        # (reference reads pinocchio data.Ig.inertia, com_trajectory.py:40)
        I = np.zeros((3, 3))
        for bid in range(1, m.nbody):
            Rb = d.ximat[bid].reshape(3, 3)
            Ib = Rb @ np.diag(m.body_inertia[bid]) @ Rb.T
            c = d.xipos[bid] - self.pos_com_world
            mass = m.body_mass[bid]
            I += Ib + mass * (np.dot(c, c) * np.eye(3) - np.outer(c, c))
        self.I_com_world = I
        self.mass = float(np.sum(m.body_mass[1:]))
        # full mass matrix + bias (for swing-leg operational-space terms)
        M = np.zeros((self.nv, self.nv))
        mj.mj_fullM(m, d, M)
        self.M_full = M
        self.qfrc_bias = d.qfrc_bias.copy()

    def com_x_vec(self):
        return np.concatenate(
            [self.pos_com_world, self.rpy_cont, self.vel_com_world, self.omega_world]
        )

    def foot_state(self, leg_idx):
        jacp = np.zeros((3, self.nv))
        self.mj.mj_jacSite(self.m, self.d, jacp, None, self.site_ids[leg_idx])
        pos = self.d.site_xpos[self.site_ids[leg_idx]].copy()
        vel = jacp @ self.d.qvel
        return pos, vel, jacp

    def foot_levers_world(self):
        return [self.foot_state(i)[0] - self.pos_com_world for i in range(4)]

    def jdot_dq(self, leg_idx, h=1e-6):
        """J_dot @ qvel by finite-differencing J along the motion."""
        mj, m, d = self.mj, self.m, self.d
        _, _, J0 = self.foot_state(leg_idx)
        qpos0 = d.qpos.copy()
        qvel = d.qvel.copy()
        mj.mj_integratePos(m, d.qpos, qvel, h)
        mj.mj_kinematics(m, d)
        J1 = np.zeros((3, self.nv))
        mj.mj_jacSite(m, d, J1, None, self.site_ids[leg_idx])
        d.qpos[:] = qpos0
        mj.mj_kinematics(m, d)
        return ((J1 - J0) / h) @ qvel


class RefGait:
    """Reference gait.py semantics, f64."""

    def __init__(self, hz=3.0, duty=0.6):
        self.period = 1.0 / hz
        self.duty = duty
        self.stance_time = duty * self.period
        self.swing_time = (1 - duty) * self.period

    def contact_table(self, t0, dt, N):
        t = t0 + np.arange(N) * dt + dt / 2  # midpoint sampling (gait.py:30-31)
        phases = np.mod(PHASE_OFFSET[:, None] + t[None, :] / self.period, 1.0)
        return (phases < self.duty).astype(np.int32)

    def current_mask(self, t):
        return self.contact_table(t, 0.0, 1)[:, 0]

    def touchdown_feedback_free(self, model, leg_idx):
        """Horizon-prediction variant (gait.py:40-74); `model` is the dummy."""
        base_pos = model.base_pos
        base_vel = model.base_vel_body  # reference quirk: body vel as world drift
        hip = model.hip_offsets[leg_idx]
        body_pos = np.array([base_pos[0], base_pos[1], 0.0])
        hip_w = body_pos + model.R_z @ hip
        T = self.swing_time + 0.5 * self.stance_time
        pred = T / 2.0
        nominal = np.array([hip_w[0], hip_w[1], 0.02])
        drift = np.array([base_vel[0] * pred, base_vel[1] * pred, 0.0])
        dtheta = model.yaw_rate_des_world * pred
        r_xy = nominal[0:2] - base_pos[0:2]
        rot = np.array([-dtheta * r_xy[1], dtheta * r_xy[0], 0.0])
        return nominal + drift + rot

    def swing_traj_and_touchdown(self, model, leg_idx):
        """Full-feedback Raibert + min-jerk closure (gait.py:77-174)."""
        base_pos = model.base_pos
        com = model.pos_com_world
        vcom = model.vel_com_world
        hip = model.hip_offsets[leg_idx]
        foot_pos, _, _ = model.foot_state(leg_idx)
        body_pos = np.array([base_pos[0], base_pos[1], 0.0])
        hip_w = body_pos + model.R_z @ hip
        T = self.swing_time + 0.5 * self.stance_time
        pred = T / 2.0
        k_v_x, k_p_x = 0.4 * T, 0.1
        k_v_y, k_p_y = 0.2 * T, 0.05
        nominal = np.array([hip_w[0], hip_w[1], 0.02])
        drift = np.array(
            [model.x_vel_des_world * pred, model.y_vel_des_world * pred, 0.0]
        )
        pos_corr = np.array(
            [
                k_p_x * (com[0] - model.x_pos_des_world),
                k_p_y * (com[1] - model.y_pos_des_world),
                0.0,
            ]
        )
        vel_corr = np.array(
            [
                k_v_x * (vcom[0] - model.x_vel_des_world),
                k_v_y * (vcom[1] - model.y_vel_des_world),
                0.0,
            ]
        )
        dtheta = model.yaw_rate_des_world * pred
        r_xy = nominal[0:2] - base_pos[0:2]
        rot = np.array([-dtheta * r_xy[1], dtheta * r_xy[0], 0.0])
        td = nominal + drift + pos_corr + vel_corr + rot
        return self.make_swing(foot_pos, td, self.swing_time, HEIGHT_SWING), td

    @staticmethod
    def make_swing(p0, pf, T, h_sw):
        p0 = np.asarray(p0, float).copy()
        dp = np.asarray(pf, float) - p0

        def eval_at(t):
            s = np.clip(t / T, 0.0, 1.0)
            mj_ = 10 * s**3 - 15 * s**4 + 6 * s**5
            dmj = 30 * s**2 - 60 * s**3 + 30 * s**4
            d2mj = 60 * s - 180 * s**2 + 120 * s**3
            p = p0 + dp * mj_
            v = dp * dmj / T
            a = dp * d2mj / T**2
            b = 64 * s**3 * (1 - s) ** 3
            db = 192 * s**2 * (1 - s) ** 2 * (1 - 2 * s)
            d2b = 192 * (
                2 * s * (1 - s) ** 2 * (1 - 2 * s)
                - 2 * s**2 * (1 - s) * (1 - 2 * s)
                - 2 * s**2 * (1 - s) ** 2
            )
            p = p.copy(); v = v.copy(); a = a.copy()
            p[2] += h_sw * b
            v[2] += h_sw * db / T
            a[2] += h_sw * d2b / T**2
            return p, v, a

        return eval_at


class DummyModel:
    """The trajectory predictor's 'dummy' rigid body (go2_robot_data.py:224-250):
    zero joint angles, base pose/velocity set analytically per horizon step."""

    def __init__(self, hip_offsets):
        self.hip_offsets = hip_offsets
        self.yaw_rate_des_world = 0.0

    def set_simplified(self, q6, dq6):
        self.base_pos = q6[0:3].copy()
        self.base_vel_body = dq6[0:3].copy()
        self.R_z = rz(q6[5])


class RefComTraj:
    """Reference ComTraj semantics (com_trajectory.py), f64."""

    def __init__(self, model):
        self.dummy = DummyModel(model.hip_offsets)
        self.pos_des_world = model.com_x_vec()[0:3].copy()

    def generate(self, model, gait, t_now, vx_b, vy_b, z_des, wz, dt):
        x0 = model.com_x_vec()
        p0 = x0[0:3]
        yaw = x0[5]
        self.dummy.yaw_rate_des_world = wz
        N = int(round(gait.period / dt))

        # COM xy clamp (com_trajectory.py:47-58)
        for ax in (0, 1):
            self.pos_des_world[ax] = np.clip(
                self.pos_des_world[ax], p0[ax] - 0.1, p0[ax] + 0.1
            )
        self.pos_des_world[2] = z_des
        model.x_pos_des_world = self.pos_des_world[0]
        model.y_pos_des_world = self.pos_des_world[1]

        t_vec = (np.arange(N) + 1) * dt
        vel_w = model.R_z @ np.array([vx_b, vy_b, 0.0])
        model.x_vel_des_world = vel_w[0]
        model.y_vel_des_world = vel_w[1]
        model.yaw_rate_des_world = wz

        pos_traj = self.pos_des_world[:, None] + vel_w[:, None] * t_vec[None, :]
        vel_traj = np.tile(vel_w[:, None], (1, N))
        rpy_traj = np.zeros((3, N))
        rpy_traj[2] = yaw + wz * t_vec
        omega_traj = np.zeros((3, N))
        omega_traj[2] = wz

        contact = gait.contact_table(t_now, dt, N)

        # per-step predicted foot levers (com_trajectory.py:108-201)
        r_traj = np.zeros((4, 3, N))
        r_next = [lv.copy() for lv in model.foot_levers_world()]
        mask_prev = np.array([2, 2, 2, 2])
        R_wb = model.R.T  # world -> body, held fixed over the horizon
        for i in range(N):
            mask = gait.current_mask(t_now + i * dt)
            q6 = np.concatenate([pos_traj[:, i], rpy_traj[:, i]])
            dq6 = np.concatenate([R_wb @ vel_traj[:, i], R_wb @ omega_traj[:, i]])
            self.dummy.set_simplified(q6, dq6)
            p_base = self.dummy.base_pos
            for leg in range(4):
                if mask[leg] != mask_prev[leg] and mask[leg] == 0:
                    td = gait.touchdown_feedback_free(self.dummy, leg)
                    r_next[leg] = td - p_base
                    r_traj[leg, :, i] = 0.0
                elif mask[leg] != mask_prev[leg] and mask[leg] == 1:
                    r_traj[leg, :, i] = r_next[leg]
                else:
                    r_traj[leg, :, i] = r_traj[leg, :, i - 1]
            mask_prev = mask

        # SRB dynamics (com_trajectory.py:221-286) with scipy's own ZOH
        from scipy.linalg import expm
        from scipy.signal import cont2discrete

        m_tot = model.mass
        I_inv = np.linalg.inv(model.I_com_world)
        yaw_avg = float(np.mean(rpy_traj[2]))
        Ac = np.zeros((12, 12))
        Ac[0:3, 6:9] = np.eye(3)
        Ac[3:6, 9:12] = rz(yaw_avg).T
        Bd = np.zeros((N, 12, 12))
        Ad = None
        for i in range(N):
            Bc = np.zeros((12, 12))
            for leg in range(4):
                Bc[6:9, 3 * leg : 3 * leg + 3] = np.eye(3) / m_tot
                Bc[9:12, 3 * leg : 3 * leg + 3] = I_inv @ skew(r_traj[leg, :, i])
            Ad, Bd[i], *_ = cont2discrete(
                (Ac, Bc, np.eye(12), np.zeros((12, 12))), dt, method="zoh"
            )
        gc = np.zeros(12)
        gc[8] = -9.81
        tau = np.linspace(0, dt, 50)
        gd = np.trapz(
            np.stack([expm(Ac * s) @ gc for s in tau], axis=1), tau, axis=1
        )

        x_ref = np.vstack([pos_traj, rpy_traj, vel_traj, omega_traj]).T  # (N, 12)
        return dict(
            N=N, Ad=Ad, Bd=Bd, gd=gd, x0=x0, x_ref=x_ref, contact=contact,
            r_traj=r_traj,
        )


class RefLegController:
    """Reference leg_controller.py semantics, f64."""

    def __init__(self):
        self.last_mask = np.array([2, 2, 2, 2])
        self.takeoff_time = np.zeros(4)
        self.trajs = [None] * 4

    def torque(self, leg_idx, model, gait, force, t):
        jnt = slice(6 + 3 * leg_idx, 9 + 3 * leg_idx)
        mask = gait.current_mask(t)
        foot_pos, foot_vel, J_full = model.foot_state(leg_idx)
        J_leg = J_full[:, jnt]
        if self.last_mask[leg_idx] != mask[leg_idx] and mask[leg_idx] == 0:
            self.takeoff_time[leg_idx] = t
            self.trajs[leg_idx], _ = gait.swing_traj_and_touchdown(model, leg_idx)
        if mask[leg_idx] == 0:  # swing
            p_des, v_des, a_des = self.trajs[leg_idx](t - self.takeoff_time[leg_idx])
            Lam = np.linalg.inv(J_full @ np.linalg.solve(model.M_full, J_full.T))
            f_ff = Lam @ (a_des - model.jdot_dq(leg_idx))
            f = KP_SWING * (p_des - foot_pos) + KD_SWING * (v_des - foot_vel) + f_ff
            tau = J_leg.T @ f + model.qfrc_bias[jnt]
        else:  # stance
            tau = J_leg.T @ (-force)
        self.last_mask[leg_idx] = mask[leg_idx]
        return tau


def lookup_cmd(schedule, t):
    for t0, t1, vx, vy, z, wz in schedule:
        if t0 <= t < t1:
            return vx, vy, z, wz
    return 0.0, 0.0, 0.27, 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--schedule", default="const", choices=["const", "ref"])
    ap.add_argument("--vx", type=float, default=0.4)
    ap.add_argument("--vy", type=float, default=0.0)
    ap.add_argument("--wz", type=float, default=0.0)
    ap.add_argument("--x0", type=float, default=-5.0,
                    help="initial x (reference test_MPC.py:20 uses -5)")
    ap.add_argument("--solver-iters", type=int, default=4000)
    ap.add_argument("--save", default=None, help="write logs to this .npz")
    args = ap.parse_args()

    from convex_mpc_tpu_torch.models.go2_params import DEFAULT_PARAMS
    from convex_mpc_tpu_torch.sim.mujoco_bridge import MujocoGo2
    from convex_mpc_tpu_torch.utils.native_oracle import solve_qp_native

    schedule = (
        REF_SCHEDULE
        if args.schedule == "ref"
        else [(0.0, args.seconds, args.vx, args.vy, 0.27, args.wz)]
    )

    bridge = MujocoGo2(ground=True, mu=0.8, armature=0.01, joint_damping=0.1)
    bridge.model.opt.timestep = 1e-3
    q0 = DEFAULT_PARAMS.default_q()
    q0[0] = args.x0
    q0[2] += 0.0172  # feet touching, not penetrated (as examples/mujoco_loop.py)
    bridge.set_q_pin(q0)

    model = MjModelOracle(bridge)
    gait = RefGait(3.0, 0.6)
    model.update()
    traj_gen = RefComTraj(model)
    legs = RefLegController()

    n, mpc_dt = 16, (1.0 / 3.0) / 16
    ticks = int(args.seconds * 1000)
    xlog = np.zeros((ticks, 12))
    flog = np.zeros((ticks, 12))
    taulog = np.zeros((ticks, 12))
    qlog = np.zeros((ticks, 19))
    kktlog = []
    U0 = np.zeros(12)
    t_wall = time.perf_counter()
    for i in range(ticks):
        t = i * 1e-3
        model.update()
        xlog[i] = model.com_x_vec()
        qlog[i] = model.q_pin
        if i % 20 == 0:
            vx, vy, z_des, wz = lookup_cmd(schedule, t)
            tr = traj_gen.generate(model, gait, t, vx, vy, z_des, wz, mpc_dt)
            d = qp_oracle.assemble_qp(
                tr["Ad"], tr["Bd"], tr["gd"], tr["x0"], tr["x_ref"],
                tr["contact"], Q_DIAG, R_VALUE, MU, FZ_MIN,
            )
            x, y, info = solve_qp_native(
                d["P"], d["q"], d["A"], d["l"], d["u"], max_iter=args.solver_iters
            )
            kktlog.append(info["kkt"])
            U0 = x[n * 12 : n * 12 + 12]
            if i % 1000 == 0:
                print(f"\r t={t:5.2f}s  z={model.base_pos[2]:.3f}  "
                      f"kkt={info['kkt']:.2e}", end="", flush=True)
        flog[i] = U0
        tau = np.concatenate(
            [legs.torque(leg, model, gait, U0[3 * leg : 3 * leg + 3], t)
             for leg in range(4)]
        )
        tau = np.clip(tau, -45.0, 45.0)  # test_MPC.py:71,228
        taulog[i] = tau
        bridge.step(tau)
        if model.base_pos[2] < 0.08:
            print(f"\n[ref-loop] FELL at t={t:.2f}s")
            ticks = i + 1
            xlog, flog, taulog, qlog = (a[:ticks] for a in (xlog, flog, taulog, qlog))
            break
    wall = time.perf_counter() - t_wall

    print(f"\n[ref-loop] {ticks/1000:.1f}s sim in {wall:.0f}s wall  "
          f"worst KKT {max(kktlog):.2e}")
    # body-frame velocities for the phase table
    yaws = xlog[:, 5]
    vxb = np.cos(yaws) * xlog[:, 6] + np.sin(yaws) * xlog[:, 7]
    vyb = -np.sin(yaws) * xlog[:, 6] + np.cos(yaws) * xlog[:, 7]
    if args.schedule == "ref":
        print(f"{'phase':16s} {'vx_b':>7s} {'vy_b':>7s} {'wz':>7s} {'z':>6s} {'|att|max':>8s}")
        for a, b, name in [(0, 1, "fwd 0.7"), (1.5, 3, "lat 0.3"), (4, 6, "yaw 2.0"),
                           (6.5, 8, "fwd0.6+yaw2"), (8, 9, "fwd 0.8"), (9, 10, "stop")]:
            seg = slice(int(a * 1000), int(b * 1000))
            if xlog[seg].shape[0]:
                print(f"{name:16s} {vxb[seg].mean():+7.3f} {vyb[seg].mean():+7.3f} "
                      f"{xlog[seg, 11].mean():+7.3f} {xlog[seg, 2].mean():6.3f} "
                      f"{np.abs(xlog[seg, 3:5]).max():8.3f}")
    tail = slice(len(xlog) // 3, None)
    print(f"[ref-loop] tail vx_b={vxb[tail].mean():+.3f} vy_b={vyb[tail].mean():+.3f} "
          f"wz={xlog[tail, 11].mean():+.3f} z={xlog[tail, 2].mean():.3f} "
          f"|roll|max={np.abs(xlog[tail, 3]).max():.3f} "
          f"|pitch|max={np.abs(xlog[tail, 4]).max():.3f}")
    upright = np.abs(xlog[:, 3:5]).max() < 0.5 and xlog[-1, 2] > 0.15
    print(f"[ref-loop] upright: {upright}")
    if args.save:
        np.savez_compressed(
            args.save, x=xlog, force=flog, tau=taulog, q=qlog, kkt=np.array(kktlog)
        )
        print(f"[ref-loop] saved {args.save}")
    sys.exit(0 if upright else 1)


if __name__ == "__main__":
    main()
