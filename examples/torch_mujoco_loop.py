"""Closed loop of the PyTorch port's controller with MuJoCo as the plant: the reference's own configuration.

The port's counterpart of ``examples/mujoco_loop.py``, with its flags, its
report and its ``upright:`` verdict. Runs the port's full controller
(observation -> reference generation -> condensed QP -> ``admm.solve`` ->
swing/stance leg control) against host-side MuJoCo physics on the
generated Go2 model, as the reference does (test_MPC.py: controller at
~48 Hz, MuJoCo stepping at 1 kHz). This cross-validates the port's control
stack against an independent physics engine: if the robot walks here, the
port's own plant is not masking controller errors.

MuJoCo runs on the host only, and the card's machine has no ``mujoco``, so
this runs where ``mujoco`` is installed, with ``--cpu`` (without it the
controller runs on the CUDA card, and refuses when there is none):

    python3 examples/torch_mujoco_loop.py --cpu [--seconds 3] [--vx 0.4]

Exits 0 when the robot stays upright.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--schedule", default="const", choices=["const", "ref"])
    ap.add_argument("--vx", type=float, default=0.4)
    ap.add_argument("--wz", type=float, default=0.0)
    ap.add_argument("--vy", type=float, default=0.0)
    ap.add_argument("--solver-iters", type=int, default=600)
    ap.add_argument("--cpu", action="store_true", help="run the controller on the CPU")
    ap.add_argument("--tuned", action="store_true", help="Q_vy=8 profile")
    return ap


def main(argv=None) -> int:
    """Run the loop and print the report; returns the exit code."""
    args = parser().parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("torch_mujoco_loop: no CUDA device (pass --cpu for the plain CPU path)")
    dev = torch.device("cpu" if args.cpu else "cuda")

    from convex_mpc_tpu_torch._device import F32, as_f32
    from convex_mpc_tpu_torch.control import gait as G
    from convex_mpc_tpu_torch.control import leg as L
    from convex_mpc_tpu_torch.control import reference as R
    from convex_mpc_tpu_torch.models import dynamics as D
    from convex_mpc_tpu_torch.models import kinematics as K
    from convex_mpc_tpu_torch.models.go2_params import DEFAULT_PARAMS
    from convex_mpc_tpu_torch.mpc import admm, condensed
    from convex_mpc_tpu_torch.ops.rotations import quat_to_rpy, yaw_unwrap_step
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.sim.mujoco_bridge import MujocoGo2
    from convex_mpc_tpu_torch.utils.config import DEFAULT_CONFIG, TUNED_CONFIG
    from convex_mpc_tpu_torch.utils.interop import tree_map

    Q_DIAG = as_f32((TUNED_CONFIG if args.tuned else DEFAULT_CONFIG).mpc.q_diag, dev)
    dyn = D.build_dyn(device=dev)
    # the controller's functions are batched: one scenario, B = 1
    b1 = lambda tree: tree_map(lambda a: a[None], tree)  # noqa: E731
    gait = b1(G.make_gait_params(3.0, 0.6, device=dev))
    n = 16
    mpc_dt = (1.0 / 3.0) / 16
    alpha = E._filter_alpha(30.0, 1e-3)

    bridge = MujocoGo2(ground=True, mu=0.8, armature=0.01, joint_damping=0.1)
    bridge.model.opt.timestep = 1e-3
    q0 = DEFAULT_PARAMS.default_q()
    q0[2] += 0.0172  # start with foot spheres touching, not 17 mm penetrated
    bridge.set_q_pin(q0)

    def observe(q, dq, yaw_cont, yaw_prev, vel_filt):
        rpy = quat_to_rpy(q[:, 3:7])
        yc, yp = yaw_unwrap_step(rpy[:, 2], yaw_prev, yaw_cont)
        poses = K.fk(dyn.kin, q)
        com, vcom = D.com_state(dyn, q, dq)
        omega_w = torch.einsum("bij,bj->bi", poses.R[:, 0], dq[:, 3:6])
        raw6 = torch.cat([vcom, omega_w], dim=-1)
        vf = vel_filt + alpha * (raw6 - vel_filt)
        x_vec = torch.cat([com, torch.stack([rpy[:, 0], rpy[:, 1], yc], dim=-1), vf], dim=-1)
        obs = R.CentroidalObs(
            x_vec=x_vec, R_body_to_world=poses.R[:, 0],
            foot_levers=poses.foot_w - com[:, None, :],
            mass=dyn.total_mass, inertia_world=D.centroidal_inertia(dyn, q),
        )
        return obs, yc, yp, vf

    def solve_mpc(obs, refgen, solver, t, cmd_vx, cmd_vy, cmd_wz):
        f = lambda v: as_f32([v], dev)  # noqa: E731
        cmd = R.BodyCommand(vx=f(cmd_vx), vy=f(cmd_vy), z_pos=f(0.27), yaw_rate=f(cmd_wz))
        traj, refgen = R.generate(refgen, gait, obs, cmd, f(t), mpc_dt, n)
        p0 = traj.x0[:, 0:3]
        x0_s = torch.cat([torch.zeros_like(p0), traj.x0[:, 3:]], dim=-1)
        x_ref_s = torch.cat([traj.x_ref[:, :, 0:3] - p0[:, None, :], traj.x_ref[:, :, 3:]],
                            dim=-1)
        data, _ = condensed.build_condensed(traj.dyn, x0_s, x_ref_s, traj.contact,
                                            Q_DIAG, 1e-5, 0.8, 10.0)
        warm = solver._replace(rho=torch.full_like(solver.rho, 0.1))
        sol = admm.solve_batch(
            data, warm, max_iter=args.solver_iters,
            scaled_termination=True, eps_abs=1e-4, eps_rel=1e-4, box_tail=n * 12,
        )
        return sol.x[:, 0:12].reshape(1, 4, 3), sol.state, refgen, traj

    def leg_tick(leg_state, q, dq, yc, u0, pos_des, vel_des, wz_des, t):
        leg_obs = L.make_leg_obs(dyn, q, dq, yc)
        out, leg_state = L.compute_torques(
            leg_state, gait, leg_obs, u0, pos_des, vel_des, wz_des, t
        )
        return torch.clamp(out.tau, -45.0, 45.0).reshape(12), leg_state

    # host loop
    state_ref = R.init_state(as_f32(np.concatenate([[0, 0, 0.2488], np.zeros(9)]), dev)[None])
    solver = b1(E.init_state(dyn, n=n).solver)
    leg_state = b1(L.init_state(dev))
    yc = torch.zeros(1, dtype=F32, device=dev)
    yp = torch.zeros(1, dtype=F32, device=dev)
    vf = torch.zeros((1, 6), dtype=F32, device=dev)
    u0 = torch.zeros((1, 4, 3), dtype=F32, device=dev)
    traj = None
    cur_wz = 0.0
    ref_sched = E.reference_schedule(dev) if args.schedule == "ref" else None

    ticks = int(args.seconds * 1000)
    xlog = np.zeros((ticks, 12))
    t0_wall = time.perf_counter()
    for i in range(ticks):
        t = i * 1e-3
        q_np, dq_np = bridge.get_q_dq_pin()
        q = as_f32(q_np, dev)[None]
        dq = as_f32(dq_np, dev)[None]
        obs, yc, yp, vf = observe(q, dq, yc, yp, vf)
        xlog[i] = obs.x_vec[0].detach().cpu().numpy()
        if i % 20 == 0:
            if ref_sched is not None:
                cmd = E.lookup_command(b1(ref_sched), as_f32([t], dev))
                cvx, cvy, cwz = float(cmd.vx[0]), float(cmd.vy[0]), float(cmd.yaw_rate[0])
            else:
                cvx, cvy, cwz = args.vx, args.vy, args.wz
            u0, solver, state_ref, traj = solve_mpc(obs, state_ref, solver, t, cvx, cvy, cwz)
            cur_wz = cwz
        tau, leg_state = leg_tick(
            leg_state, q, dq, yc, u0, traj.pos_des_world, traj.vel_des_world,
            as_f32([cur_wz], dev), as_f32([t], dev),
        )
        bridge.step(tau.detach().cpu().numpy().astype(float))
    wall = time.perf_counter() - t0_wall

    if args.schedule == "ref":
        print(f"{'phase':16s} {'vx':>7s} {'vy':>7s} {'wz':>7s} {'z':>6s} {'|att|max':>8s}")
        for a, b, name in [(0, 1, "fwd 0.7"), (1.5, 3, "lat 0.3"), (4, 6, "yaw 2.0"),
                           (6.5, 8, "fwd0.6+yaw2"), (8, 9, "fwd 0.8"), (9, 10, "stop")]:
            seg = xlog[int(a * 1000):int(b * 1000)]
            if len(seg):
                print(f"{name:16s} {seg[:, 6].mean():+7.3f} {seg[:, 7].mean():+7.3f} "
                      f"{seg[:, 11].mean():+7.3f} {seg[:, 2].mean():6.3f} "
                      f"{np.abs(seg[:, 3:5]).max():8.3f}")
    tail = xlog[len(xlog) // 3:]
    print(f"[mujoco-loop] {args.seconds:.1f}s sim in {wall:.0f}s wall")
    print(
        f"[mujoco-loop] vx={tail[:, 6].mean():+.3f} (cmd {args.vx})  "
        f"vy={tail[:, 7].mean():+.3f} (cmd {args.vy})  "
        f"wz={tail[:, 11].mean():+.3f} (cmd {args.wz})  z={tail[:, 2].mean():.3f}  "
        f"|roll|max={np.abs(tail[:, 3]).max():.3f}  |pitch|max={np.abs(tail[:, 4]).max():.3f}"
    )
    upright = np.abs(xlog[:, 3:5]).max() < 0.5 and xlog[-1, 2] > 0.15
    print(f"[mujoco-loop] upright: {upright}")
    return 0 if upright else 1


if __name__ == "__main__":
    sys.exit(main())
