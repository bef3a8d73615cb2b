"""Cost decomposition of the port's production cycle on one card, phase by phase.

The port's counterpart of ``tools/cycle_ablation.py``, with its options,
defaults and printed keys. From bench.py's start state settled 8 cycles
(B = ``--batch``, trot 3 Hz duty 0.6, kn 30,000 / dn 1,000, 0.5 m/s), it
times the phases of ``engine.mpc_cycle_batch``:

  pre    — observe + reference generation + condensed QP assembly
           (``engine.cycle_update``); refgen and qpbuild alone beside it
  solve  — ``admm.solve_adaptive`` (warm-started, cap 600), once with the
           structured kernel ``admm_structured.cu`` and once with its plain
           version ``admm_iterations_structured_plain`` swapped in (the JAX
           tool's Pallas route and its XLA twin); ``routes`` says which ran
  ticks  — 20 x 1 kHz leg control + physics (``engine._run_ticks``)
  full   — the whole cycle
  tick subparts (per 20 ticks) — make_leg_obs, make_leg_obs + physics
           step, compute_torques, the two 18 x 18 Cholesky solves.

Each phase runs ``--reps`` reps queued on one stream, with the JAX tool's
data-dependence chain (an epsilon from the last rep's output perturbs the
next rep's input); the device is synchronized once per window and timed
with CUDA events, best of 3 windows after one untimed window. The solve
reads residuals back to the host between chunks, as it does in the cycle.

Runs on the CUDA card; ``--cpu`` runs every kernel's plain version on the
CPU (its times are CPU times, on the host clock). Prints one JSON line and
the ``launches:`` line:

    python3 tools/torch_cycle_ablation.py [--batch 512] [--reps 20]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

MPC_DT = (1.0 / 3.0) / 16
QD = (1, 1, 50, 10, 20, 1, 2, 2, 1, 1, 1, 1)


@contextlib.contextmanager
def plain_structured_chunk():
    """Swap ``admm_iterations_structured_plain`` in for the structured kernel's
    wrapper, where ``admm.solve_adaptive`` looks it up, and restore it after.
    The plain version runs on any device and launches no kernel."""
    from convex_mpc_tpu_torch.mpc import kernels

    kernel = kernels.admm_iterations_structured
    kernels.admm_iterations_structured = kernels.admm_iterations_structured_plain
    try:
        yield
    finally:
        kernels.admm_iterations_structured = kernel


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)
    B, K = args.batch, args.reps

    from chip_smoke import best_seconds, print_launches, start_batch, sync, tool_device
    from convex_mpc_tpu_torch.control import leg as L
    from convex_mpc_tpu_torch.control import reference as R
    from convex_mpc_tpu_torch.mpc import admm, condensed
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.sim import physics as P

    dev = tool_device("torch_cycle_ablation", args.cpu)
    dyn, gait_b, contact_b, sched_b, state_b = start_batch(B, dev)
    for _ in range(8):  # settle into steady trot with warm starts (a mid-run state)
        state_b, _ = E.mpc_cycle_batch(dyn, gait_b, contact_b, sched_b, state_b)
    sync(dev)

    qd = torch.as_tensor(QD, dtype=torch.float32, device=dev)
    zero = torch.zeros((), device=dev)

    def with_dz(st, eps):
        q = st.plant.q.clone()
        q[:, 2] += eps
        return st._replace(plant=st.plant._replace(q=q))

    def pre(st):
        return E.cycle_update(dyn, gait_b, sched_b, st, qd, 16, MPC_DT, 1e-5, 0.8, 10.0)

    def refgen(st):
        cmd = E.lookup_command(sched_b, st.t)
        obs, yc, yp = E.observe(dyn, st.plant, st.yaw_cont, st.yaw_prev, st.vel_filt)
        traj, _ = R.generate(st.refgen, gait_b, obs, cmd, st.t, MPC_DT, 16)
        return traj

    def build(traj):
        p0 = traj.x0[:, 0:3]
        x0_s = torch.cat([torch.zeros_like(p0), traj.x0[:, 3:]], dim=-1)
        x_ref_s = torch.cat([traj.x_ref[:, :, 0:3] - p0[:, None, :], traj.x_ref[:, :, 3:]], -1)
        return condensed.build_condensed_structured(traj.dyn, x0_s, x_ref_s, traj.contact, qd,
                                                    1e-5, 0.8, 10.0)[0]

    data_b, traj_b, _, cmd_b, _, _ = pre(state_b)
    u0_b = state_b.u0

    def run_pre():
        eps = zero
        for _ in range(K):
            eps = pre(with_dz(state_b, eps))[0].q.sum() * 1e-30

    def run_refgen():
        eps = zero
        for _ in range(K):
            eps = refgen(with_dz(state_b, eps)).x_ref.sum() * 1e-30

    def run_qpbuild():
        eps = zero
        for _ in range(K):
            eps = build(traj_b._replace(x_ref=traj_b.x_ref + eps)).q.sum() * 1e-30

    iters_log = []

    def run_solve():
        eps = zero
        for _ in range(K):
            sol = admm.solve_adaptive(data_b._replace(q=data_b.q + eps), state_b.solver,
                                      max_iter=600, box_tail=192)
            eps = sol.x.sum() * 1e-30
            iters_log.append(sol.iters)

    def run_ticks():
        plant, leg, vf, t = state_b.plant, state_b.leg, state_b.vel_filt, state_b.t
        for _ in range(K):
            (plant, leg, _, _, vf, t), _ = E._run_ticks(
                dyn, gait_b, contact_b, cmd_b, traj_b, u0_b, plant, leg, state_b.yaw_cont,
                state_b.yaw_prev, vf, t, 20, 45.0, 1e-3, 30.0)

    def run_full():
        s = state_b
        for _ in range(K):
            s, _ = E.mpc_cycle_batch(dyn, gait_b, contact_b, sched_b, s)

    yaw0 = torch.zeros((B,), device=dev)

    def run_leg_obs():
        eps = zero
        for _ in range(K * 20):
            q = state_b.plant.q.clone()
            q[:, 2] += eps
            eps = L.make_leg_obs(dyn, q, state_b.plant.dq, yaw0).foot_pos.sum() * 1e-30

    tau0 = torch.zeros((B, 12), device=dev)

    def run_plant_step():
        plant = state_b.plant
        for _ in range(K * 20):
            o = L.make_leg_obs(dyn, plant.q, plant.dq, yaw0)
            plant = P.step(dyn, contact_b, plant, tau0, 1e-3, J=o.J_feet, M=o.M, bias=o.bias,
                           base_R=o.base_R, foot_pos=o.foot_pos, foot_vel=o.foot_vel)

    obs_b = L.make_leg_obs(dyn, state_b.plant.q, state_b.plant.dq, yaw0)

    def run_torques():
        eps, leg = zero, state_b.leg
        for _ in range(K * 20):
            ob = obs_b._replace(foot_pos=obs_b.foot_pos + eps)
            out, leg = L.compute_torques(leg, gait_b, ob, u0_b, traj_b.pos_des_world,
                                         traj_b.vel_des_world, cmd_b.yaw_rate, state_b.t)
            eps = out.tau.sum() * 1e-30

    eye18 = torch.eye(18, device=dev)
    Jt = obs_b.J_feet.transpose(-1, -2)  # (B, 4, 18, 3): each leg's J' as right-hand sides

    def run_chol():
        eps = zero
        for _ in range(K * 20):
            c = torch.linalg.cholesky(obs_b.M + eps * eye18)
            eps = torch.cholesky_solve(Jt, c[:, None]).sum() * 1e-30

    res = {}
    res["pre_ms"] = best_seconds(run_pre, dev) / K * 1e3
    res["refgen_ms"] = best_seconds(run_refgen, dev) / K * 1e3
    res["qpbuild_ms"] = best_seconds(run_qpbuild, dev) / K * 1e3
    with plain_structured_chunk():
        res["solve_xla_twin_ms"] = best_seconds(run_solve, dev) / K * 1e3
    iters_log.clear()
    res["solve_ms"] = best_seconds(run_solve, dev) / K * 1e3
    res["solve_iters_mean"] = float(torch.cat(iters_log).double().mean())
    res["ticks_ms"] = best_seconds(run_ticks, dev) / K * 1e3
    res["full_ms"] = best_seconds(run_full, dev) / K * 1e3
    res["legobs_plus_step_ms_per_cycle"] = best_seconds(run_plant_step, dev) / K * 1e3
    res["legobs_ms_per_cycle"] = best_seconds(run_leg_obs, dev) / K * 1e3
    res["torques_ms_per_cycle"] = best_seconds(run_torques, dev) / K * 1e3
    res["chol_solve_ms_per_cycle"] = best_seconds(run_chol, dev) / K * 1e3
    res["batch"] = B
    res["reps"] = K
    res["backend"] = dev.type
    res["solves_per_s_full"] = B / (res["full_ms"] / 1e3)
    kernel_route = "cuda: admm_structured.cu" if dev.type == "cuda" else "cpu: plain version"
    res["routes"] = {"solve_ms": f"admm_iterations_structured ({kernel_route})",
                     "solve_xla_twin_ms": "admm_iterations_structured_plain (plain PyTorch, "
                                          "swapped in)"}
    print(json.dumps(res), flush=True)
    res["launches"] = print_launches()
    return res


if __name__ == "__main__":
    main()
