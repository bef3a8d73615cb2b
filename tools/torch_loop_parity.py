"""Closed-loop force-trajectory parity of the PyTorch/CUDA port: the BASELINE metric, in-loop.

The port's counterpart of ``tools/loop_parity.py``, with its flags, its
report and its exit rule. It runs the port's closed loop (one scenario,
B = 1: ``mpc_cycle_batch`` with ``--adaptive``, the production path with
kernels 1 and 2 on the card; else the legacy ``mpc_cycle_fixed``, kernel 4)
and captures, at every MPC cycle, the exact QP the engine solves, the
applied first-step forces, the leg Jacobians and the stance mask. The
captures are copied to the host as they are taken; after the loop the
independent native f64 oracle (``native/qp_solver.cpp``) solves every
captured QP in a pool of ``spawn``-ed worker processes (this process holds a
CUDA context, which must not be forked). Reported: the error of the applied
forces, and of the applied torques they map to, over the whole run. The
adaptive path must leave no cycle over the 2% budget, the fixed path under
2% of cycles. The last line is the kernels' launch counts in the loop.

Runs on the CUDA card unless ``--cpu`` is given (the plain versions):

    python3 tools/torch_loop_parity.py --adaptive --seconds 2
    python3 tools/torch_loop_parity.py --schedule ref --adaptive --tuned --brake-yaw 10
    python3 tools/torch_loop_parity.py --cpu --adaptive --seconds 0.3
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--vx", type=float, default=0.5)
    ap.add_argument("--wz", type=float, default=0.0)
    ap.add_argument("--solver-iters", type=int, default=400)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    ap.add_argument("--adaptive", action="store_true",
                    help="use the adaptive solver path (mpc_cycle_batch, "
                         "B=1); --solver-iters becomes the escalation cap")
    ap.add_argument("--stall-tol", type=float, default=0.02)
    ap.add_argument("--no-polish", action="store_true")
    ap.add_argument("--schedule", default="const", choices=["const", "ref"],
                    help="'ref' = the full 10s reference command schedule")
    ap.add_argument("--save", default="",
                    help="save per-cycle QPs + engine/oracle solutions to "
                         "this .npz for offline failure analysis")
    ap.add_argument("--tuned", action="store_true",
                    help="tuned cost profile (Q_vy=8) — the recommended "
                         "robust configuration for the full schedule")
    ap.add_argument("--brake-yaw", type=float, default=0.0,
                    help="yaw-deceleration limiter rad/s^2 in BOTH the "
                         "engine and the captured oracle QPs")
    ap.add_argument("--brake", action="store_true",
                    help="braking-limited velocity reference "
                         "(BRAKE_ACCEL_CANDIDATE) in BOTH the "
                         "engine and the captured oracle QPs")
    return ap


def main(argv=None) -> int:
    """Run the loop and the oracle, print the report; returns the exit code."""
    args = parser().parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("torch_loop_parity: no CUDA device (pass --cpu for the plain CPU path)")
    dev = torch.device("cpu" if args.cpu else "cuda")

    import qp_oracle as oracle
    from chip_smoke import _all_kernels
    from convex_mpc_tpu_torch.control import gait as G
    from convex_mpc_tpu_torch.control import leg as LG
    from convex_mpc_tpu_torch.control import reference as R
    from convex_mpc_tpu_torch.models import dynamics as D
    from convex_mpc_tpu_torch.models.go2_params import DEFAULT_PARAMS as _gp
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.sim import physics as P
    from convex_mpc_tpu_torch.utils.config import (
        BRAKE_ACCEL_CANDIDATE, DEFAULT_CONFIG, TUNED_CONFIG)
    from convex_mpc_tpu_torch.utils.native_oracle import solve_all

    host = lambda t: t.detach().cpu().numpy().astype(float)  # noqa: E731
    Q = np.array((TUNED_CONFIG if args.tuned else DEFAULT_CONFIG).mpc.q_diag, float)
    brake_accel = BRAKE_ACCEL_CANDIDATE if args.brake else 0.0
    brake_alpha = args.brake_yaw
    assert not ((args.brake or brake_alpha > 0) and not args.adaptive), \
        "--brake/--brake-yaw require --adaptive (the fixed path has no knob)"
    dyn = D.build_dyn(device=dev)
    gait = G.make_gait_params(3.0, 0.6, device=dev)
    contact = P.default_contact(device=dev)
    if args.schedule == "ref":
        sched = E.reference_schedule(dev)
        args.seconds = max(args.seconds, 10.0)
    else:
        sched = E.constant_schedule(vx=args.vx, wz=args.wz, device=dev)
    state = E.init_state(dyn, n=16)
    state = state._replace(plant=P.init_plant(dyn, contact=contact))
    # the port's cycles are batched: one scenario, B = 1, on both solver paths
    gait_b, contact_b, sched_b, state_b = (E.broadcast_batch(x, 1)
                                           for x in (gait, contact, sched, state))

    tau_lim = np.minimum(
        np.array([_gp.hip_torque_max, _gp.thigh_torque_max, _gp.calf_torque_max]),
        45.0,
    )  # engine clip: min(per-joint ctrlrange, reference TAU_MAX)

    # Phase 1: run the closed loop, capturing each cycle's exact QP instance
    # and the engine's applied force, on the host. Phase 2: solve all captured
    # QPs with the independent native f64 oracle in a worker pool.
    kernels = _all_kernels()
    for k in kernels.values():
        k.launches = 0
    n_cycles = int(round(args.seconds * 50))  # one cycle = 20 ms sim
    qps, u0s, iters, heights, warms = [], [], [], [], []
    jacs, masks = [], []
    for cyc in range(n_cycles):
        if args.save:
            # warm-start state ENTERING this cycle's solve, so any flagged
            # accept can be reproduced offline
            warms.append([host(v[0]).astype(np.float32) for v in state_b.solver])
        # capture the exact QP the engine will solve this cycle
        cmd = E.lookup_command(sched_b, state_b.t)
        obs, _, _ = E.observe(dyn, state_b.plant, state_b.yaw_cont, state_b.yaw_prev,
                              state_b.vel_filt)
        traj, _ = R.generate(state_b.refgen, gait_b, obs, cmd, state_b.t, (1 / 3.0) / 16, 16,
                             brake_accel=brake_accel, brake_alpha=brake_alpha)
        p0 = host(traj.x0[0, 0:3])
        x0_s = host(traj.x0[0]).copy()
        x0_s[0:3] = 0.0
        x_ref_s = host(traj.x_ref[0]).copy()
        x_ref_s[:, 0:3] -= p0
        qps.append(oracle.assemble_qp(
            host(traj.dyn.Ad[0]), host(traj.dyn.Bd[0]), host(traj.dyn.gd[0]), x0_s, x_ref_s,
            traj.contact[0].cpu().numpy(), Q, 1e-5, 0.8, 10.0,
        ))
        # leg Jacobians + stance mask at the state the force acts on, for
        # the applied-torque parity report (stance map tau = J_leg'(-f),
        # clipped: what actually reaches the actuators)
        leg_obs = LG.make_leg_obs(dyn, state_b.plant.q, state_b.plant.dq, state_b.yaw_cont)
        J = host(leg_obs.J_feet[0])
        jacs.append(np.stack([J[l, :, 6 + 3 * l: 9 + 3 * l] for l in range(4)]))
        masks.append(host(G.current_mask(gait_b, state_b.t)[0]))

        # step the engine (its own solve, warm-started)
        if args.adaptive:
            state_b, log = E.mpc_cycle_batch(
                dyn, gait_b, contact_b, sched_b, state_b,
                solver_iters=args.solver_iters, stall_tol=args.stall_tol,
                polish=not args.no_polish, q_diag=tuple(Q),
                brake_accel=brake_accel, brake_alpha=brake_alpha,
            )
        else:
            state_b, log = E.mpc_cycle_fixed(
                dyn, gait_b, contact_b, sched_b, state_b,
                solver_iters=args.solver_iters, q_diag=tuple(Q),
            )
        iters.append(int(log.solver_iters[0]))
        u0s.append(host(state_b.u0[0]).reshape(12))
        heights.append(float(state_b.plant.q[0, 2]))
        if (cyc + 1) % 100 == 0:
            print(f"  loop: {cyc + 1}/{n_cycles} cycles  z={heights[-1]:.3f}", flush=True)
    launches = {n: k.launches for n, k in kernels.items()}

    refs = [x64[192:204] for x64, _ in solve_all(qps)]

    def tau_of(f12, J, mask):
        """Applied stance torques: tau_leg = J_leg'(-f_leg), engine clip."""
        f = f12.reshape(4, 3) * mask[:, None]
        tau = np.einsum("lji,lj->li", J, -f)
        return np.clip(tau, -tau_lim, tau_lim)

    errs, fzs, tau_errs = [], [], []
    for u0, u_ref0, J, mk in zip(u0s, refs, jacs, masks):
        scale = max(np.abs(u_ref0).max(), 1.0)
        errs.append(np.abs(u0 - u_ref0).max() / scale)
        fzs.append(u_ref0[2::3].sum())
        dtau = tau_of(u0, J, mk) - tau_of(u_ref0, J, mk)
        tau_errs.append(np.abs(dtau / tau_lim).max())  # % of actuator range

    errs = np.asarray(errs) * 100
    it = np.asarray(iters)
    hz = np.asarray(heights)
    if args.save:
        # full QPs only for the interesting (>=1% error) cycles: the whole
        # run's QPs would be a ~400 MB artifact
        bad = np.where(errs >= 1.0)[0][:64]
        payload = dict(errs=errs, iters=it, heights=hz,
                       u0=np.stack(u0s), u_ref=np.stack(refs), bad_idx=bad)
        for name in ("P", "q", "A", "l", "u"):
            payload[f"bad_{name}"] = np.stack([qps[i][name] for i in bad]) \
                if len(bad) else np.zeros((0,))
        for j, fld in enumerate(("x", "z", "y", "rho")):
            payload[f"bad_warm_{fld}"] = np.stack([warms[i][j] for i in bad]) \
                if len(bad) else np.zeros((0,))
        np.savez_compressed(args.save, **payload)
        print(f"saved run + {len(bad)} flagged QPs to {args.save}")
    print(f"height: min {hz.min():.3f}  final {hz[-1]:.3f}  "
          f"(fell: {bool(hz.min() < 0.12)})")
    cmd_desc = "ref schedule" if args.schedule == "ref" else f"vx={args.vx} wz={args.wz}"
    print(f"cycles: {n_cycles}  ({cmd_desc}  "
          f"{'adaptive' if args.adaptive else 'fixed'} solver)")
    print(
        f"in-loop applied-force error vs f64 optimum [%]: "
        f"mean {errs.mean():.3f}  p95 {np.percentile(errs, 95):.3f}  max {errs.max():.3f}"
    )
    te = np.asarray(tau_errs) * 100
    print(
        f"applied-TORQUE error (post J'(-f) + actuator clip) [% of range]: "
        f"mean {te.mean():.3f}  p95 {np.percentile(te, 95):.3f}  max {te.max():.3f}"
    )
    print(f"solver iters: mean {it.mean():.0f}  p95 {np.percentile(it, 95):.0f}  "
          f"max {it.max()}")
    n_over = int((errs > 2.0).sum())
    print(f"over 2% budget: {n_over}/{n_cycles} cycles")
    if n_over:
        worst = np.argsort(errs)[::-1][:12]
        for w in sorted(worst):
            if errs[w] > 2.0:
                print(f"  cycle {w:4d} t={w * 0.02:5.2f}s  err {errs[w]:6.2f}%  "
                      f"iters {iters[w]}  sum_fz_ref {fzs[w]:7.1f} N  "
                      f"tau_err {te[w]:5.2f}% of range")
    print("launches: " + json.dumps(launches), flush=True)
    # adaptive path (iteration escalation) must leave ZERO cycles over budget;
    # the fixed path tolerates up to 2% of cycles (documented round-1 gap)
    ok = n_over == 0 if args.adaptive else (errs > 2.0).mean() < 0.02
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
