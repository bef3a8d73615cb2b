"""Closed-loop Go2 trot demo on the PyTorch/CUDA port — the equivalent of the reference's
main entry (reference convex_mpc/test_MPC.py).

The port's counterpart of ``examples/trot_demo.py``, with its flags and its
per-phase tracking summary. Runs the reference's 10 s command schedule
(forward 0.7, lateral 0.3, yaw 2.0, forward+yaw, forward 0.8 m/s), or a
constant command, through the port's production path at B = 1
(``engine.simulate``, i.e. ``mpc_cycle``: kernels 1 and 2 on the card;
with ``--adaptive``, ``simulate_batched`` in chunks of at most 50 cycles),
prints the tracking summary, and can save the dashboard plots
(``--plots``, needs matplotlib), the per-cycle timing split
(``--time-dashboard``, ``tools/torch_time_dashboard.py``), the trajectory
(``--save-traj``) and replay the run in the host MuJoCo viewer
(``--replay``, needs mujoco). Runs on the CUDA card unless ``--cpu`` is
given (the plain versions):

    python3 examples/torch_trot_demo.py [--seconds 10] [--vx V | --schedule ref]
        [--plots DIR] [--replay] [--cpu]
    python3 examples/torch_trot_demo.py --schedule const --vx 0.5 --seconds 2
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--schedule", default="ref", choices=["ref", "const"])
    ap.add_argument("--vx", type=float, default=0.5)
    ap.add_argument("--wz", type=float, default=0.0)
    ap.add_argument("--vy", type=float, default=0.0)
    ap.add_argument("--plots", default=None, help="directory to save dashboards")
    ap.add_argument("--time-dashboard", action="store_true",
                    help="with --plots: also measure + plot the per-cycle "
                         "update/solve/ticks timing split "
                         "(tools/torch_time_dashboard.py)")
    ap.add_argument("--replay", action="store_true", help="interactive MuJoCo replay")
    ap.add_argument("--save-traj", default=None, help="save q/tau/x logs to this .npz")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    ap.add_argument("--solver-iters", type=int, default=400)
    ap.add_argument("--ramp", action="store_true",
                    help="slew-rate-limit the command schedule (widens margins)")
    ap.add_argument("--tuned", action="store_true",
                    help="tuned cost profile (Q_vy=8; tighter lateral tracking)")
    ap.add_argument("--adaptive", action="store_true",
                    help="batch-global adaptive solver (early exit + "
                         "refactor-on-demand); --solver-iters becomes the cap")
    ap.add_argument("--stall-tol", type=float, default=0.05,
                    help="adaptive solver fixed-point stall exit [N]")
    return ap


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _concat(logs_l):
    """Chunks' CycleLogs (cycles first) -> one CycleLog over all cycles."""
    from convex_mpc_tpu_torch.utils.interop import tree_leaves, tree_unflatten

    leaves = [torch.cat(v, dim=0) for v in zip(*(tree_leaves(lg) for lg in logs_l))]
    return tree_unflatten(logs_l[0], leaves)


def tracking(x: np.ndarray, phases) -> list[dict]:
    """Per-phase means of the body-frame velocities, yaw rate and height, and
    the largest |roll|, |pitch|, over (start s, end s, name) windows of the
    per-tick centroidal state x (T, 12)."""
    rows = []
    for a, b, name in phases:
        seg = x[int(a * 1000):int(b * 1000)]
        if len(seg) == 0:
            continue
        # velocities in the BODY frame (world components mislead while turning)
        cy, sy = np.cos(seg[:, 5]), np.sin(seg[:, 5])
        vxb = seg[:, 6] * cy + seg[:, 7] * sy
        vyb = -seg[:, 6] * sy + seg[:, 7] * cy
        rows.append({"phase": name, "vx_b": float(vxb.mean()), "vy_b": float(vyb.mean()),
                     "wz": float(seg[:, 11].mean()), "z": float(seg[:, 2].mean()),
                     "att_max": float(np.abs(seg[:, 3:5]).max())})
    return rows


def main(argv=None) -> list[dict]:
    """Run the demo; returns the per-phase tracking rows."""
    args = parser().parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("torch_trot_demo: no CUDA device (pass --cpu for the plain CPU path)")
    dev = torch.device("cpu" if args.cpu else "cuda")

    from chip_smoke import _all_kernels
    from convex_mpc_tpu_torch.control import gait as G
    from convex_mpc_tpu_torch.models import dynamics as D
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.sim import physics as P
    from convex_mpc_tpu_torch.utils.config import DEFAULT_CONFIG, TUNED_CONFIG
    from convex_mpc_tpu_torch.utils.interop import tree_map

    dyn = D.build_dyn(device=dev)
    gait = G.make_gait_params(3.0, 0.6, device=dev)
    contact = P.default_contact(kn=30000, dn=1000, device=dev)
    if args.schedule == "ref":
        sched = E.reference_schedule(dev)
    else:
        sched = E.constant_schedule(vx=args.vx, vy=args.vy, wz=args.wz, device=dev)
    if args.ramp:
        sched = E.ramp_schedule(sched if args.schedule == "ref" else E.constant_schedule(
            vx=args.vx, vy=args.vy, wz=args.wz, t_end=args.seconds, device=dev))

    # one mpc_cycle advances steps_per_mpc*sim_dt = 20 ms -> 50 cycles/s
    n_cycles = int(round(args.seconds * 50))
    state = E.init_state(dyn, n=16)
    state = state._replace(plant=P.init_plant(dyn, contact=contact))

    print(f"[demo] device={dev.type}  simulating {args.seconds:.1f}s "
          f"({n_cycles} MPC cycles) ...", flush=True)
    kernels = _all_kernels()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    q_diag = (TUNED_CONFIG if args.tuned else DEFAULT_CONFIG).mpc.q_diag
    if args.adaptive:
        # batched engine at B=1: batch-global adaptive solver with early
        # exit, in chunks of at most 50 cycles as the JAX demo runs its scan
        gait_b, contact_b, sched_b, state_b = (E.broadcast_batch(x, 1)
                                               for x in (gait, contact, sched, state))
        chunks, logs_l = max(1, n_cycles // 50), []
        for c in range(chunks):
            n_c = n_cycles // chunks + (1 if c < n_cycles % chunks else 0)
            state_b, lg = E.simulate_batched(
                dyn, gait_b, contact_b, sched_b, state_b, n_cycles=n_c,
                solver_iters=args.solver_iters, q_diag=q_diag,
                stall_tol=args.stall_tol,
            )
            logs_l.append(tree_map(lambda a: a[:, 0], lg))
        logs = _concat(logs_l)
        state = tree_map(lambda a: a[0], state_b)
    else:
        state, logs = E.simulate(
            dyn, gait, contact, sched, state, n_cycles=n_cycles,
            solver_iters=args.solver_iters, q_diag=q_diag,
        )
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    print(f"[demo] done in {wall:.1f}s wall ({args.seconds / wall:.2f}x realtime)")

    x = _host(logs.ticks.x_vec).reshape(-1, 12)
    assert np.isfinite(x).all(), "simulation produced non-finite state"

    # per-phase tracking summary
    phases = (
        [(0, 1, "fwd 0.7"), (1.5, 3, "lat 0.3"), (4, 6, "yaw 2.0"),
         (6.5, 8, "fwd 0.6 + yaw 2"), (8, 9, "fwd 0.8"), (9, 10, "stop")]
        if args.schedule == "ref"
        else [(0.5, args.seconds, f"vx={args.vx} vy={args.vy} wz={args.wz}")]
    )
    rows = tracking(x, phases)
    print(f"{'phase':18s} {'vx_b':>7s} {'vy_b':>7s} {'wz':>7s} {'z':>6s} {'|att|max':>8s}")
    for r in rows:
        print(f"{r['phase']:18s} {r['vx_b']:+7.3f} {r['vy_b']:+7.3f} "
              f"{r['wz']:+7.3f} {r['z']:6.3f} {r['att_max']:8.3f}")
    it = _host(logs.solver_iters)
    print(f"[demo] solver: mean {it.mean():.0f} iters/cycle, "
          f"converged {(it < args.solver_iters).mean() * 100:.0f}% of cycles")
    print("[demo] phases: " + json.dumps(rows))
    print("[demo] launches: " + json.dumps(launches), flush=True)

    if args.plots:
        _plots(args, dev, dyn, gait, sched, state, logs, x, q_diag)

    if args.save_traj:
        q_log = _host(logs.ticks.q).reshape(-1, 19)
        tau_log = _host(logs.ticks.tau).reshape(-1, 12)
        np.savez_compressed(
            args.save_traj,
            t=np.arange(len(q_log)) * 1e-3, q=q_log, tau=tau_log, x_vec=x,
            force=_host(logs.ticks.force).reshape(-1, 12),
        )
        print(f"[demo] trajectory saved to {args.save_traj} "
              f"(replay offline: python -c \"import numpy as np; "
              f"from convex_mpc_tpu_torch.sim.mujoco_bridge import MujocoGo2; "
              f"d=np.load('{args.save_traj}'); MujocoGo2().replay(d['t'], d['q'], d['tau'])\")")

    if args.replay:
        from convex_mpc_tpu_torch.sim.mujoco_bridge import MujocoGo2

        q_log = _host(logs.ticks.q).reshape(-1, 19)
        tau_log = _host(logs.ticks.tau).reshape(-1, 12)
        t_log = np.arange(len(q_log)) * 1e-3
        MujocoGo2().replay(t_log, q_log, tau_log)
    return rows


def _plots(args, dev, dyn, gait, sched, state, logs, x, q_diag) -> None:
    """The dashboards of the run, the horizon-level ones from one extra MPC
    solve at the final state, and with ``--time-dashboard`` the per-cycle
    timing split."""
    from convex_mpc_tpu_torch._device import as_f32
    from convex_mpc_tpu_torch.control import reference as R
    from convex_mpc_tpu_torch.control import srb as S
    from convex_mpc_tpu_torch.mpc import admm, condensed
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.utils import plots as PL
    from convex_mpc_tpu_torch.utils.interop import tree_map

    out = Path(args.plots)
    out.mkdir(parents=True, exist_ok=True)
    PL.plot_contact_forces(logs, out / "contact_forces.png")
    PL.plot_mpc_result(logs, out / "mpc_result.png")
    PL.plot_swing_foot_traj(logs, out / "swing_foot.png")
    PL.plot_solver_stats(logs, path=out / "solver.png")
    PL.plot_traj_tracking(x, path=out / "traj3d.png")

    # horizon-level dashboards from one extra MPC solve at the final state:
    # reference-vs-optimized overlay (reference plot_helper.py:255-304) and
    # the open-loop SRB validation (test_MPC.py:256-266); B = 1 throughout
    b1 = lambda tree: tree_map(lambda a: a[None], tree)  # noqa: E731
    s1, g1 = b1(state), b1(gait)
    cmd = E.lookup_command(b1(sched), s1.t)
    obs, _, _ = E.observe(dyn, s1.plant, s1.yaw_cont, s1.yaw_prev, s1.vel_filt)
    traj, _ = R.generate(s1.refgen, g1, obs, cmd, s1.t, (1 / 3.0) / 16, 16)
    p0 = traj.x0[:, 0:3]
    x0_s = torch.cat([torch.zeros_like(p0), traj.x0[:, 3:]], dim=-1)
    x_ref_s = torch.cat([traj.x_ref[:, :, 0:3] - p0[:, None, :], traj.x_ref[:, :, 3:]], dim=-1)
    data, aux = condensed.build_condensed(traj.dyn, x0_s, x_ref_s, traj.contact,
                                          as_f32(q_diag, dev), 1e-5, 0.8, 10.0)
    warm = s1.solver._replace(rho=torch.full_like(s1.solver.rho, 0.1))
    sol = admm.solve_batch(data, warm, max_iter=args.solver_iters,
                           scaled_termination=True, box_tail=16 * 12)
    x_opt = condensed.recover_states(aux, x0_s, sol.x)
    x_roll = S.rollout(traj.dyn, x0_s, sol.x.reshape(1, 16, 12))
    PL.plot_full_traj(x_opt[0], x_ref_s[0], path=out / "full_traj.png")
    PL.plot_open_loop_validation(x_opt[0], x_roll[0], x_ref_s[0],
                                 path=out / "open_loop_validation.png")

    if args.time_dashboard:
        # per-cycle update-vs-solve stacked bars (reference
        # plot_helper.py:217-253), from the cycle's own stage marks
        subprocess.run(
            [
                sys.executable, str(ROOT / "tools" / "torch_time_dashboard.py"),
                "--batch", "1", "--seconds", str(args.seconds),
                "--schedule", args.schedule,
                "--iters", str(args.solver_iters),
                "--out", str(out / "cycle_time.png"),
            ]
            + (["--tuned"] if args.tuned else [])
            + (["--cpu"] if args.cpu else []),
            check=False,
        )
    print(f"[demo] plots saved to {out}/")


if __name__ == "__main__":
    main()
