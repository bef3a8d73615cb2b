"""Per-cycle update-vs-solve timing dashboard of the PyTorch/CUDA port (reference plot_solve_time).

The port's counterpart of ``tools/time_dashboard.py``, with its start state,
its flags and its JSON keys. The reference plots per-MPC-cycle wall time
split into "update" (model + reference + QP assembly) and "solve" (OSQP)
against the 48 Hz real-time budget (reference plot_helper.py:217-253,
test_MPC.py:208-213). This tool measures the same split for the port's
batched production cycle, cycle by cycle, from ``mpc_cycle_batch``'s own
stage marks (``profile=dict``: the device synchronized at each stage's end):

  update: lookup + observe + reference generation + condensed QP build
  solve:  batch-global adaptive ADMM (+ certified polish)
  apply:  20 x 1 kHz leg-control/physics ticks + state carry

The synchronizations lose the overlap of host and device between stages, so
the stage sums overstate the free-running cycle (``tools/torch_bench.py``
measures that one); the dashboard's value is the per-cycle shape: which
cycles spike, and in which stage. The first cycle (the kernels' first use)
is discarded, as the JAX tool discards its compile cycle.

Prints one JSON line (``--json PATH`` also writes it), and plots
``plot_cycle_time`` against the 20.833 ms budget only when ``--out`` is
given (matplotlib; the card's machine has none). Runs on the CUDA card
unless ``--cpu`` is given (the plain versions):

    python3 tools/torch_time_dashboard.py [--batch 512] [--seconds 10] [--tuned]
        [--out artifacts/cycle_time_torch.png] [--json out.json]
    python3 tools/torch_time_dashboard.py --cpu --batch 2 --seconds 0.1 --json out.json

Also run by ``examples/torch_trot_demo.py --plots DIR --time-dashboard``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BUDGET_MS = 20.833  # the 48 Hz replan period


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--tuned", action="store_true")
    ap.add_argument("--schedule", default="ref", choices=["ref", "const"])
    ap.add_argument("--vx", type=float, default=0.5)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    ap.add_argument("--out", default=None,
                    help="write the stacked-bar plot here (needs matplotlib)")
    ap.add_argument("--json", default="")
    return ap


def main(argv=None) -> dict:
    """Run the dashboard, print its JSON line and return it as a dict."""
    args = parser().parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("torch_time_dashboard: no CUDA device (pass --cpu for the plain CPU path)")
    dev = torch.device("cpu" if args.cpu else "cuda")

    from chip_smoke import _all_kernels, card_identity
    from convex_mpc_tpu_torch.control import gait as G
    from convex_mpc_tpu_torch.models import dynamics as D
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.sim import physics as P
    from convex_mpc_tpu_torch.utils.config import DEFAULT_CONFIG, TUNED_CONFIG

    B, n = args.batch, 16
    cfg = TUNED_CONFIG if args.tuned else DEFAULT_CONFIG
    dyn = D.build_dyn(device=dev)
    contact = P.default_contact(kn=30000, dn=1000, device=dev)
    gait_b = E.broadcast_batch(G.make_gait_params(3.0, 0.6, device=dev), B)
    contact_b = E.broadcast_batch(contact, B)
    sched = (E.reference_schedule(dev) if args.schedule == "ref"
             else E.constant_schedule(vx=args.vx, device=dev))
    sched_b = E.broadcast_batch(sched, B)
    state = E.init_state(dyn, n=n)
    state = state._replace(plant=P.init_plant(dyn, contact=contact))
    state_b = E.broadcast_batch(state, B)
    q = state_b.plant.q.clone()
    q[:, 0] += torch.linspace(-0.02, 0.02, B, device=dev)
    state_b = state_b._replace(plant=state_b.plant._replace(q=q))
    kw = dict(n=n, solver_iters=args.iters, q_diag=cfg.mpc.q_diag,
              r_value=cfg.mpc.r_diag_value, mu_mpc=cfg.mpc.mu, fz_min=cfg.mpc.fz_min)

    kernels = _all_kernels()
    n_cycles = int(round(args.seconds * 50))
    t_upd, t_sol, t_app, iters = [], [], [], []
    for cyc in range(n_cycles):
        prof: dict = {}
        state_b, log = E.mpc_cycle_batch(dyn, gait_b, contact_b, sched_b, state_b,
                                         profile=prof, **kw)
        if cyc == 0:  # the kernels' first use: discard, and count launches after it
            for k in kernels.values():
                k.launches = 0
            continue
        dt_u, dt_s, dt_a = (prof[k] * 1e3 for k in ("update", "solve", "apply"))
        t_upd.append(dt_u)
        t_sol.append(dt_s)
        t_app.append(dt_a)
        iters.append(int(log.solver_iters.float().mean()))
        if (cyc + 1) % 100 == 0:
            print(f"  {cyc + 1}/{n_cycles}  upd {dt_u:.1f}  sol {dt_s:.1f} "
                  f"app {dt_a:.1f} ms", flush=True)

    z = state_b.plant.q[:, 2]
    healthy = bool(torch.isfinite(z).all() and (z > 0.1).all())
    u, s, a = map(np.asarray, (t_upd, t_sol, t_app))
    timed = max(len(u), 1)
    report = {
        "batch": B,
        "cycles": len(u),
        "update_ms_mean": round(float(u.mean()), 2),
        "solve_ms_mean": round(float(s.mean()), 2),
        "apply_ms_mean": round(float(a.mean()), 2),
        "total_ms_p99": round(float(np.percentile(u + s + a, 99)), 2),
        "iters_mean": round(float(np.mean(iters)), 1),
        "healthy": healthy,
        "note": "mpc_cycle_batch stage marks, the device synchronized at each stage's end; "
                "host time of the synchronizations not subtracted",
        "device": "cpu" if args.cpu else card_identity(),
        "launches_per_cycle": {n_: k.launches / timed for n_, k in kernels.items()},
    }
    print(json.dumps(report), flush=True)
    if args.json:
        Path(args.json).write_text(json.dumps(report, indent=2))

    if args.out:
        from convex_mpc_tpu_torch.utils import plots as PL

        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        PL.plot_cycle_time(u, s, a, budget_ms=BUDGET_MS, batch=B, path=out)
        print(f"wrote {out}")
    return report


if __name__ == "__main__":
    main()
