"""BASELINE config 5 in one run on the port: multi-gait x multi-horizon at >= 10k scale.

The port's counterpart of ``tools/multi_config_bench.py``, with its
configurations, options, defaults and report keys. A grid of gait variants
(trot duty/frequency spread, bound, pace) x MPC horizons {10, 16, 24, 32}
runs through the production batched adaptive cycle (``mpc_cycle_batch``)
as sub-batches of ``--chunk`` scenarios, each one eager call per cycle on
the card.

All sub-batches of all configs advance TOGETHER each cycle (>= 10k
concurrent scenarios resident on the card); the aggregate rate is measured
over full interleaved rounds (best of 3 windows of ``--reps`` rounds), then
each config is timed alone for its per-config solves/s. Upright rate per
config at the end: 0.1 < z < 0.6, |roll|, |pitch| < 0.6, all of q finite.
``mpc_dt`` is the gait period over the horizon.

At horizon 10 (nz = 120) kernel 1 inverts the KKT matrix on its panel grid
padded to 128 and the structured chunk runs its generic instance (nb = 40).

Runs on the CUDA card; ``--cpu`` runs every kernel's plain version on the
CPU (for tests; its times are CPU times). Prints the card's name and power
limit, one JSON line per config, the report (also written to ``--json``)
and the ``launches:`` line:

    python3 tools/torch_multi_config_bench.py [--per-config 1280] [--chunk 640]
        [--reps 5] [--json artifacts/multi_config_torch.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

TROT = (0.5, 0.0, 0.0, 0.5)
BOUND = (0.0, 0.0, 0.5, 0.5)
PACE = (0.5, 0.0, 0.5, 0.0)

# name, phase_offset, freq, duty, horizon, vx
CONFIGS = [
    ("trot_n16", TROT, 3.0, 0.6, 16, 0.5),
    ("trot_fast_duty05_n16", TROT, 3.5, 0.5, 16, 0.5),
    ("trot_slow_duty07_n16", TROT, 2.5, 0.7, 16, 0.5),
    ("bound_n16", BOUND, 3.0, 0.6, 16, 0.3),
    ("pace_n16", PACE, 3.0, 0.6, 16, 0.3),
    ("trot_n10", TROT, 3.0, 0.6, 10, 0.5),
    ("trot_n24", TROT, 3.0, 0.6, 24, 0.5),
    ("trot_n32", TROT, 3.0, 0.6, 32, 0.5),
]


def upright_rate(q: torch.Tensor) -> float:
    """Share of scenarios with 0.1 < z < 0.6, |roll|, |pitch| < 0.6 and q finite."""
    from convex_mpc_tpu_torch.ops.rotations import quat_to_rpy

    z = q[:, 2]
    att_ok = torch.abs(quat_to_rpy(q[:, 3:7])[:, 0:2]).amax(dim=1) < 0.6
    ok = (z > 0.1) & (z < 0.6) & torch.isfinite(z) & att_ok & torch.isfinite(q).all(dim=1)
    return float(ok.double().mean())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--per-config", type=int, default=1280,
                    help="scenarios per config (8 configs x 1280 = 10240)")
    ap.add_argument("--chunk", type=int, default=640,
                    help="sub-batch size, one eager call per cycle each (kept from the JAX "
                         "tool, where single TPU programs >= 1024 hit a platform cliff)")
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--settle", type=int, default=16,
                    help="cycles to settle warm starts before timing")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    ap.add_argument("--smoke", action="store_true", help="tiny shapes for a CPU smoke run")
    ap.add_argument("--json", default="artifacts/multi_config_torch.json")
    args = ap.parse_args(argv)

    from chip_smoke import print_launches, sync, tool_device
    from convex_mpc_tpu_torch.control import gait as G
    from convex_mpc_tpu_torch.models import dynamics as D
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.sim import physics as P

    dev = tool_device("torch_multi_config_bench", args.cpu)
    if args.smoke:
        args.per_config, args.chunk, args.iters = 4, 2, 100
        args.reps, args.settle = 2, 2

    per, chunk = args.per_config, args.chunk
    if per % chunk:
        raise SystemExit("--per-config must be divisible by --chunk")
    dyn = D.build_dyn(device=dev)
    contact = P.default_contact(device=dev)

    runners = []  # [name, fn, [sub_states]]
    for name, po, freq, duty, n, vx in CONFIGS:
        gait_b = E.broadcast_batch(G.make_gait_params(freq, duty, phase_offset=po, device=dev),
                                   chunk)
        contact_b = E.broadcast_batch(contact, chunk)
        sched_b = E.broadcast_batch(E.constant_schedule(vx=vx, device=dev), chunk)
        mpc_dt = (1.0 / freq) / n

        def fn(state, gait_b=gait_b, contact_b=contact_b, sched_b=sched_b, n=n, mpc_dt=mpc_dt):
            s, log = E.mpc_cycle_batch(dyn, gait_b, contact_b, sched_b, state, n=n,
                                       solver_iters=args.iters, mpc_dt=mpc_dt)
            return s, log.solver_iters

        base = E.init_state(dyn, n=n)._replace(plant=P.init_plant(dyn, contact=contact))
        subs = []
        for k in range(per // chunk):
            sb = E.broadcast_batch(base, chunk)
            q = sb.plant.q.clone()
            q[:, 0] += torch.linspace(-0.02, 0.02, chunk, device=dev) + 0.001 * k
            subs.append(sb._replace(plant=sb.plant._replace(q=q)))
        runners.append([name, fn, subs])

    total = per * len(CONFIGS)
    print(f"configs: {len(CONFIGS)} x {per} = {total} concurrent scenarios, "
          f"{per // chunk} sub-batches of {chunk} each", flush=True)

    def advance_all():
        for r in runners:
            r[2] = [r[1](s)[0] for s in r[2]]

    t0 = time.time()
    for i in range(args.settle):  # first use (kernel load) + settle warm starts
        advance_all()
        sync(dev)
        if i == 0:
            print(f"first round in {time.time() - t0:.0f}s", flush=True)

    # aggregate: all configs interleaved (the >= 10k-concurrent claim)
    best_all = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(args.reps):
            advance_all()
        sync(dev)
        best_all = min(best_all, (time.perf_counter() - t0) / args.reps)

    # per-config rate: each config alone
    per_cfg = {}
    for runner, (name, po, freq, duty, n, vx) in zip(runners, CONFIGS):
        _, fn, subs = runner
        best, iters_log = float("inf"), []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(args.reps):
                out = [fn(s) for s in subs]
                subs = [o[0] for o in out]
                iters_log.append(torch.cat([o[1] for o in out]))
            sync(dev)
            best = min(best, (time.perf_counter() - t0) / args.reps)
        runner[2] = subs
        it = torch.cat(iters_log).double().cpu().numpy()
        per_cfg[name] = {
            "horizon": n,
            "gait": f"{freq}Hz/{duty}",
            "scenarios": per,
            "ms_per_cycle": best * 1e3,
            "solves_per_s": per / best,
            "upright_rate": upright_rate(torch.cat([s.plant.q for s in subs])),
            "iters_mean": float(it.mean()),
            "iters_p99": float(np.percentile(it, 99)),
        }
        print(json.dumps({name: per_cfg[name]}), flush=True)

    report = {
        "metric": "multi_config_throughput",
        "total_concurrent_scenarios": total,
        "aggregate_ms_per_cycle": best_all * 1e3,
        "aggregate_solves_per_s": total / best_all,
        "all_upright": all(v["upright_rate"] == 1.0 for v in per_cfg.values()),
        "configs": per_cfg,
    }
    print(json.dumps(report), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(report, indent=2))
    report["launches"] = print_launches()
    return report


if __name__ == "__main__":
    main()
