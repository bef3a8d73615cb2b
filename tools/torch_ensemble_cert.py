"""Ensemble closed-loop certification of the PyTorch port: pass-RATES, not single rolls.

The port's counterpart of ``tools/ensemble_cert.py``, with its flags, its
report fields and its Clopper-Pearson bound. A B-scenario ensemble of the
reference's 10 s command schedule runs from perturbed initial states (+-mm
positions, +-mrad attitude and joints, +-mm/s velocities; scenario 0 is the
unperturbed nominal roll) through the production cycle
(``engine.simulate_batched``, the batch-global adaptive solver), one second
(50 cycles) at a time. Single trajectories of the schedule are
chaos-marginal, so the verdict is the pass-rate and its 95% lower bound.

Pass criterion per scenario: finite trajectory, |roll, pitch| < 0.6 rad
throughout, z in [0.12, 0.6] m throughout, upright at the end (z > 0.15 m)
and stopped at the end (mean |vx, vy| of the last 0.5 s < 0.1 m/s).

Runs on the CUDA card (the port's kernels) unless ``--cpu`` is given (every
kernel's plain version). Imports the port only, no JAX:

  python tools/torch_ensemble_cert.py --batch 64 --tuned --brake-yaw 10
  python tools/torch_ensemble_cert.py --batch 64 --tuned --brake-yaw 10 --fused-ticks
  python tools/torch_ensemble_cert.py --cpu --batch 2 --seconds 1
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


def clopper_pearson_low(k: int, n: int, conf: float = 0.95) -> float:
    """Lower confidence bound for a binomial proportion."""
    if k == 0:
        return 0.0
    try:
        from scipy.stats import beta

        return float(beta.ppf(1.0 - conf, k, n - k + 1))
    except ImportError:
        # Wilson fallback if scipy is unavailable
        from math import sqrt

        z = 1.645 if conf == 0.95 else 2.326
        p = k / n
        den = 1 + z * z / n
        mid = p + z * z / (2 * n)
        rad = z * sqrt(p * (1 - p) / n + z * z / (4 * n * n))
        return max(0.0, (mid - rad) / den)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seconds", type=int, default=12,
                    help="10 s schedule + settle window (stop asserted at end)")
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--tuned", action="store_true",
                    help="tuned profile instead of raw reference weights")
    ap.add_argument("--return-iterate", action="store_true",
                    help="return the raw ADMM iterate instead of the certified polished point")
    ap.add_argument("--xla", action="store_true",
                    help="the JAX tool's XLA-twin engine; the port has none (refused)")
    ap.add_argument("--ramp", action="store_true",
                    help="slew-rate-limit the command schedule (engine.ramp_schedule)")
    ap.add_argument("--brake", action="store_true",
                    help="deceleration-limited velocity reference into stops "
                         "(BRAKE_ACCEL_CANDIDATE)")
    ap.add_argument("--brake-yaw", type=float, default=0.0,
                    help="yaw-deceleration limiter rad/s^2 on the reference (0 = spec)")
    ap.add_argument("--fused-ticks", action="store_true",
                    help="run each cycle's 20 ticks as the fused window (use_fused_ticks)")
    ap.add_argument("--pos-mm", type=float, default=2.0)
    ap.add_argument("--ang-mrad", type=float, default=2.0)
    ap.add_argument("--vel-mms", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    ap.add_argument("--json", default="", help="write full report to this path")
    return ap


def perturbed_start(q: np.ndarray, dq: np.ndarray, rng, pos: float, ang: float, vel: float):
    """Perturb every scenario but the first: positions, attitude (a small
    rotation composed onto the quaternion, xyzw), joints, linear velocity."""
    B = q.shape[0]
    q, dq = q.copy(), dq.copy()
    q[1:, 0:3] += rng.uniform(-pos, pos, (B - 1, 3))
    half = 0.5 * rng.uniform(-ang, ang, (B - 1, 3))
    x1, y1, z1, w1 = np.concatenate([half, np.ones((B - 1, 1))], axis=1).T
    x2, y2, z2, w2 = q[1:, 3:7].T
    comp = np.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                     w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], axis=1)
    q[1:, 3:7] = comp / np.linalg.norm(comp, axis=1, keepdims=True)
    q[1:, 7:19] += rng.uniform(-ang, ang, (B - 1, 12))
    dq[1:, 0:3] += rng.uniform(-vel, vel, (B - 1, 3))
    return q, dq


def run(args) -> dict:
    """The ensemble of ``args`` (as :func:`parser` makes them); returns the report."""
    from convex_mpc_tpu_torch.control import gait as G
    from convex_mpc_tpu_torch.models import dynamics as D
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.sim import physics as P
    from convex_mpc_tpu_torch.utils.config import BRAKE_ACCEL_CANDIDATE, TUNED_CONFIG

    if args.xla:
        raise SystemExit("--xla: the port has no XLA twin; its engine follows the device "
                         "(--cpu runs every kernel's plain version)")
    dev = torch.device("cpu" if args.cpu else "cuda")
    B = args.batch
    rng = np.random.default_rng(args.seed)
    dyn = D.build_dyn(device=dev)
    contact = P.default_contact(kn=30000, dn=1000, device=dev)
    gait_b = E.broadcast_batch(G.make_gait_params(3.0, 0.6, device=dev), B)
    contact_b = E.broadcast_batch(contact, B)
    sched = E.reference_schedule(device=dev)
    if args.ramp:
        sched = E.ramp_schedule(sched)
    sched_b = E.broadcast_batch(sched, B)
    state = E.init_state(dyn, n=16)._replace(plant=P.init_plant(dyn, contact=contact))
    state_b = E.broadcast_batch(state, B)
    q, dq = perturbed_start(state_b.plant.q.cpu().numpy(), state_b.plant.dq.cpu().numpy(), rng,
                            args.pos_mm * 1e-3, args.ang_mrad * 1e-3, args.vel_mms * 1e-3)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    state_b = state_b._replace(plant=state_b.plant._replace(q=f32(q), dq=f32(dq)))

    kw = {}
    if args.tuned:
        kw["q_diag"] = TUNED_CONFIG.mpc.q_diag
    if args.brake:
        kw["brake_accel"] = BRAKE_ACCEL_CANDIDATE
    if args.brake_yaw > 0.0:
        kw["brake_alpha"] = args.brake_yaw
    if args.return_iterate:
        kw["return_polished"] = False
    if args.fused_ticks:
        kw["use_fused_ticks"] = True

    t0 = time.time()
    z_min = np.full(B, np.inf)
    z_max = np.full(B, -np.inf)
    rp_max = np.zeros(B)
    finite = np.ones(B, bool)
    first_bad = np.full(B, -1.0)  # sim second a scenario first left the gates
    last = None
    for sec in range(args.seconds):
        state_b, logs = E.simulate_batched(dyn, gait_b, contact_b, sched_b, state_b,
                                           n_cycles=50, solver_iters=args.iters, **kw)
        x = logs.ticks.x_vec.cpu().numpy()  # (50, B, 20, 12)
        x = np.moveaxis(x, 1, 0).reshape(B, -1, 12)
        finite &= np.isfinite(x).all(axis=(1, 2))
        x = np.nan_to_num(x)
        z_min = np.minimum(z_min, x[:, :, 2].min(1))
        z_max = np.maximum(z_max, x[:, :, 2].max(1))
        rp_max = np.maximum(rp_max, np.abs(x[:, :, 3:5]).max((1, 2)))
        last = x
        good = finite & (z_min > 0.12) & (z_max < 0.6) & (rp_max < 0.6)
        first_bad = np.where(~good & (first_bad < 0), float(sec + 1), first_bad)
        print(f"t={sec + 1:2d}s  upright {int(good.sum())}/{B}  "
              f"z[{z_min.min():.3f},{z_max.max():.3f}]  |rp|max={rp_max.max():.3f}", flush=True)

    stop_resid = np.abs(last[:, -500:, 6:8]).mean(axis=(1, 2))
    end_z = last[:, -1, 2]
    ok = finite & (z_min > 0.12) & (z_max < 0.6) & (rp_max < 0.6) & (end_z > 0.15) & (
        stop_resid < 0.1)
    k, n = int(ok.sum()), B
    return {
        "profile": "tuned" if args.tuned else "raw",
        "schedule": "ramped" if args.ramp else "raw-steps",
        "brake_accel": BRAKE_ACCEL_CANDIDATE if args.brake else 0.0,
        "brake_alpha": args.brake_yaw,
        "engine": ("plain versions on the CPU" if args.cpu else
                   f"CUDA kernels on {torch.cuda.get_device_name(dev)}"),
        "ticks": "fused window" if args.fused_ticks else "tick loop",
        "point": "iterate" if args.return_iterate else "polished",
        "batch": n,
        "pass": k,
        "pass_rate": round(k / n, 4),
        "cp95_lower": round(clopper_pearson_low(k, n), 4),
        "perturb": {"pos_mm": args.pos_mm, "ang_mrad": args.ang_mrad,
                    "vel_mms": args.vel_mms, "seed": args.seed},
        "iters": args.iters,
        "seconds": args.seconds,
        "fail_idx": np.nonzero(~ok)[0].tolist(),
        "fail_time_s": {int(i): first_bad[i] for i in np.nonzero(~ok)[0]},
        "stop_resid_p95": round(float(np.percentile(stop_resid, 95)), 4),
        "elapsed_s": round(time.time() - t0, 1),
    }


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    report = run(args)
    print(json.dumps(report))
    if args.json:
        Path(args.json).write_text(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
