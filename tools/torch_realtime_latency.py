"""Single-scenario (B = 1) real-time latency of the PyTorch/CUDA port vs the MPC budget.

The port's counterpart of ``tools/realtime_latency.py``, with its output
keys. The question is latency, not throughput: can one full engine cycle
(reference regeneration + QP build + certified adaptive solve + 20 x 1 kHz
ticks) for ONE robot finish inside the reference's 48 Hz replan period
(20.833 ms)? The production configuration (``engine_kwargs_batched(
DEFAULT_CONFIG)``) from bench.py's start state (no x offset at B = 1);
windows of 16 cycles, one gait period, so every contact phase is sampled.

The port has no compiled multi-cycle program (the JAX tool's ``lax.scan``
window), so its two numbers are:

- ``cycle_ms_amortized_*``: per-cycle time of a 16-cycle host loop with the
  device synchronized only at the loop's ends (best window, median, mean
  of ``--windows`` windows);
- ``cycle_ms_dispatch_*``: per-cycle time with every cycle synchronized on
  its own (mean and p99 of 32 cycles), the latency one robot's controller
  sees.

Then the batch sweep: each B of ``--batches`` timed both ways (amortized
windows and synchronized-per-window dispatch), the better per-cycle time
kept; ``max_realtime_batch`` is the largest B whose batch cycle fits the
budget.

Runs on the CUDA card; ``--cpu`` runs every kernel's plain version on the
CPU (for tests; its times are CPU times). ``--fused-ticks`` runs each
cycle's 20 ticks as the fused window (``use_fused_ticks``). Writes
``--out`` (default ``artifacts/realtime_latency_torch.json``) and prints one
JSON line:

    python3 tools/torch_realtime_latency.py [--budget-ms 20.833] [--fused-ticks]
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

CYCLES = 16  # one full gait period


def setup(B: int, dev, fused: bool):
    """``one(state) -> (state, solver_iters)``, one production cycle of a
    B-scenario batch, and its start state."""
    from chip_smoke import start_batch
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.utils.config import DEFAULT_CONFIG, engine_kwargs_batched

    kw = dict(engine_kwargs_batched(DEFAULT_CONFIG), use_fused_ticks=fused)
    dyn, gait_b, contact_b, sched_b, sb = start_batch(B, dev, x_spread=0.02 if B > 1 else 0.0)

    def one(s):
        s2, log = E.mpc_cycle_batch(dyn, gait_b, contact_b, sched_b, s, **kw)
        return s2, log.solver_iters

    return one, sb


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def best_amortized(one, sb, dev, windows: int, cycles: int):
    """Settle one window and one cycle, then ``windows`` windows of
    ``cycles`` cycles synchronized at their ends. Returns (state, ms per
    cycle of each window, the timed cycles' iterations)."""
    for _ in range(cycles + 1):
        sb, _ = one(sb)
    _sync(dev)
    per_window, iters = [], []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(cycles):
            sb, it = one(sb)
            iters.append(it)
        _sync(dev)
        per_window.append((time.perf_counter() - t0) / cycles * 1e3)
    return sb, per_window, torch.cat(iters).float().cpu().numpy()


def best_dispatch(one, sb, dev, cycles: int, windows: int = 3):
    """Best per-cycle ms over ``windows`` windows of ``cycles`` cycles, each
    cycle synchronized on its own."""
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(cycles):
            sb, _ = one(sb)
            _sync(dev)
        best = min(best, (time.perf_counter() - t0) / cycles * 1e3)
    return sb, best


def b1_headline(dev, budget_ms: float, windows: int, cycles: int = CYCLES,
                fused: bool = False) -> dict:
    """The B = 1 cycle: amortized windows, then 2 x ``cycles`` cycles each
    synchronized on its own."""
    one, sb = setup(1, dev, fused)
    sb, per_window, iters = best_amortized(one, sb, dev, windows, cycles)
    per_window = np.asarray(per_window)
    lat = []
    for _ in range(2 * cycles):
        t0 = time.perf_counter()
        sb, _ = one(sb)
        _sync(dev)
        lat.append((time.perf_counter() - t0) * 1e3)
    z = float(sb.plant.q[0, 2])
    best1 = float(np.min(per_window))
    return {
        "cycle_ms_amortized_best_window": best1,
        "cycle_ms_amortized_median": float(np.median(per_window)),
        # the JAX tool's key; here the plain mean of the windows
        "cycle_ms_amortized_mean_tunnel_noise": float(np.mean(per_window)),
        "cycle_ms_dispatch_mean": float(np.mean(lat)),
        "cycle_ms_dispatch_p99": float(np.percentile(lat, 99)),
        "iters_mean": float(iters.mean()),
        "iters_p99": float(np.percentile(iters, 99)),
        "healthy": bool(np.isfinite(z) and 0.15 < z < 0.45),
        "meets_budget_best_window": bool(best1 < budget_ms),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--budget-ms", type=float, default=20.833,
                    help="real-time budget (reference MPC_DT, test_MPC.py:67)")
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--cycles", type=int, default=CYCLES,
                    help="cycles per window (16: one gait period)")
    ap.add_argument("--batches", type=int, nargs="*", default=[1, 64, 128, 256, 512])
    ap.add_argument("--fused-ticks", action="store_true",
                    help="run each cycle's 20 ticks as the fused window (use_fused_ticks)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    ap.add_argument("--out", default="artifacts/realtime_latency_torch.json")
    args = ap.parse_args(argv)
    from chip_smoke import card_identity

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("torch_realtime_latency: no CUDA device (pass --cpu for the plain "
                         "CPU path)")
    dev = torch.device("cpu" if args.cpu else "cuda")
    cyc = args.cycles
    out = {"budget_ms": args.budget_ms, "backend": dev.type,
           "device": "cpu" if args.cpu else card_identity(),
           "fused_ticks": args.fused_ticks, "window_cycles": cyc}
    out["b1"] = b1_headline(dev, args.budget_ms, args.windows, cyc, args.fused_ticks)

    sweep, best_b = {}, 0
    for B in args.batches:
        if B == 1:
            ms = out["b1"]["cycle_ms_amortized_best_window"]
        else:
            one, sb = setup(B, dev, args.fused_ticks)
            sb, pw, _ = best_amortized(one, sb, dev, max(4, args.windows - 2), cyc)
            sb, disp = best_dispatch(one, sb, dev, cyc)
            ms = min(float(np.min(pw)), disp)
        sweep[str(B)] = ms
        if ms < args.budget_ms:
            best_b = max(best_b, B)
    out["batch_cycle_ms_best_window"] = sweep
    out["max_realtime_batch"] = best_b
    out["realtime_robots_per_chip_guaranteed"] = best_b

    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
