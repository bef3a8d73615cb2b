"""Benchmark of the PyTorch/CUDA port: batched closed-loop MPC throughput on one card.

The port's counterpart of ``bench.py``, with its start state, windows and
JSON keys. Full engine cycles (reference regeneration + QP assembly + QP
solve + 20 x 1 kHz leg-control/physics ticks) of a scenario batch, reported
as MPC solves/s on the card; one cycle = one 16-step-horizon QP + 20
rollout ticks per scenario.

- Start state: trot 3 Hz duty 0.6, contact kn 30,000 / dn 1,000, constant
  0.5 m/s, x offsets across +-2 cm (``chip_smoke.start_batch``);
  ``BENCH_BATCH`` scenarios (default 512).
- Headline: the production configuration, ``engine_kwargs_batched(
  DEFAULT_CONFIG)`` (the batch-global adaptive solver with certified
  polish, cap 1000) with the eager tick loop. A window is 16 consecutive
  cycles, one gait period, so every contact phase is sampled; 16 settle
  cycles, then the best of 3 windows, the device synchronized at each
  window's ends.
- The legacy fixed-iteration cycle (``mpc_cycle_fixed``) at 150 and 400
  iterations, timed the same way, as the iterations -> throughput curve.
- Health: the adaptive batch is finite with 0.1 < z < 0.6 after the windows.

``realtime_robots_per_chip_throughput`` divides the throughput by an assumed
48 solves/s per robot (``assumes_48hz_reference``), as bench.py does.
``device`` holds the card's name and power limit (``nvidia-smi``);
``launches_per_cycle`` each CUDA kernel's launches per timed cycle.

Prints exactly one JSON line. Runs on the CUDA card; ``--cpu`` runs every
kernel's plain version on the CPU (for tests; its times are CPU times):

    python3 tools/torch_bench.py
    python3 tools/torch_bench.py --cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CYCLES_PER_WINDOW = 16  # one full gait period: all contact phases sampled
WINDOWS = 3
FIXED_ITERS = (150, 400)


def best_window(step, s, dev, cycles: int, windows: int):
    """``cycles`` settle cycles, then ``windows`` timed windows of ``cycles``.

    Returns (best window seconds, state, per-cycle aux outputs of the timed
    windows, kernel launches per timed cycle)."""
    from chip_smoke import _all_kernels

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for _ in range(cycles):
        s, aux = step(s)
    sync()
    kernels = _all_kernels()
    for k in kernels.values():
        k.launches = 0
    best, aux_log = float("inf"), []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(cycles):
            s, aux = step(s)
            aux_log.append(aux)
        sync()
        best = min(best, time.perf_counter() - t0)
    launches = {n: k.launches / (windows * cycles) for n, k in kernels.items()}
    return best, s, aux_log, launches


def main(cpu: bool = False, batch: int | None = None,
         cycles_per_window: int = CYCLES_PER_WINDOW, windows: int = WINDOWS) -> dict:
    """Run the benchmark, print its JSON line and return it as a dict."""
    from chip_smoke import card_identity, start_batch
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.utils.config import DEFAULT_CONFIG, engine_kwargs_batched

    dev = torch.device("cpu" if cpu else "cuda")
    if not cpu and not torch.cuda.is_available():
        raise SystemExit("torch_bench: no CUDA device (pass --cpu for the plain CPU path)")
    B = batch if batch is not None else int(os.environ.get("BENCH_BATCH", "512"))
    cpw = cycles_per_window
    kw = engine_kwargs_batched(DEFAULT_CONFIG)
    dyn, gait_b, contact_b, sched_b, state_b = start_batch(B, dev)
    args = (dyn, gait_b, contact_b, sched_b)

    def adaptive_step(s):
        s2, log = E.mpc_cycle_batch(*args, s, **kw)
        return s2, log.solver_iters

    t_ada, state_ada, iters_log, launches = best_window(adaptive_step, state_b, dev, cpw, windows)
    solves_ada = B * cpw / t_ada
    it = torch.cat(iters_log).float().cpu().numpy()
    launches = {"adaptive": launches}

    curve = {}
    for iters in FIXED_ITERS:
        def fixed_step(s, iters=iters):
            return E.mpc_cycle_fixed(*args, s, n=16, solver_iters=iters)[0], None

        t_fix, _, _, launches[f"fixed{iters}"] = best_window(fixed_step, state_b, dev, cpw,
                                                              windows)
        curve[f"fixed{iters}_solves_per_s"] = B * cpw / t_fix

    z = state_ada.plant.q[:, 2]
    ok = bool(torch.isfinite(z).all() and ((z > 0.1) & (z < 0.6)).all())
    solver = ("adaptive+certified-polish, structured QP, "
              + ("plain PyTorch versions on the CPU" if cpu else
                 "CUDA kernels spd_inverse.cu + admm_structured.cu "
                 "(fixed curve: admm_dense.cu)"))
    period = " (one full gait period)" if cpw == CYCLES_PER_WINDOW else ""
    out = {
        "metric": "mpc_solves_per_s_per_chip",
        "value": solves_ada,
        "unit": "solves/s/chip (each = 16-step QP + 20 x 1kHz rollout ticks)",
        "vs_baseline": solves_ada / 48.0,
        "vs_baseline_is_assumed": True,
        "realtime_robots_per_chip_throughput": solves_ada / 48.0,
        "assumes_48hz_reference": True,
        "batch": B,
        "solver": solver,
        "solver_max_iter": DEFAULT_CONFIG.solver.max_iter,
        "window": f"{cpw}-cycle window{period}, best of {windows}",
        "iters_mean": float(it.mean()),
        "iters_p99": float(np.percentile(it, 99)),
        "healthy": ok,
        **curve,
        "device": "cpu" if cpu else card_identity(),
        "launches_per_cycle": launches,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    main(cpu=ap.parse_args().cpu)
