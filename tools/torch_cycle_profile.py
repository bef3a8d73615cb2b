"""Where the time of the port's production cycle goes, on one CUDA card.

Runs ``mpc_cycle_batch`` (``engine_kwargs_batched(DEFAULT_CONFIG)``; with
``--fused``, ``use_fused_ticks=True``: the 20 ticks as one fused-window
kernel launch) from
bench.py's start state (``chip_smoke.start_batch``, the state the smoke run
times) at ``--batch`` scenarios, settles ``--settle``
cycles, then traces ``--cycles`` cycles with ``utils.profiling.trace``
(``torch.profiler``, CPU and CUDA activities; the Chrome trace goes to
``--trace-dir``) and prints: the card's name and power limit, the wall
time per cycle, the device-busy
share (the union of kernel and copy intervals over the traced wall time),
operator counts per cycle, and the top operators by host time and by
device time.

    python tools/torch_cycle_profile.py --batch 512 --cycles 2 [--fused]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from chip_smoke import card_identity, start_batch  # noqa: E402
from convex_mpc_tpu_torch.sim import engine as E  # noqa: E402
from convex_mpc_tpu_torch.utils import profiling  # noqa: E402
from convex_mpc_tpu_torch.utils.config import DEFAULT_CONFIG, engine_kwargs_batched  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--settle", type=int, default=8)
    ap.add_argument("--cycles", type=int, default=2)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--fused", action="store_true",
                    help="use_fused_ticks=True: the apply stage is the fused tick window")
    ap.add_argument("--trace-dir", default="build/cycle_profile",
                    help="where utils.profiling.trace writes trace.json (a B = 512 trace "
                         "exceeds 64 MiB)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    B = args.batch
    kw = dict(engine_kwargs_batched(DEFAULT_CONFIG), use_fused_ticks=args.fused)
    dyn, gait_b, contact_b, sched_b, state = start_batch(B, dev)
    for _ in range(args.settle):
        state, _ = E.mpc_cycle_batch(dyn, gait_b, contact_b, sched_b, state, **kw)
    torch.cuda.synchronize()

    with profiling.trace(args.trace_dir) as prof:
        t0 = time.perf_counter()
        for _ in range(args.cycles):
            state, log = E.mpc_cycle_batch(dyn, gait_b, contact_b, sched_b, state, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    dev_events = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = profiling.device_busy_ms(prof)
    n_cpu_ops = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CPU
                    and e.name.startswith("aten::"))
    print(f"{card_identity()}; B={B}; use_fused_ticks={args.fused}; {args.cycles} traced cycles")
    print(json.dumps({
        "cycle_ms": wall_ms / args.cycles,
        "device_busy_ms_per_cycle": busy / args.cycles,
        "device_busy_share": busy / wall_ms,
        "device_kernels_per_cycle": len(dev_events) / args.cycles,
        "aten_ops_per_cycle": n_cpu_ops / args.cycles,
        "solver_iters_mean": float(log.solver_iters.float().mean()),
    }))
    ka = prof.key_averages()
    print("-- top operators by self host time --")
    print(ka.table(sort_by="self_cpu_time_total", row_limit=args.top))
    print("-- top operators by device time --")
    print(ka.table(sort_by="self_cuda_time_total", row_limit=args.top))


if __name__ == "__main__":
    main()
