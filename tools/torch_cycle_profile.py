"""Where the device time of the port's production cycle goes, on one CUDA card.

The port's counterpart of ``tools/solve_profile.py`` (its ``--what`` modes
and inputs), and the cycle profile. From bench.py's start state
(``chip_smoke.start_batch``) at ``--batch`` scenarios, settled ``--settle``
cycles of ``mpc_cycle_batch`` (``engine_kwargs_batched(DEFAULT_CONFIG)``;
with ``--fused``, ``use_fused_ticks=True``: the 20 ticks as one
fused-window kernel launch), it traces ``--cycles`` reps of one of:

- ``cycle`` (the default): the whole cycle;
- ``solve``: ``admm.solve_adaptive`` (cap 600) on the settled state's QP
  (``engine.cycle_update``, reference weights), its q moved by 1e-6 x rep;
- ``ticks``: the 20 eager 1 kHz ticks (``engine._run_ticks``) from the
  settled state, the applied forces moved by 1e-6 x rep;

with ``utils.profiling.trace`` (``torch.profiler``, CPU and CUDA
activities; the Chrome trace goes to ``--trace-dir``) and prints: the
card's name and power limit, the JAX tool's line (the device ops' time
summed over the reps), the wall time per rep, the device-busy share
(the union of kernel and copy intervals over the traced wall time), device
kernels and operator counts per rep, the top operators by host time and by
device time, and the ``launches:`` line. ``--cycles`` defaults to 2 for
``cycle`` and to the JAX tool's 3 reps for ``solve`` and ``ticks``.

    python3 tools/torch_cycle_profile.py [--what cycle|solve|ticks] [--batch 512] [--fused]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from chip_smoke import card_identity, launches, print_launches, start_batch  # noqa: E402
from convex_mpc_tpu_torch.mpc import admm  # noqa: E402
from convex_mpc_tpu_torch.sim import engine as E  # noqa: E402
from convex_mpc_tpu_torch.utils import profiling  # noqa: E402
from convex_mpc_tpu_torch.utils.config import DEFAULT_CONFIG, engine_kwargs_batched  # noqa: E402

QD = (1, 1, 50, 10, 20, 1, 2, 2, 1, 1, 1, 1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--what", default="cycle", choices=["cycle", "solve", "ticks"])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--settle", type=int, default=8)
    ap.add_argument("--cycles", type=int, default=None,
                    help="traced reps (default 2 for cycle, 3 for solve and ticks)")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--fused", action="store_true",
                    help="use_fused_ticks=True: the apply stage is the fused tick window")
    ap.add_argument("--trace-dir", default="build/cycle_profile",
                    help="where utils.profiling.trace writes trace.json (a B = 512 trace "
                         "exceeds 64 MiB)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_cycle_profile: no CUDA device (the profile is of the card)")
    reps = args.cycles or (2 if args.what == "cycle" else 3)
    dev = torch.device("cuda")
    B = args.batch
    kw = dict(engine_kwargs_batched(DEFAULT_CONFIG), use_fused_ticks=args.fused)
    dyn, gait_b, contact_b, sched_b, state = start_batch(B, dev)
    for _ in range(args.settle):
        state, _ = E.mpc_cycle_batch(dyn, gait_b, contact_b, sched_b, state, **kw)
    torch.cuda.synchronize()
    before = launches()

    qd = torch.as_tensor(QD, dtype=torch.float32, device=dev)
    iters = []
    if args.what == "cycle":
        def run(i):
            nonlocal state
            state, log = E.mpc_cycle_batch(dyn, gait_b, contact_b, sched_b, state, **kw)
            iters.append(log.solver_iters)
    elif args.what == "solve":
        data_b = E.cycle_update(dyn, gait_b, sched_b, state, qd, 16, (1 / 3.0) / 16, 1e-5, 0.8,
                                10.0)[0]

        def run(i):
            sol = admm.solve_adaptive(data_b._replace(q=data_b.q + 1e-6 * i), state.solver,
                                      max_iter=600, box_tail=192)
            iters.append(sol.iters)
    else:
        _, traj_b, _, cmd_b, yc_b, yp_b = E.cycle_update(dyn, gait_b, sched_b, state, qd, 16,
                                                         (1 / 3.0) / 16, 1e-5, 0.8, 10.0)

        def run(i):
            E._run_ticks(dyn, gait_b, contact_b, cmd_b, traj_b, state.u0 + 1e-6 * i,
                         state.plant, state.leg, yc_b, yp_b, state.vel_filt, state.t, 20, 45.0,
                         1e-3, 30.0)

    run(0)  # the first use outside the trace
    torch.cuda.synchronize()
    iters.clear()
    with profiling.trace(args.trace_dir) as prof:
        t0 = time.perf_counter()
        for i in range(1, reps + 1):
            run(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    dev_events = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = profiling.device_busy_ms(prof)
    summed = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    n_cpu_ops = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CPU
                    and e.name.startswith("aten::"))
    print(f"{card_identity()}; B={B}; what={args.what}; use_fused_ticks={args.fused}; "
          f"{reps} traced reps")
    out = {
        "what": args.what,
        "ms_per_rep": wall_ms / reps,
        "device_op_ms_per_rep": summed / reps,
        "device_busy_ms_per_rep": busy / reps,
        "device_busy_share": busy / wall_ms,
        "device_kernels_per_rep": len(dev_events) / reps,
        "aten_ops_per_rep": n_cpu_ops / reps,
        "solver_iters_mean": float(torch.cat(iters).float().mean()) if iters else None,
    }
    print(f"total device op time over {reps} reps: {summed:.2f} ms ({summed / reps:.2f} ms/rep)")
    print(json.dumps(out))
    ka = prof.key_averages()
    print("-- top operators by self host time --")
    print(ka.table(sort_by="self_cpu_time_total", row_limit=args.top))
    print("-- top operators by device time --")
    print(ka.table(sort_by="self_cuda_time_total", row_limit=args.top))
    out["launches"] = print_launches(before)
    return out


if __name__ == "__main__":
    main()
