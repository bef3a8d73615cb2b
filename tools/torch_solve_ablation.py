"""Cost decomposition of the port's batched legacy ADMM solve under controlled ablations.

The port's counterpart of ``tools/solve_ablation.py``, with its options,
defaults and printed lines. It times the legacy fixed-segment solve
(``admm.solve_batch``; its iterations in the dense ADMM kernel
``admm_dense.cu`` at A (448, 192)) on the real engine QP:

  - segments 1 / 2 / 4 at fixed iterations -> per-refactorization (setup) cost
  - iterations 152 and 400 at fixed segments -> per-iteration cost
  - the fewest iterations per segment (4) -> the setup alone

The QP batch is the condensed QP (``condensed.build_condensed``, reference
weights) of a mid-trot state (10 ``mpc_cycle_fixed`` cycles of one robot,
trot 3 Hz duty 0.6 at 0.5 m/s) with its x velocity offset across +-0.02
m/s over the batch, so the structure is production's. The segment count
is the module constant ``admm.SEGMENTS`` (the JAX ``solve``'s
``segments`` argument): the tool sets it for each row and restores it.
Each row is the best of ``--reps`` calls after one untimed call, on the
host clock with the device synchronized after each call, as the JAX tool.

Runs on the CUDA card; ``--cpu`` runs every kernel's plain version on the
CPU (its times are CPU times). Prints the rows, the derived costs, all of
them again as one JSON line in ms, and the ``launches:`` line:

    python3 tools/torch_solve_ablation.py [--batch 512] [--reps 3]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


@contextlib.contextmanager
def segments(n: int):
    """``admm.SEGMENTS`` set to ``n`` inside the block, restored after."""
    from convex_mpc_tpu_torch.mpc import admm

    old = admm.SEGMENTS
    admm.SEGMENTS = n
    try:
        yield
    finally:
        admm.SEGMENTS = old


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)
    B = args.batch

    from chip_smoke import print_launches, sync, tool_device
    from convex_mpc_tpu_torch.control import gait as G
    from convex_mpc_tpu_torch.control import reference as R
    from convex_mpc_tpu_torch.models import dynamics as D
    from convex_mpc_tpu_torch.mpc import admm, condensed
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.sim import physics as P
    from convex_mpc_tpu_torch.utils.interop import tree_map

    dev = tool_device("torch_solve_ablation", args.cpu)

    def timed(fn, *a):
        fn(*a)
        sync(dev)
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn(*a)
            sync(dev)
            best = min(best, time.perf_counter() - t0)
        return best

    dyn = D.build_dyn(device=dev)
    b1 = lambda tree: E.broadcast_batch(tree, 1)  # noqa: E731
    gait = b1(G.make_gait_params(3.0, 0.6, device=dev))
    sched = b1(E.constant_schedule(vx=0.5, device=dev))
    contact = b1(P.default_contact(device=dev))
    n = 16

    # a few real cycles to reach a mid-trot state, then capture the QP
    state = b1(E.init_state(dyn, n=n)._replace(plant=P.init_plant(dyn)))
    for _ in range(10):
        state, _ = E.mpc_cycle_fixed(dyn, gait, contact, sched, state)

    cmd = E.lookup_command(sched, state.t)
    obs, _, _ = E.observe(dyn, state.plant, state.yaw_cont, state.yaw_prev, state.vel_filt)
    traj, _ = R.generate(state.refgen, gait, obs, cmd, state.t, (1 / 3.0) / 16, n)
    traj = tree_map(lambda x: x.expand((B,) + tuple(x.shape[1:])).contiguous(), traj)
    p0 = traj.x0[:, 0:3]
    qd = torch.as_tensor([1, 1, 50, 10, 20, 1, 2, 2, 1, 1, 1, 1], dtype=torch.float32,
                         device=dev)
    dxs = torch.linspace(-0.02, 0.02, B, device=dev)

    def build_b(dxs):
        x0 = traj.x0.clone()
        x0[:, 0:3] = 0.0
        x0[:, 6] += dxs
        return condensed.build_condensed(traj.dyn, x0, traj.x_ref - torch.nn.functional.pad(
            p0, (0, 9))[:, None, :], traj.contact, qd, 1e-5, 0.8, 10.0)[0]

    data_b = build_b(dxs)
    warm_b = admm.init_state(data_b)

    results = {"build_condensed": timed(build_b, dxs)}

    def solve(iters):
        return admm.solve_batch(data_b, warm_b, max_iter=iters, scaled_termination=True,
                                box_tail=n * 12)

    for segs in (1, 2, 4):
        for iters in (segs * 4, 152, 400):
            it = max(iters, segs * 4)
            it = (it // segs) * segs
            key = f"solve segs={segs} iters={it}"
            try:
                with segments(segs):
                    results[key] = timed(solve, it)
            except Exception as exc:  # noqa: BLE001 - a failing row is reported, as the JAX tool
                results[key] = float("nan")
                print(f"{key} failed: {exc}")

    print(f"\nB={B} n=192 ({dev.type}), best of {args.reps}:")
    for k, v in results.items():
        print(f"  {k:28s} {v * 1e3:9.1f} ms")

    # derived decomposition
    s1_0 = results.get("solve segs=1 iters=4")
    s4_0 = results.get("solve segs=4 iters=16")
    s4_152 = results.get("solve segs=4 iters=152")
    s4_400 = results.get("solve segs=4 iters=400")
    if all(v is not None for v in (s1_0, s4_0, s4_152, s4_400)):
        per_seg = (s4_0 - s1_0) / 3
        per_iter = (s4_400 - s4_152) / 248
        results["per_refactorization"] = per_seg
        results["per_iteration"] = per_iter
        print(f"\n  per-refactorization (setup): {per_seg * 1e3:8.1f} ms")
        print(f"  per-iteration:               {per_iter * 1e3:8.3f} ms")
        print(f"  setup share @ segs=4 iters=152: {3 * per_seg / s4_152 * 100:.0f}%+")
    print(json.dumps({k: v * 1e3 for k, v in results.items()}))  # ms, unrounded
    results["launches"] = print_launches()
    return results


if __name__ == "__main__":
    main()
