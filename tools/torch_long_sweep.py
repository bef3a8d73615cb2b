"""Checkpointed, resumable long scenario sweep on the port.

The port's counterpart of ``tools/long_sweep.py``, with its options,
defaults, metrics JSONL keys and meta file keys. Runs a randomized-command
scenario batch (``scenarios.velocity_sweep``) for many seconds of sim time,
checkpointing the full batch state (``utils.checkpoint``, the JAX package's
``keystr`` keys) after every chunk so a long sweep survives preemption:
re-running the same command line picks up from the last completed chunk.
Per-chunk upright/tracking metrics are appended to a JSONL next to the
checkpoint.

The default is the legacy fixed-segment cycle (``--solver-iters``
iterations; the dense ADMM kernel ``admm_dense.cu``); ``--adaptive`` runs
the production cycle (``spd_inverse.cu`` and ``admm_structured.cu``).
Runs on the CUDA card; ``--cpu`` runs every kernel's plain version on the
CPU (its times are CPU times). Prints the card's name and power limit, a
line per chunk and the ``launches:`` line (this run's launches):

    python3 tools/torch_long_sweep.py --batch 1024 --seconds 30 --out artifacts/sweep_torch
    # interrupted? re-run the same command; it resumes from the checkpoint
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--chunk-cycles", type=int, default=50, help="cycles per chunk (1 s)")
    ap.add_argument("--solver-iters", type=int, default=400)
    ap.add_argument("--adaptive", action="store_true",
                    help="batch-global adaptive solver (production config; "
                    "--solver-iters becomes the escalation cap)")
    ap.add_argument("--out", default="artifacts/sweep_torch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)

    from chip_smoke import print_launches, sync, tool_device
    from convex_mpc_tpu_torch.models import dynamics as D
    from convex_mpc_tpu_torch.sim import scenarios as S
    from convex_mpc_tpu_torch.utils import checkpoint as C

    dev = tool_device("torch_long_sweep", args.cpu)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    ckpt = out.with_suffix(".npz")
    meta_path = out.with_suffix(".meta.json")
    jsonl = out.with_suffix(".metrics.jsonl")

    dyn = D.build_dyn(device=dev)
    batch = S.velocity_sweep(dyn, args.batch, seed=args.seed)
    total_chunks = int(round(args.seconds * 50)) // args.chunk_cycles

    start_chunk = 0
    if ckpt.exists() and meta_path.exists():
        meta = json.loads(meta_path.read_text())
        if meta.get("batch") == args.batch and meta.get("seed") == args.seed:
            batch = C.load_pytree(ckpt, batch)
            start_chunk = meta["chunks_done"]
            print(f"[long-sweep] resuming at chunk {start_chunk}/{total_chunks}")
        else:
            print("[long-sweep] checkpoint config mismatch; starting fresh")

    t_start = time.perf_counter()
    for chunk in range(start_chunk, total_chunks):
        t0 = time.perf_counter()
        batch, metrics, _ = S.simulate_batch(dyn, batch, n_cycles=args.chunk_cycles,
                                             solver_iters=args.solver_iters,
                                             adaptive=args.adaptive)
        sync(dev)
        dt = time.perf_counter() - t0
        rec = dict(
            chunk=chunk + 1,
            sim_s=(chunk + 1) * args.chunk_cycles / 50.0,
            upright_frac=float(metrics["upright"].double().mean()),
            height_mean=float(metrics["height"].double().mean()),
            vx_err_mean=float(metrics["vx_err"].double().mean()),
            wall_s=dt,
            solves_per_s=args.batch * args.chunk_cycles / dt,
        )
        with jsonl.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        C.save_pytree(ckpt, batch)
        meta_path.write_text(json.dumps(dict(
            batch=args.batch, seed=args.seed, chunks_done=chunk + 1,
            chunk_cycles=args.chunk_cycles, solver_iters=args.solver_iters,
            adaptive=args.adaptive,
        )))
        print(f"[long-sweep] {json.dumps(rec)}", flush=True)
    wall = time.perf_counter() - t_start
    print(f"[long-sweep] done: {total_chunks * args.chunk_cycles} cycles x "
          f"{args.batch} scenarios in {wall:.0f}s (this run)")
    return dict(start_chunk=start_chunk, total_chunks=total_chunks, wall_s=wall,
                launches=print_launches())


if __name__ == "__main__":
    main()
