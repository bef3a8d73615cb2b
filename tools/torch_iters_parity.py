"""Closed-loop cycles of the JAX package and the PyTorch port side by side (CPU).

Runs ``mpc_cycle_batch`` with ``engine_kwargs_batched(DEFAULT_CONFIG)`` in
both packages from bench.py's start state (trot 3 Hz duty 0.6, vx = 0.5,
x offsets over +-2 cm) and prints, per cycle, each package's solver
iterations and the largest difference of the applied forces and body
heights; the last line is a JSON summary. Both run on the CPU, the port
with its plain versions of the CUDA kernels.

    python tools/torch_iters_parity.py --batch 4 --cycles 32
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from convex_mpc_tpu.control import gait as JG  # noqa: E402
from convex_mpc_tpu.models import dynamics as JD  # noqa: E402
from convex_mpc_tpu.sim import engine as JE  # noqa: E402
from convex_mpc_tpu.sim import physics as JP  # noqa: E402
from convex_mpc_tpu.utils.config import DEFAULT_CONFIG, engine_kwargs_batched  # noqa: E402
from convex_mpc_tpu_torch.sim import engine as TE  # noqa: E402
from convex_mpc_tpu_torch.utils import interop  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cycles", type=int, default=32)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    B = args.batch

    dyn = JD.build_dyn()
    contact = JP.default_contact(kn=30000, dn=1000)
    gb = JE.broadcast_batch(JG.make_gait_params(3.0, 0.6), B)
    cb = JE.broadcast_batch(contact, B)
    scb = JE.broadcast_batch(JE.constant_schedule(vx=0.5), B)
    st = JE.init_state(dyn, n=16)._replace(plant=JP.init_plant(dyn, contact=contact))
    sb = JE.broadcast_batch(st, B)
    sb = sb._replace(plant=sb.plant._replace(
        q=sb.plant.q.at[:, 0].add(jnp.linspace(-0.02, 0.02, B))))
    kw = engine_kwargs_batched(DEFAULT_CONFIG)

    to_port = lambda tree: interop.from_numpy(jax.tree.map(np.asarray, tree), "cpu")
    tdyn, tg, tc, tsc = (to_port(x) for x in (dyn, gb, cb, scb))
    ts = to_port(sb)
    step = jax.jit(lambda s: JE.mpc_cycle_batch(dyn, gb, cb, scb, s, **kw))
    js = sb
    it_j, it_t, du0, dz = [], [], [], []
    for c in range(args.cycles):
        js, jl = step(js)
        ts, tl = TE.mpc_cycle_batch(tdyn, tg, tc, tsc, ts, **kw)
        it_j.append(np.asarray(jl.solver_iters))
        it_t.append(tl.solver_iters.numpy())
        du0.append(float(np.abs(np.asarray(js.u0) - ts.u0.numpy()).max()))
        dz.append(float(np.abs(np.asarray(js.plant.q[:, 2]) - ts.plant.q[:, 2].numpy()).max()))
        print(f"cycle {c}: iters jax {it_j[-1].tolist()} port {it_t[-1].tolist()} "
              f"max|du0| {du0[-1]:.4f} N max|dz| {dz[-1]:.2e} m", flush=True)
    ij, itt = np.concatenate(it_j), np.concatenate(it_t)
    print(json.dumps({
        "batch": B, "cycles": args.cycles, "device": "cpu",
        "iters_mean_jax": float(ij.mean()), "iters_mean_port": float(itt.mean()),
        "iters_p99_jax": float(np.percentile(ij, 99)),
        "iters_p99_port": float(np.percentile(itt, 99)),
        "capped_share_jax": float((ij >= kw["solver_iters"]).mean()),
        "capped_share_port": float((itt >= kw["solver_iters"]).mean()),
        "max_du0_N": max(du0), "max_dz_m": max(dz),
    }))


if __name__ == "__main__":
    main()
