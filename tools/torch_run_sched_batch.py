"""The full reference schedule on the port's batched adaptive path, with per-second lines.

The port's counterpart of ``tools/run_sched_batch.py``, with its options,
defaults and printed lines: the 10 s reference command schedule
(``engine.reference_schedule``) at B = 1 through ``simulate_batched``
(``mpc_cycle_batch``: ``spd_inverse.cu`` and ``admm_structured.cu``),
trot 3 Hz duty 0.6, contact kn 30,000 / dn 1,000, ``--iters`` the solver's
cap. Used to adjudicate marginal schedule outcomes against solver-cap
chaos. Each second (50 cycles) prints z's range, max |roll|, |pitch| and
the final velocities; ``--fine`` adds 0.1 s lines from t = 8 s; the last
line is the stop residual and finiteness.

Weights: the tuned profile (``TUNED_CONFIG.mpc.q_diag``, the default and
``--tuned``) or the raw reference weights (``--raw``).

Runs on the CUDA card; ``--cpu`` runs every kernel's plain version on the
CPU (its times are CPU times):

    python3 tools/torch_run_sched_batch.py [--iters 800] [--tuned | --raw] [--fine]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CYCLES_PER_SECOND = 50  # 48 Hz replans of 20 1 kHz ticks, as the JAX tool counts a second


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=800)
    weights = ap.add_mutually_exclusive_group()
    weights.add_argument("--raw", action="store_true",
                         help="raw reference weights instead of the tuned profile")
    weights.add_argument("--tuned", action="store_true",
                         help="the tuned profile (the default; named in the JAX tool's usage)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    ap.add_argument("--fine", action="store_true")
    ap.add_argument("--seconds", type=int, default=10)
    args = ap.parse_args(argv)

    from chip_smoke import print_launches, tool_device
    from convex_mpc_tpu_torch.control import gait as G
    from convex_mpc_tpu_torch.models import dynamics as D
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.sim import physics as P
    from convex_mpc_tpu_torch.utils.config import TUNED_CONFIG

    dev = tool_device("torch_run_sched_batch", args.cpu)
    dyn = D.build_dyn(device=dev)
    gait_b = E.broadcast_batch(G.make_gait_params(3.0, 0.6, device=dev), 1)
    contact = P.default_contact(kn=30000, dn=1000, device=dev)
    contact_b = E.broadcast_batch(contact, 1)
    sched_b = E.broadcast_batch(E.reference_schedule(device=dev), 1)
    state = E.init_state(dyn, n=16)._replace(plant=P.init_plant(dyn, contact=contact))
    state_b = E.broadcast_batch(state, 1)
    kw = {} if args.raw else {"q_diag": TUNED_CONFIG.mpc.q_diag}

    xs = []
    for sec in range(args.seconds):
        state_b, logs = E.simulate_batched(dyn, gait_b, contact_b, sched_b, state_b,
                                           n_cycles=CYCLES_PER_SECOND, solver_iters=args.iters,
                                           **kw)
        x = logs.ticks.x_vec.reshape(-1, 12).double().cpu().numpy()
        xs.append(x)
        print(f"t={sec + 1:2d}s  z[{x[:, 2].min():.3f},{x[:, 2].max():.3f}]"
              f"  |rp|max={np.abs(x[:, 3:5]).max():.3f}"
              f"  vx_end={x[-1, 6]:+.3f}  vy_end={x[-1, 7]:+.3f}", flush=True)
        if args.fine and sec >= 8:
            f = logs.ticks.force.reshape(-1, 4, 3).double().cpu().numpy()
            for k in range(0, 1000, 100):
                seg, ff = x[k:k + 100], f[k:k + 100]
                print(f"   t={sec + k / 1000.0:5.2f}"
                      f"  vx={seg[:, 6].mean():+.3f} vy={seg[:, 7].mean():+.3f}"
                      f"  wz={seg[:, 11].mean():+.3f} yaw={seg[-1, 5]:+.2f}"
                      f"  z={seg[:, 2].mean():.3f}"
                      f"  fx={ff[..., 0].sum(-1).mean():+.1f}"
                      f"  fz={ff[..., 2].sum(-1).mean():+.1f}", flush=True)
    x = np.concatenate(xs)
    out = dict(z=float(x[-1, 2]), stop_resid=float(np.abs(x[-500:, 6:8]).mean()),
               rp_max=float(np.abs(x[:, 3:5]).max()), finite=bool(np.isfinite(x).all()))
    print(f"final: z={out['z']:.3f}  stop_resid={out['stop_resid']:.4f}"
          f"  |rp|max={out['rp_max']:.3f}  finite={out['finite']}")
    out["launches"] = print_launches()
    return out


if __name__ == "__main__":
    main()
