"""Force-parity sweep of the PyTorch/CUDA port: its solver vs the native f64 oracle.

The port's counterpart of ``tools/parity_sweep.py``, with its instances, its
settings, its report and its exit code. It certifies the BASELINE metric,
"contact-force trajectories within 2% of the CasADi/OSQP reference", by
solving randomized trot QP instances (``tests/qp_oracle.trot_scenario``, rng
seed 0) with both the port's condensed ADMM (``admm.solve`` at the engine's
settings: ``scaled_termination``, eps 1e-4, ``box_tail=192``, rho 0.1; on
the card that is ``csrc/admm_dense.cu`` at A (448, 192)) and the independent
C++ float64 oracle (``native/qp_solver.cpp``, 8,000 iterations, 60,000 when
its KKT residual stays above 1e-6; the solves are independent, so they
run in a pool of worker processes), and reports the error distribution of
the applied (first-step) forces. Exits 1 if any instance is over the 2%
budget (more than ``--max-over`` of them, when given). The last line is
the kernels' launch counts.

Runs on the CUDA card unless ``--cpu`` is given (the plain versions):

    python3 tools/torch_parity_sweep.py [--n 50] [--iters 150]
    python3 tools/torch_parity_sweep.py --cpu --n 3
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

Q_DIAG = np.array([1, 1, 50, 10, 20, 1, 2, 2, 1, 1, 1, 1], float)
BUDGET = 2.0


def instances(n: int):
    """The sweep's QP instances, drawn as the JAX tool draws them:
    (scenario dict, assembled f64 QP dict) for each."""
    import qp_oracle as oracle

    rng = np.random.default_rng(0)
    for i in range(n):
        sc = oracle.trot_scenario(
            t0=float(rng.uniform(0, 0.4)),
            vx=float(rng.uniform(-0.3, 0.8)),
            vy=float(rng.uniform(-0.3, 0.3)),
            wz=float(rng.uniform(-2, 2)),
            yaw0=float(rng.uniform(-3, 3)),
            seed=i,
        )
        d = oracle.assemble_qp(sc["Ad"], sc["Bd"], sc["gd"], sc["x0"], sc["x_ref"],
                               sc["contact"], Q_DIAG, 1e-5, 0.8, 10.0)
        yield sc, d


def port_forces(sc: dict, dev, iters: int) -> np.ndarray:
    """The port's condensed solve of one instance at the engine's settings:
    the forces (16, 12)."""
    from convex_mpc_tpu_torch._device import as_f32
    from convex_mpc_tpu_torch.control.srb import SrbDynamics
    from convex_mpc_tpu_torch.mpc import admm, condensed

    f = lambda a: as_f32(a, dev)[None]  # noqa: E731
    dyn = SrbDynamics(Ad=f(sc["Ad"]), Bd=f(sc["Bd"]), gd=f(sc["gd"]))
    data, _ = condensed.build_condensed(
        dyn, f(sc["x0"]), f(sc["x_ref"]),
        torch.as_tensor(sc["contact"], dtype=torch.int32, device=dev)[None],
        as_f32(Q_DIAG, dev), 1e-5, 0.8, 10.0)
    data = admm.QpData(*(None if v is None else v[0] for v in data))
    st = admm.init_state(data, rho=0.1)
    sol = admm.solve(data, st, max_iter=iters, scaled_termination=True,
                     eps_abs=1e-4, eps_rel=1e-4, box_tail=192)
    return sol.x.detach().cpu().numpy().astype(float).reshape(16, 12)


def main(argv=None) -> int:
    """Run the sweep and print its report; returns the exit code."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=50)
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--max-over", type=int, default=0,
                    help="instances allowed over the budget before the exit code is 1 "
                         "(default 0, the JAX tool's rule)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("torch_parity_sweep: no CUDA device (pass --cpu for the plain CPU path)")
    dev = torch.device("cpu" if args.cpu else "cuda")

    from chip_smoke import launches, print_launches
    from convex_mpc_tpu_torch.utils.native_oracle import solve_all

    scs, qps = zip(*instances(args.n))
    refs = solve_all(list(qps))  # the oracle solves are independent: a worker pool
    before = launches()
    errs, kkts = [], []
    for sc, (x64, info) in zip(scs, refs):
        kkts.append(info["kkt"])
        u_ref = x64[192:].reshape(16, 12)
        u = port_forces(sc, dev, args.iters)
        scale = max(np.abs(u_ref[0]).max(), 1.0)
        errs.append(np.abs(u[0] - u_ref[0]).max() / scale)

    errs = np.asarray(errs) * 100
    print(f"instances: {args.n}  (oracle worst KKT residual {max(kkts):.2e})")
    print(
        f"first-step force error vs f64 optimum [%]: "
        f"mean {errs.mean():.3f}  p50 {np.percentile(errs, 50):.3f}  "
        f"p95 {np.percentile(errs, 95):.3f}  max {errs.max():.3f}"
    )
    n_over = int((errs > BUDGET).sum())
    print(f"over the {BUDGET}% BASELINE budget: {n_over}/{args.n}")
    print_launches(before)
    return 0 if n_over <= args.max_over else 1


if __name__ == "__main__":
    sys.exit(main())
