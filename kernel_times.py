"""CUDA-event times of the kernels of one checkout of the port.

    python3 kernel_times.py [--root DIR] [--nb 64 96 128] [--kernels spd admm dense tick]

Imports ``convex_mpc_tpu_torch`` from DIR (default: the directory of this
script), which builds its kernels under DIR, and times on one card, at
B = 512 on ``chip_smoke.py``'s problems: ``spd_inverse`` at n = 192, 288
and 384 (horizons 16, 24, 32) on ``chip_smoke.spd_batch(512, n, 7)``; at
25 iterations (seed 11) ``admm_iterations_structured`` at each nb, and
``admm_iterations`` at A (448, 192) and on the full form's A (640, 384)
(``chip_smoke.full_form_problem``; another checkout whose package cannot
build the full form prints why, with ``ms`` null); the fused tick window
(``run_ticks_fused``'s launch) at B = 512 for 20 ticks on
``chip_smoke.tick_battery(512, 13)``. ``--kernels`` picks which. Prints
the card's name and power limit, then one JSON line per time (``spd_inverse``'s also with the host
microseconds per call of its wrapper, 100 calls queued without a wait), and
one with ``spd_inverse``'s error on ``chip_smoke.attractor_kkt`` (cond
~1e4) against the f64 inverse, as a fraction of its largest entry, and its
residual |K out - I|. To compare two checkouts, run it on each in one call
on one card: older, newer, newer, older.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
SPD_N = (192, 288, 384)  # spd_inverse at horizons 16, 24, 32
KERNELS = ("spd", "admm", "dense", "tick")


def _smoke():
    """This checkout's chip_smoke.py (its problems, timer and card query)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_us(fn, calls: int = 100) -> float:
    """Host microseconds per call of ``fn``: the wrapper's own cost, the card
    left to run behind it (the launch queue holds all ``calls``)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--nb", type=int, nargs="+", default=[64, 96, 128])
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_times.py: no CUDA device")
    sys.path.insert(0, str(a.root.resolve()))
    from convex_mpc_tpu_torch.mpc import kernels as K
    from convex_mpc_tpu_torch.ops.chol_kernel import spd_inverse

    smoke, dev, B = _smoke(), torch.device("cuda"), 512
    print(smoke.card_identity())
    if "spd" in a.kernels:
        spd_times(a.root, smoke, spd_inverse, dev, B)
    if "admm" in a.kernels:
        for nb in a.nb:
            args = smoke.structured_problem(B, nb, seed=11, dev=dev)
            ms = smoke.cuda_ms(lambda: K.admm_iterations_structured(*args, iters=25))
            print(json.dumps({"root": str(a.root), "kernel": "admm_iterations_structured",
                              "B": B, "nb": nb, "iters": 25, "ms": ms}))
            del args
    if "dense" in a.kernels:
        dense_times(a.root, smoke, K, dev, B)
    if "tick" in a.kernels:
        tick_times(a.root, smoke, dev, B)


def spd_times(root, smoke, spd_inverse, dev, B) -> None:
    for n in SPD_N:
        A = smoke.spd_batch(B, n, 7, dev)
        ms = smoke.cuda_ms(lambda: spd_inverse(A))
        print(json.dumps({"root": str(root), "kernel": "spd_inverse", "B": B, "n": n,
                          "ms": ms, "host_us": host_us(lambda: spd_inverse(A))}))
        del A
    kkt = smoke.attractor_kkt(dev)
    k = smoke.spd_kkt_errors(kkt)
    print(json.dumps({"root": str(root), "kernel": "spd_inverse", "B": B, "n": kkt.shape[-1],
                      "case": "attractor-rho KKT", "err_of_scale": k["e_kernel"] / k["kscale"],
                      "resid": k["r_kernel"]}))


def dense_times(root, smoke, K, dev, B) -> None:
    """``admm_iterations`` for 25 iterations on the condensed shape and on the
    full form's. Only another checkout whose package lacks the full form
    (``qp.build_qp``) is let off with ``ms`` null; any other error fails."""
    problems = (("condensed", lambda: smoke.dense_problem(B, 64, seed=11, dev=dev)),
                ("full form", lambda: smoke.full_form_problem(B, dev)))
    for form, make in problems:
        rec = {"root": str(root), "kernel": "admm_iterations", "form": form, "B": B,
               "iters": 25}
        try:
            args = make()
        except AttributeError as exc:
            if root.resolve() == HERE:
                raise
            rec.update(ms=None, error=str(exc))
        else:
            rec["A"] = list(args[0].shape[1:])
            rec["ms"] = smoke.cuda_ms(lambda: K.admm_iterations(*args, iters=25))
            del args
        print(json.dumps(rec))
        torch.cuda.empty_cache()


def tick_times(root, smoke, dev, B, steps: int = 20) -> None:
    """The fused tick window's kernel alone (``tick_fused._launch``, as
    ``chip_smoke.check_tick_window`` times it) and the launch it makes, where
    the checkout reports one."""
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.sim import tick_fused as TF

    dyn, gait, contact, cmd, traj, u0, plant, leg, yc, yp, vf, t0 = smoke.tick_battery(B, 13, dev)
    carry, batch = TF._inputs(gait, contact, cmd, traj, u0, plant, leg, yc, yp, vf, t0)
    cst = TF.make_consts(dyn, 45.0)
    alpha = E._filter_alpha(30.0, 1e-3)
    ms = smoke.cuda_ms(lambda: TF._launch(carry, batch, cst, steps, 1e-3, alpha))
    shape = TF.tick_window_shape(B) if hasattr(TF, "tick_window_shape") else None
    print(json.dumps({"root": str(root), "kernel": "run_ticks_fused", "B": B, "steps": steps,
                      "ms": ms, "launch": shape}))


if __name__ == "__main__":
    main()
