"""CUDA-event times of the kernels of one checkout of the port.

    python3 kernel_times.py [--root DIR] [--nb 64 96 128] [--kernels spd admm dense tick adapt]

Imports ``convex_mpc_tpu_torch`` from DIR (default: the directory of this
script), which builds its kernels under DIR, and times on one card, at
B = 512 on ``chip_smoke.py``'s problems: ``spd_inverse`` at n = 120, 192,
288 and 384 (horizons 10, 16, 24, 32) on ``chip_smoke.spd_batch(512, n,
7)`` (a checkout whose wrapper refuses n = 120 prints why, with ``ms``
null); at
25 iterations (seed 11) ``admm_iterations_structured`` at each nb, and at
25 and 10 iterations ``admm_iterations`` on the legacy path's A at horizons
16, 24 and 32 (``chip_smoke.DENSE_SHAPES``: condensed (448, 192), (672,
288), (896, 384); full form (640, 384), (960, 576), (1280, 768)), with the
bytes its instance moves from HBM and from L2 by its design's arithmetic
and the bound (another checkout whose package cannot build the full form,
or whose kernel refuses a shape, prints why, with ``ms`` null); the fused
tick window
(``run_ticks_fused``'s launch) at B = 512 for 20 ticks on
``chip_smoke.tick_battery(512, 13)``; the adapt step's ``adapt_check`` at
each nb and at each cell's (B, nb), and ``adapt_rho``, with their bounds
and the eager stretch they replaced. ``--kernels`` picks which. Prints
the card's name and power limit, then one JSON line per time (``spd_inverse``'s also with the host
microseconds per call of its wrapper, 100 calls queued without a wait), and
one per horizon, 10, 16 and 32 (n = 120, 192 and 384), with ``spd_inverse``'s error
on ``chip_smoke.attractor_kkt`` (cond ~1e4) against the f64 inverse, as a
fraction of its largest entry, and its residual |K out - I|, each beside
the plain version's. To compare two checkouts, run it on each in one call
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
SPD_N = (120, 192, 288, 384)  # spd_inverse at horizons 10, 16, 24, 32
KERNELS = ("spd", "admm", "dense", "tick", "adapt")


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
    if "adapt" in a.kernels:
        adapt_times(a.root, smoke, K, dev, B, a.nb)


def spd_times(root, smoke, spd_inverse, dev, B) -> None:
    refused = {}
    for n in SPD_N:
        A = smoke.spd_batch(B, n, 7, dev)
        try:
            spd_inverse(A)
        except ValueError as e:  # an older wrapper: n a multiple of 32 only
            refused[n] = str(e)
            print(json.dumps({"root": str(root), "kernel": "spd_inverse", "B": B, "n": n,
                              "ms": None, "why": refused[n]}))
            continue
        ms = smoke.cuda_ms(lambda: spd_inverse(A))
        print(json.dumps({"root": str(root), "kernel": "spd_inverse", "B": B, "n": n,
                          "ms": ms, "host_us": host_us(lambda: spd_inverse(A))}))
        del A
    for horizon in (10, 16, 32):
        if 12 * horizon in refused:
            continue
        kkt = smoke.attractor_kkt(dev, horizon=horizon)
        k = smoke.spd_kkt_errors(kkt)
        print(json.dumps({"root": str(root), "kernel": "spd_inverse", "B": B, "n": kkt.shape[-1],
                          "case": f"attractor-rho KKT, horizon {horizon}",
                          "err_of_scale": k["e_kernel"] / k["kscale"],
                          "plain_err_of_scale": k["e_plain"] / k["kscale"],
                          "resid": k["r_kernel"], "plain_resid": k["r_plain"]}))
        del kkt
        torch.cuda.empty_cache()


L2_BYTES = 50e6  # the H100's L2


def dense_bytes(inst_name: str, resident: int, B: int, m: int, n: int, iters: int) -> dict:
    """The bytes kernel 4's instance ``inst_name`` (its checkout's
    ``DENSE_INSTANCES`` entry) moves a chunk by its design's own arithmetic:
    each launch reads A and Minv from HBM once; then the rows it reads again
    come from L2 where the resident clusters' share of them fits its 50 MB,
    else from HBM. Streamed, an iteration reads A twice (steps 1 and 5) and
    Minv once (A and Minv from device memory), A twice (A from device
    memory), A once a pass, iters + 1 passes (the ring), or nothing (on
    chip)."""
    a, mv = 4.0 * m * n, 4.0 * n * n
    once = B * (a + mv)
    if "ring" in inst_name:
        again = B * a * iters  # the prologue's pass is the launch's first read
        per_scenario = a
    elif "A and Minv from device memory" in inst_name:
        again = B * (2 * a * iters + mv * iters) - once
        per_scenario = a + mv
    elif "from device memory" in inst_name:
        again = B * 2 * a * iters - B * a
        per_scenario = a
    else:
        again, per_scenario = 0.0, 0.0
    in_l2 = resident * per_scenario <= L2_BYTES
    return {"hbm_bytes": once + (0.0 if in_l2 else again), "l2_bytes": again if in_l2 else 0.0}


def dense_times(root, smoke, K, dev, B) -> None:
    """``admm_iterations`` for 25 and for 10 iterations (the legacy solver's
    launches are at most 10) on each of ``chip_smoke.DENSE_SHAPES`` (the
    legacy path's condensed and full-form A at horizons 16, 24 and 32), with
    the launch ``dense_cluster_shape`` reports, the bytes its instance moves
    (``dense_bytes``) and the bound (``chip_smoke.bound``). Only another
    checkout is let off with ``ms`` null: where its package lacks the full
    form (``qp.build_qp``) or its kernel refuses the shape; any other error
    fails."""
    for form, horizon, _ in smoke.DENSE_SHAPES:
        try:
            args = smoke.dense_problem_at(form, horizon, B, dev)
            A = list(args[0].shape[1:])
            launch = list(K.dense_cluster_shape(*A))
            K.admm_iterations(*args, iters=1)
        except (AttributeError, RuntimeError) as exc:
            if root.resolve() == HERE:
                raise
            print(json.dumps({"root": str(root), "kernel": "admm_iterations", "form": form,
                              "horizon": horizon, "B": B, "ms": None, "error": str(exc)}))
            args = None
            torch.cuda.empty_cache()
            continue
        m, n = A
        inst = K.DENSE_INSTANCES[launch[3]] if launch[3] >= 0 else None
        for iters in (25, 10):
            rec = {"root": str(root), "kernel": "admm_iterations", "form": form,
                   "horizon": horizon, "B": B, "iters": iters, "A": A, "launch": launch,
                   "instance": inst}
            rec["ms"] = smoke.cuda_ms(lambda: K.admm_iterations(*args, iters=iters))
            rec.update(dense_bytes(inst or "", launch[1], B, m, n, iters))
            flops = B * iters * (4 * m * n + 2 * n * n + 12 * m + 6 * n)
            rec["bound_ms"], rec["bound_by"] = smoke.bound(
                4 * B * (m * n + n * n + 2 * n + 6 * m) + 4 * B * (n + 2 * m), flops)
            print(json.dumps(rec))
        args = None
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


def adapt_times(root, smoke, K, dev, B, nbs) -> None:
    """The adapt step's two kernels at B and each nb, and at each cell's
    (B, nb) (``chip_smoke.ADAPT_CELLS``), on ``chip_smoke.adapt_problem`` and
    ``adapt_rho_problem``, each beside its bound (bytes) and the eager
    stretch it replaced (``chip_smoke.adapt_check_eager``; for adapt_rho
    ``kernels.adapt_rho_plain``, that stretch as it stood). A checkout
    without the kernels prints adapt_check's eager stretch alone, with
    ``ms`` null."""
    has = hasattr(K, "adapt_check")
    kw = dict(iters_done=100, eps_abs=2.0, eps_rel=0.8, **smoke.ADAPT_SETTINGS)
    r_kw = smoke.adapt_rho_kwargs("adapt boundary")
    for b, nb in [(B, nb) for nb in nbs] + list(smoke.ADAPT_CELLS):
        p = smoke.adapt_problem(b, nb, 13, dev)
        v = smoke.adapt_rho_problem(b, 17, dev)
        b_ms, b_by = smoke.bound(smoke.adapt_check_bytes(b, nb), 2 * b * (3 * nb) ** 2)
        print(json.dumps({"root": str(root), "kernel": "adapt_check", "B": b, "nb": nb,
                          "ms": smoke.cuda_ms(lambda: K.adapt_check(*p.values(), **kw), reps=20)
                          if has else None,
                          "eager_ms": smoke.cuda_ms(lambda: smoke.adapt_check_eager(
                              *p.values(), **kw)),
                          "bound_ms": b_ms, "bound_by": b_by}))
        if has:
            print(json.dumps({"root": str(root), "kernel": "adapt_rho", "B": b,
                              "ms": smoke.cuda_ms(lambda: K.adapt_rho(*v.values(), **r_kw),
                                                  reps=20),
                              "eager_ms": smoke.cuda_ms(lambda: K.adapt_rho_plain(
                                  *v.values(), **r_kw)),
                              "bound_ms": smoke.bound(smoke.adapt_rho_bytes(b), 0)[0]}))
        del p, v
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
