"""Microbenchmark of the ways to form the KKT inverse on one card, at the production shape.

The port's counterpart of ``tools/kkt_microbench.py``, with its options,
defaults and rows. The ADMM solver's setup refactorizes M(rho) = P +
sigma I + rho K per rho segment; at B = 512, n = 192, f32 this times every
way of producing M^-1 (``M = G G' + 10 I``, ``K = G G'``, G standard
normal from a numpy seed):

  a) the library path: ``cholesky`` + monolithic triangular inverse +
     matmul (``setup_current(1seg)``);
  b) the blocked triangular inverse (``tools/torch_blocked_linalg.py``);
  c) the blocked Cholesky;
  d) a batched ``eigh`` of K (a one-time cost; each refactorization is then
     a diagonal rescale and one matmul, ``eig_refactor(1seg)``);
  e) the engine's own path, kernel 1 (``spd_inverse``, ``csrc/spd_inverse.cu``),
     the row the JAX tool lacks.

Everything runs in full f32 (the port pins TF32 off) except two rows kept
from the JAX tool as precisions the engine does not use: ``matmul_default``
(TF32 here; bf16 passes on a TPU) and ``matmul_bf16`` (bf16 operands, f32
out), each with its precision set inside the tool and restored after.
Each row is the best of ``--reps`` calls after one untimed call, timed
with CUDA events. Needs the card (no ``--cpu``). Prints the rows, the
4-segment estimates, one JSON line (ms, unrounded) and the ``launches:``
line:

    python3 tools/torch_kkt_microbench.py [--batch 512] [--n 192] [--reps 5]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_blocked_linalg as blx  # noqa: E402

# the rows that run at a precision the engine does not use
OFF_ENGINE = {"matmul_default": "TF32", "matmul_bf16": "bf16 operands"}


@contextlib.contextmanager
def tf32():
    """TF32 matmuls inside the block; the port's full-f32 setting restored after."""
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prec)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--n", type=int, default=192)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    B, n = args.batch, args.n

    from chip_smoke import best_seconds, print_launches, tool_device
    from convex_mpc_tpu_torch.ops.chol_kernel import spd_inverse

    dev = tool_device("torch_kkt_microbench", cpu=False)

    def best_of(fn, *a, n):
        return best_seconds(lambda: fn(*a), dev, outer=n)

    G = torch.as_tensor(np.random.default_rng(0).standard_normal((B, n, n)), dtype=torch.float32,
                        device=dev)
    K = G @ G.transpose(-1, -2)
    eye = torch.eye(n, device=dev)
    M = K + 10.0 * eye
    L = torch.linalg.cholesky(M)

    def tri_inv_mono(L):
        return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)

    def minv_from_linv(Linv):
        return Linv.transpose(-1, -2) @ Linv

    def current_setup(M):
        return minv_from_linv(tri_inv_mono(torch.linalg.cholesky(M)))

    def blocked_setup(M):
        return minv_from_linv(blx.blocked_tri_inverse(blx.blocked_cholesky(M, 64), 64))

    def mm_default(A, B_):
        with tf32():
            return A @ B_

    def mm_bf16(A, B_):
        return (A.to(torch.bfloat16) @ B_.to(torch.bfloat16)).float()

    def eig_refactor(W, lam, rho):
        scale = 1.0 / (1.0 + rho[..., None] * lam)
        return (W * scale[..., None, :]) @ W.transpose(-1, -2)

    r = {}
    r["cholesky"] = best_of(torch.linalg.cholesky, M, n=args.reps)
    r["tri_inv_monolithic"] = best_of(tri_inv_mono, L, n=args.reps)
    r["tri_inv_blocked64"] = best_of(blx.blocked_tri_inverse, L, 64, n=args.reps)
    Linv = tri_inv_mono(L)
    r["minv_matmul"] = best_of(minv_from_linv, Linv, n=args.reps)
    r["matmul_default"] = best_of(mm_default, Linv, M, n=args.reps)
    r["matmul_bf16"] = best_of(mm_bf16, Linv, M, n=args.reps)
    b1 = torch.ones((B, n, 1), device=dev)
    r["trisolve_1rhs"] = best_of(lambda L, b: torch.linalg.solve_triangular(L, b, upper=False),
                                 L, b1, n=args.reps)
    r["setup_current(1seg)"] = best_of(current_setup, M, n=args.reps)
    r["setup_blocked(1seg)"] = best_of(blocked_setup, M, n=args.reps)
    r["blocked_cholesky"] = best_of(blx.blocked_cholesky, M, 64, n=args.reps)
    r["eigh"] = best_of(torch.linalg.eigh, K, n=args.reps)
    lam, W = torch.linalg.eigh(K)
    r["eig_refactor(1seg)"] = best_of(eig_refactor, W, lam, torch.full((B,), 0.37, device=dev),
                                      n=args.reps)
    r["spd_inverse_kernel"] = best_of(spd_inverse, M, n=args.reps)

    print(f"\nB={B} n={n} f32, best of {args.reps} (cuda)")
    for k, v in sorted(r.items(), key=lambda kv: kv[1]):
        note = (f"  ({OFF_ENGINE[k]}: a precision the engine does not use)"
                if k in OFF_ENGINE else "")
        print(f"  {k:24s} {v * 1e3:9.2f} ms{note}")
    cur4 = 4 * r["setup_current(1seg)"]
    print(f"\n  4-segment current setup: {cur4 * 1e3:.1f} ms")
    eig4 = (r["cholesky"] + r["tri_inv_blocked64"] + 2 * r["minv_matmul"] + r["eigh"]
            + 4 * r["eig_refactor(1seg)"])
    print(f"  eig-path (chol+triinv+2mm+eigh+4 refac): {eig4 * 1e3:.1f} ms")
    blk4 = 4 * r["setup_blocked(1seg)"]
    print(f"  4-segment blocked setup: {blk4 * 1e3:.1f} ms")
    print(f"  4-segment kernel 1 (spd_inverse): {4 * r['spd_inverse_kernel'] * 1e3:.1f} ms")
    print(json.dumps({k: v * 1e3 for k, v in r.items()}))  # ms, unrounded
    r["launches"] = print_launches()
    return r


if __name__ == "__main__":
    main()
