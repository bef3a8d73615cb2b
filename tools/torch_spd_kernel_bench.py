"""Chained microbench of the port's ``spd_inverse`` (kernel 1) beside the library's inverse.

The port's counterpart of ``tools/spd_kernel_bench.py``: ``--reps`` calls
chained so that each call's input is perturbed by the last call's output
(its ridge moves by 1e-12 x |out[0, 0, 0]|), queued on one stream with no
host read between them, timed with CUDA events (best of 3 chains after
one untimed chain); beside it the same chain of ``torch.linalg.cholesky_ex``
+ ``torch.cholesky_inverse``. The batch is ``M = G G' + 10 I``, G standard
normal from a numpy seed. Prints ms per call and max|M A - I| of one call
of each, per n, and the ``launches:`` line.

The JAX tool's ``--blk`` / ``--block_k`` grid has no counterpart: the CUDA
kernel has no such knob (its blocking is fixed in ``csrc/spd_inverse.cu``,
and the port's unused ``blk`` was removed).

Runs on the CUDA card; ``--cpu`` runs the plain version on the CPU (its
times are CPU times):

    python3 tools/torch_spd_kernel_bench.py [--batch 512] [--n 192 288 384] [--reps 10]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def library_inverse(A: torch.Tensor) -> torch.Tensor:
    return torch.cholesky_inverse(torch.linalg.cholesky_ex(A)[0])


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        epilog="The JAX tool's --blk / --block_k grid has no counterpart: the CUDA kernel's "
               "blocking is fixed in csrc/spd_inverse.cu, and the port's unused blk was removed.")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--n", type=int, nargs="+", default=[192])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain version)")
    args = ap.parse_args(argv)
    B, reps = args.batch, args.reps

    from chip_smoke import best_seconds, print_launches, tool_device
    from convex_mpc_tpu_torch.ops.chol_kernel import spd_inverse

    dev = tool_device("torch_spd_kernel_bench", args.cpu)

    def chain_ms(inv, M, eye):
        def run():
            carry = torch.zeros((), device=dev)
            for _ in range(reps):
                out = inv(M + (carry * 1e-12) * eye)
                carry = torch.abs(out[0, 0, 0])

        return best_seconds(run, dev) * 1e3 / reps

    rows = []
    for n in args.n:
        G = torch.as_tensor(np.random.default_rng(0).standard_normal((B, n, n)),
                            dtype=torch.float32, device=dev)
        eye = torch.eye(n, device=dev)
        M = G @ G.transpose(-1, -2) + 10.0 * eye
        for name, inv in (("spd_inverse", spd_inverse),
                          ("cholesky_ex+cholesky_inverse", library_inverse)):
            ms = chain_ms(inv, M, eye)
            resid = float(torch.abs(M @ inv(M) - eye).max())
            print(f"n={n:3d} {name:28s}: {ms:8.3f} ms/call  max|MA-I|={resid:.3e}", flush=True)
            rows.append(dict(n=n, batch=B, route=name, ms_per_call=ms, max_resid=resid))
        del G, M
    print(json.dumps(rows))
    print_launches()
    return rows


if __name__ == "__main__":
    main()
