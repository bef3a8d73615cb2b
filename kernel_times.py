"""CUDA-event times of the two ADMM kernels of one checkout of the port.

    python3 kernel_times.py [--root DIR] [--nb 64 96 128]

Imports ``convex_mpc_tpu_torch`` from DIR (default: the directory of this
script), which builds its kernels under DIR, and times on one card, at
B = 512 on ``chip_smoke.py``'s problems (seed 11), 25 iterations:
``admm_iterations_structured`` at each nb, and ``admm_iterations`` at
A (448, 192). Prints the card's name and power limit, then one JSON line per
time. To compare two checkouts, run it on each in one call on one card:
older, newer, newer, older.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def _smoke():
    """This checkout's chip_smoke.py (its problems, timer and card query)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--nb", type=int, nargs="+", default=[64, 96, 128])
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_times.py: no CUDA device")
    sys.path.insert(0, str(a.root.resolve()))
    from convex_mpc_tpu_torch.mpc import kernels as K

    smoke, dev, B = _smoke(), torch.device("cuda"), 512
    print(smoke.card_identity())
    for nb in a.nb:
        args = smoke.structured_problem(B, nb, seed=11, dev=dev)
        ms = smoke.cuda_ms(lambda: K.admm_iterations_structured(*args, iters=25))
        print(json.dumps({"root": str(a.root), "kernel": "admm_iterations_structured",
                          "B": B, "nb": nb, "iters": 25, "ms": ms}))
        del args
    args = smoke.dense_problem(B, 64, seed=11, dev=dev)
    ms = smoke.cuda_ms(lambda: K.admm_iterations(*args, iters=25))
    print(json.dumps({"root": str(a.root), "kernel": "admm_iterations", "B": B,
                      "A": list(args[0].shape[1:]), "iters": 25, "ms": ms}))


if __name__ == "__main__":
    main()
