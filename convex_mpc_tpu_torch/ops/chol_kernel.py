"""Batched SPD inverse: the hand-written CUDA kernel and its plain version.

Replaces ``convex_mpc_tpu/ops/chol_kernel.py::spd_inverse`` (a Pallas TPU
kernel). The CUDA kernel is ``csrc/spd_inverse.cu``; its C side decides
whether the packed working set lives in one CTA's shared memory, split over
the shared memories of a cluster of two CTAs, or in a device-memory scratch
buffer, and ``spd_inverse_shape`` reads that choice back (design and bound
in its header). Any order n: the kernel runs a matrix on its 16-row panel
grid, n rounded up to ``grid_order(n)``, with the identity in the pad, and
stores the n x n block. The wrapper takes the plain PyTorch version for CPU
tensors only; a CUDA tensor launches the kernel or raises. On either route
it counts the work in ``utils.profiling``'s counters:
``spd_inverse.ops`` (n^3 a matrix), and for a matrix whose grid is larger
than n, ``spd_inverse.padded`` (matrices) and ``spd_inverse.pad_ops``
(grid_order(n)^3 - n^3 a matrix).

Both versions return NaN for every matrix whose Cholesky meets a pivot that
is not positive: the polish certificate relies on that signal.
"""

from __future__ import annotations

import ctypes

import torch

from convex_mpc_tpu_torch.utils import cuda_build
from convex_mpc_tpu_torch.utils.profiling import count

PANEL = 16  # the kernel's panel width (NB in csrc/spd_inverse.cu)


def grid_order(n: int) -> int:
    """The order of the panel grid the kernel runs a matrix of order n on."""
    return -(-n // PANEL) * PANEL


def spd_inverse_plain(A: torch.Tensor) -> torch.Tensor:
    """Cholesky, triangular solve, Gram — the JAX function's off-TPU path.

    ``torch.linalg.cholesky`` raises where JAX returns NaN, so this uses
    ``cholesky_ex`` and writes NaN into every matrix whose ``info != 0``.
    """
    L, info = torch.linalg.cholesky_ex(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand_as(A)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    out = torch.matmul(Linv.transpose(-1, -2), Linv)
    return torch.where((info != 0)[:, None, None], float("nan"), out)


_KERNEL = cuda_build.Kernel("spd_inverse", "spd_inverse", "spd_inverse_f32", pointers=3, ints=2,
                            floats=0)
_shapes: dict[tuple[int, int], tuple[int, int, int, int]] = {}


def spd_inverse_shape(n: int) -> tuple[int, int, int, int]:
    """The launch ``csrc/spd_inverse.cu`` makes for n on the current card, as
    its C side chooses it at ``grid_order(n)`` (an n that is no multiple of
    4 always in the scratch): (dynamic shared-memory bytes per CTA, scratch
    floats per matrix, resident, CTAs per cluster). One CTA a matrix (4th
    field 1) holds the packed working set of n (n + 4) / 2 floats on chip
    (scratch 0) or in the scratch (shared bytes 0), and ``resident`` counts
    its CTAs per SM; a cluster of 2 (4th field 2) splits it between its two
    CTAs' shared memories, and ``resident`` counts the clusters resident on
    the card at once. Asked of the C side once per (card, n)."""
    key = (torch.cuda.current_device(), n)
    shape = _shapes.get(key)
    if shape is None:
        c_int = ctypes.c_int
        shape = _shapes[key] = cuda_build.query("spd_inverse", "spd_inverse_shape", (n,),
                                                (c_int, ctypes.c_longlong, c_int, c_int))
    return shape


def _launch(A: torch.Tensor, out: torch.Tensor) -> None:
    """The kernel alone: ``out`` = the inverse of each matrix of ``A``."""
    B, n = A.shape[0], A.shape[1]
    floats = spd_inverse_shape(n)[1]
    scratch = torch.empty((B, floats), dtype=A.dtype, device=A.device) if floats else None
    cuda_build.launch(_KERNEL, (A, out, scratch), (B, n), what=f"spd_inverse (n={n})")


def spd_inverse(A: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse of (B, n, n) f32, any n > 0."""
    if A.ndim != 3 or A.shape[1] != A.shape[2] or A.shape[1] == 0:
        raise ValueError(f"spd_inverse expects (B, n, n) with n > 0, got {tuple(A.shape)}")
    dev = cuda_build.operands("spd_inverse", A=(A, A.shape, torch.float32))
    B, n = A.shape[0], A.shape[1]
    count("spd_inverse.ops", B * n ** 3)
    pad = grid_order(n) ** 3 - n ** 3
    if pad:
        count("spd_inverse.padded", B)
        count("spd_inverse.pad_ops", B * pad)
    if dev.type == "cpu":
        return spd_inverse_plain(A)
    A = A.contiguous()
    out = torch.empty_like(A)
    if B > 0:
        _launch(A, out)
    return out
