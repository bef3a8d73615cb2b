"""Batched SPD inverse: the hand-written CUDA kernel and its plain version.

Replaces ``convex_mpc_tpu/ops/chol_kernel.py::spd_inverse`` (a Pallas TPU
kernel). The CUDA kernel is ``csrc/spd_inverse.cu`` (one block per matrix;
its C side decides whether the packed working set lives in shared memory or
in a device-memory scratch buffer, and ``spd_inverse_shape`` reads that
choice back; design and bound in its header). The wrapper takes
the plain PyTorch version for CPU tensors only; a CUDA tensor launches the
kernel or raises.

Both versions return NaN for every matrix whose Cholesky meets a pivot that
is not positive: the polish certificate relies on that signal.
"""

from __future__ import annotations

import ctypes

import torch

from convex_mpc_tpu_torch.utils import cuda_build

# n must be a multiple of N_MULTIPLE (the solver dispatches here on
# nz % 32 == 0; the kernel's panels are 16 wide).
N_MULTIPLE = 32


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


_lib = None
_shapes: dict[tuple[int, int], tuple[int, int, int]] = {}


def _library() -> ctypes.CDLL:
    """The loaded ``spd_inverse`` library, its entry points typed once."""
    global _lib
    if _lib is None:
        lib = cuda_build.load("spd_inverse")
        lib.spd_inverse_shape.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                          ctypes.POINTER(ctypes.c_longlong),
                                          ctypes.POINTER(ctypes.c_int)]
        lib.spd_inverse_shape.restype = ctypes.c_int
        lib.spd_inverse_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                                                 ctypes.c_void_p]
        lib.spd_inverse_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


def spd_inverse_shape(n: int) -> tuple[int, int, int]:
    """The launch ``csrc/spd_inverse.cu`` makes for n on the current card, as
    its C side chooses it: (dynamic shared-memory bytes, scratch floats per
    matrix, CTAs resident per SM). Exactly one of the first two is 0: the
    packed working set of n (n + 4) / 2 floats is on chip or in the scratch.
    Asked of the C side once per (card, n)."""
    key = (torch.cuda.current_device(), n)
    shape = _shapes.get(key)
    if shape is None:
        smem, scratch, ctas = ctypes.c_int(0), ctypes.c_longlong(0), ctypes.c_int(0)
        cuda_build.check(_library().spd_inverse_shape(n, ctypes.byref(smem), ctypes.byref(scratch),
                                                      ctypes.byref(ctas)), "spd_inverse shape")
        shape = _shapes[key] = (smem.value, scratch.value, ctas.value)
    return shape


def _launch(A: torch.Tensor, out: torch.Tensor) -> None:
    cuda_build.require_cuda("spd_inverse", A, out)
    B, n = A.shape[0], A.shape[1]
    _, scratch_floats, _ = spd_inverse_shape(n)
    scratch = None
    if scratch_floats:
        scratch = torch.empty((B, scratch_floats), dtype=A.dtype, device=A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = _library().spd_inverse_f32(A.data_ptr(), out.data_ptr(),
                                     None if scratch is None else scratch.data_ptr(), B, n, stream)
    cuda_build.check(err, "spd_inverse")


def spd_inverse(A: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse of (B, n, n) f32, n a multiple of ``N_MULTIPLE``."""
    if A.ndim != 3 or A.shape[1] != A.shape[2] or A.shape[1] % N_MULTIPLE != 0:
        raise ValueError(f"spd_inverse expects (B, n, n) with n % {N_MULTIPLE} == 0, "
                         f"got {tuple(A.shape)}")
    if A.dtype != torch.float32:
        raise TypeError(f"spd_inverse is f32-only, got {A.dtype}")
    if A.device.type == "cpu":
        return spd_inverse_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"spd_inverse runs on CPU or CUDA tensors, got {A.device}")
    A = A.contiguous()
    out = torch.empty_like(A)
    if A.shape[0] > 0:
        _launch(A, out)
        spd_inverse.launches += 1
    return out


spd_inverse.launches = 0
