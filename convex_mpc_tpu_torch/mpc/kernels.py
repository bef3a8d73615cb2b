"""The ADMM iteration kernels: the hand-written CUDA kernels and their plain versions.

Two kernels, each replacing a Pallas TPU kernel of
``convex_mpc_tpu/mpc/kernels.py``:

- :func:`admm_iterations_structured` — the structured chunk of the
  production ``admm.solve_adaptive``. The CUDA kernel is
  ``csrc/admm_structured.cu`` (a thread-block cluster per scenario whose
  CTAs split it by friction blocks, each with its rows of Minv on chip for
  the whole chunk; design and bound in its header). The plain version is
  the JAX twin ``admm_iterations_structured_xla`` transcribed: the same
  unrolled block sums and the same binary-tree fold, each product and sum a
  separate eager op, so the kernel (compiled without multiply-add
  contraction) can agree with it bit for bit on the card;
- :func:`admm_iterations` — the dense-A iterations of the legacy
  fixed-segment ``admm.solve``, on the condensed QP (A (28 N, 12 N) at
  horizon N: (448, 192) at 16) and on the full form (A (40 N, 24 N): (640,
  384) at 16, up to (1280, 768) at 32). The CUDA kernel is
  ``csrc/admm_dense.cu`` (a cluster of 8 CTAs per scenario, 16 at A (1280,
  768), that split the rows of A and Minv, each column of A' t summed by the
  CTA that owns it); its instance (:data:`DENSE_INSTANCES`) says whether a
  CTA's rows of A sit in shared memory for the whole chunk, pass once an
  iteration through one-row TMA slots, one per warp, or are read in place
  from device memory with Minv's, the first whose shared bytes fit. An n
  that is not a
  multiple of 4 is padded (:func:`_pad_dense`), as the TPU kernel pads to
  128. The plain version is the arithmetic of the TPU ``_kernel``.

Each wrapper takes the plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises. Each C launcher picks its launch from its own
shared-memory layout and raises where none fits the card: no other route is
taken in its place. :func:`structured_cluster_shape` and
:func:`dense_cluster_shape` read that choice back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from convex_mpc_tpu_torch.utils import cuda_build


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def admm_iterations_structured_plain(C, box_diag, Minv, q, l, u, rho_vec, x0, z0, y0,
                                     iters: int, sigma: float = 1e-6, alpha: float = 1.6):
    """``iters`` over-relaxed ADMM steps per scenario, plain PyTorch."""
    B, nb = C.shape[0], C.shape[1]
    nz, m_fr = nb * 3, nb * 4
    np2 = _next_pow2(max(nz, 128))

    def mv_AT(w):
        wf = w[:, :m_fr].reshape(B, nb, 4)
        acc = C[:, :, 0, :] * wf[:, :, 0:1]
        for f in range(1, 4):
            acc = acc + C[:, :, f, :] * wf[:, :, f:f + 1]
        return acc.reshape(B, nz) + box_diag * w[:, m_fr:]

    def mv_A(v):
        vr = v.reshape(B, nb, 3)
        acc = C[:, :, :, 0] * vr[:, :, 0:1]
        for r in range(1, 3):
            acc = acc + C[:, :, :, r] * vr[:, :, r:r + 1]
        return torch.cat([acc.reshape(B, m_fr), box_diag * v], dim=-1)

    def kkt_matvec(rhs):
        prod = rhs[:, None, :] * Minv  # (B, nz, nz) [n, m]
        prod = torch.nn.functional.pad(prod, (0, np2 - nz))
        k = np2
        while k > 1:
            h = k // 2
            prod = prod[:, :, :h] + prod[:, :, h:k]
            k = h
        return prod[:, :, 0]

    x, z, y = x0, z0, y0
    for _ in range(iters):
        rhs = sigma * x - q + mv_AT(rho_vec * z - y)
        xt = kkt_matvec(rhs)
        axt = mv_A(xt)
        x_new = alpha * xt + (1.0 - alpha) * x
        ax_rel = alpha * axt + (1.0 - alpha) * z
        z_new = torch.clamp(ax_rel + y / rho_vec, l, u)
        y = y + rho_vec * (ax_rel - z_new)
        x, z = x_new, z_new
    return x, z, y


def _cluster_shape(name: str, *sizes: int, outputs: int = 2) -> tuple[int, ...]:
    """(CTAs per cluster, clusters resident at once on this card, ...) of the
    launch that ``csrc/<name>.cu`` makes for ``sizes``, as its C launcher
    (``<name>_shape``, ``outputs`` int results) chooses them."""
    fn = getattr(cuda_build.load(name), f"{name}_shape")
    fn.argtypes = [ctypes.c_int] * len(sizes) + [ctypes.POINTER(ctypes.c_int)] * outputs
    fn.restype = ctypes.c_int
    out = [ctypes.c_int(0) for _ in range(outputs)]
    cuda_build.check(fn(*sizes, *(ctypes.byref(v) for v in out)), f"{name} shape")
    return tuple(v.value for v in out)


def structured_cluster_shape(nb: int) -> tuple[int, int]:
    """The structured kernel's cluster for nb friction blocks: the smallest
    of at least 2 CTAs whose share of Minv fits one CTA (2 at nb = 64 and 96,
    3 at 128), and how many are resident at once."""
    return _cluster_shape("admm_structured", nb)


def _launch(C, box_diag, Minv, q, l, u, rho_vec, x0, z0, y0, iters, sigma, alpha):
    cuda_build.require_cuda("admm_iterations_structured", C, box_diag, Minv, q, l, u,
                            rho_vec, x0, z0, y0)
    B, nb = C.shape[0], C.shape[1]
    xo = torch.empty_like(x0)
    zo = torch.empty_like(z0)
    yo = torch.empty_like(y0)
    fn = cuda_build.load("admm_structured").admm_structured_f32
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [ctypes.c_float] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    stream = torch.cuda.current_stream(C.device).cuda_stream
    ptrs = [t.data_ptr() for t in (C, box_diag, Minv, q, l, u, rho_vec, x0, z0, y0, xo, zo, yo)]
    err = fn(*ptrs, B, nb, iters, f32(sigma), f32(alpha), f32(1.0 - alpha), stream)
    cuda_build.check(err, "admm_iterations_structured")
    return xo, zo, yo


def admm_iterations_structured(C, box_diag, Minv, q, l, u, rho_vec, x0, z0, y0,
                               iters: int, sigma: float = 1e-6, alpha: float = 1.6):
    """The structured ADMM chunk; returns (x, z, y)."""
    B, nb = C.shape[0], C.shape[1]
    nz, m = 3 * nb, 7 * nb
    args = (C, box_diag, Minv, q, l, u, rho_vec, x0, z0, y0)
    shapes = [(B, nb, 4, 3), (B, nz), (B, nz, nz), (B, nz), (B, m), (B, m), (B, m),
              (B, nz), (B, m), (B, m)]
    for name, t, s in zip("C box_diag Minv q l u rho_vec x0 z0 y0".split(), args, shapes):
        if tuple(t.shape) != s:
            raise ValueError(f"admm_iterations_structured: {name} has shape {tuple(t.shape)}, expected {s}")
        if t.dtype != torch.float32:
            raise TypeError(f"admm_iterations_structured: {name} must be f32, got {t.dtype}")
        if t.device != C.device:
            raise ValueError("admm_iterations_structured: all operands on one device")
    if C.device.type == "cpu":
        return admm_iterations_structured_plain(*args, iters=iters, sigma=sigma, alpha=alpha)
    if C.device.type != "cuda":
        raise ValueError(f"admm_iterations_structured runs on CPU or CUDA tensors, got {C.device}")
    args = [t.contiguous() for t in args]
    out = _launch(*args, iters, sigma, alpha)
    admm_iterations_structured.launches += 1
    return out


admm_iterations_structured.launches = 0


# ---------------------------------------------------------------------------
# dense-A iterations (legacy fixed-segment admm.solve)
# ---------------------------------------------------------------------------
def admm_iterations_plain(A, Minv, q, l, u, rho, x0, z0, y0, iters: int,
                          sigma: float = 1e-6, alpha: float = 1.6):
    """``iters`` over-relaxed ADMM steps against a dense A (B, m, n), plain
    PyTorch. ``y / rho`` is true division, and 0 on rows with rho = 0."""
    pos = rho > 0
    rho_safe = torch.where(pos, rho, 1.0)
    x, z, y = x0, z0, y0
    for _ in range(iters):
        t = rho * z - y
        rhs = sigma * x - q + torch.einsum("bmn,bm->bn", A, t)
        xt = torch.einsum("bnk,bk->bn", Minv, rhs)
        axt = torch.einsum("bmn,bn->bm", A, xt)
        x_new = alpha * xt + (1.0 - alpha) * x
        ax_rel = alpha * axt + (1.0 - alpha) * z
        z_new = torch.clamp(ax_rel + torch.where(pos, y / rho_safe, 0.0), l, u)
        y = y + rho * (ax_rel - z_new)
        x, z = x_new, z_new
    return x, z, y


_INVALID_CONFIGURATION = 9  # cudaErrorInvalidConfiguration

# admm_dense.cu's instances, by the index its launcher reports: where a CTA's
# rows of A and Minv are read from
DENSE_INSTANCES = ("A and Minv on chip", "A through a TMA ring once an iteration, Minv on chip",
                   "A and Minv from device memory")


def dense_cluster_shape(m: int, n: int) -> tuple[int, int, int, int]:
    """The dense kernel's launch for A (m, n), n a multiple of 4, as its C
    launcher sizes it: (CTAs per cluster (8 or 16), clusters resident at
    once, dynamic shared bytes per CTA, instance: an index into
    :data:`DENSE_INSTANCES`); 0 CTAs, 0 resident, 0 bytes and instance -1
    where no instance fits one cluster."""
    return _cluster_shape("admm_dense", m, n, outputs=4)


def _pad_dense(A, Minv, q, l, u, rho, x0, z0, y0):
    """The operands with n padded up to a multiple of 4 (the kernel's float4
    rows): zero columns of A, a zero border of Minv, zero q and x0. The
    padded entries of x stay 0 and change nothing else, so slicing x back to
    n gives the unpadded iterations (the TPU kernel pads n to 128 the same
    way)."""
    n = A.shape[-1]
    k = -n % 4
    pad = torch.nn.functional.pad
    return (pad(A, (0, k)), pad(Minv, (0, k, 0, k)), pad(q, (0, k)), l, u, rho, pad(x0, (0, k)),
            z0, y0)


def _launch_dense(A, Minv, q, l, u, rho, x0, z0, y0, iters, sigma, alpha):
    cuda_build.require_cuda("admm_iterations", A, Minv, q, l, u, rho, x0, z0, y0)
    B, m, n = A.shape
    if n % 4 or A.data_ptr() % 16 or Minv.data_ptr() % 16:
        raise ValueError(f"admm_iterations kernel: n = {n} must be a multiple of 4 "
                         f"(admm_iterations pads it) and A, Minv 16-byte aligned (the "
                         f"kernel's float4 loads)")
    xo, zo, yo = torch.empty_like(x0), torch.empty_like(z0), torch.empty_like(y0)
    fn = cuda_build.load("admm_dense").admm_dense_f32
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    stream = torch.cuda.current_stream(A.device).cuda_stream
    ptrs = [t.data_ptr() for t in (A, Minv, q, l, u, rho, x0, z0, y0, xo, zo, yo)]
    err = fn(*ptrs, B, m, n, iters, f32(sigma), f32(alpha), f32(1.0 - alpha), stream)
    if err == _INVALID_CONFIGURATION:
        raise RuntimeError(f"admm_iterations: no instance of admm_dense.cu fits one cluster "
                           f"on this card at A ({m}, {n}), Minv ({n}, {n}) (cudaError {err})")
    cuda_build.check(err, "admm_iterations")
    return xo, zo, yo


def admm_iterations(A, Minv, q, l, u, rho, x0, z0, y0, iters: int, sigma: float = 1e-6,
                    alpha: float = 1.6):
    """``iters`` dense-A ADMM iterations; returns (x, z, y)."""
    B, m, n = A.shape
    args = (A, Minv, q, l, u, rho, x0, z0, y0)
    shapes = [(B, m, n), (B, n, n), (B, n), (B, m), (B, m), (B, m), (B, n), (B, m), (B, m)]
    for name, t, s in zip("A Minv q l u rho x0 z0 y0".split(), args, shapes):
        if tuple(t.shape) != s:
            raise ValueError(f"admm_iterations: {name} has shape {tuple(t.shape)}, expected {s}")
        if t.dtype != torch.float32:
            raise TypeError(f"admm_iterations: {name} must be f32, got {t.dtype}")
        if t.device != A.device:
            raise ValueError("admm_iterations: all operands on one device")
    if A.device.type == "cpu":
        return admm_iterations_plain(*args, iters=iters, sigma=sigma, alpha=alpha)
    if A.device.type != "cuda":
        raise ValueError(f"admm_iterations runs on CPU or CUDA tensors, got {A.device}")
    if n % 4:
        args = _pad_dense(*args)
    x, z, y = _launch_dense(*[t.contiguous() for t in args], iters, sigma, alpha)
    admm_iterations.launches += 1
    return x[:, :n].contiguous(), z, y


admm_iterations.launches = 0
