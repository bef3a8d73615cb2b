"""The ADMM kernels: the hand-written CUDA kernels and their plain versions.

Two kernels each replace a Pallas TPU kernel of
``convex_mpc_tpu/mpc/kernels.py``:

- :func:`admm_iterations_structured` — the structured chunk of the
  production ``admm.solve_adaptive``. The CUDA kernel is
  ``csrc/admm_structured.cu`` (a thread-block cluster per scenario whose
  CTAs split it by friction blocks, each with its rows of Minv on chip for
  the whole chunk; at nz = 384 each CTA runs three scenarios side by side;
  design and bound in its header). The plain version is
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

Two more replace no TPU kernel: the production solve's per-chunk step,
which XLA fuses inside the JAX solve's ``while_loop``, as two launches of
``csrc/admm_adapt.cu`` (design and bound in its header):

- :func:`adapt_check` — after each chunk, the primal and dual residuals
  over their tolerances (A x and A' y in the block sums above, P x in the
  order :func:`px_tree` spells out), the step, and the convergence flags,
  with the count of open scenarios that the host reads;
- :func:`adapt_rho` — after the chunk's polish decision, the polish
  accept, the bounded rho descent, rescue and gate, with the counts of
  moved rho and of open scenarios that the host reads.

Each wrapper checks its operands and takes the plain version for CPU
tensors only; a CUDA tensor launches the kernel (``utils.cuda_build.launch``)
or raises. Each C launcher picks its launch from its own shared-memory
layout and raises where none fits the card: no other route is taken in its
place. :func:`structured_cluster_shape` and :func:`dense_cluster_shape` read
that choice back.
"""

from __future__ import annotations

import ctypes

import torch

from convex_mpc_tpu_torch._device import const
from convex_mpc_tpu_torch.utils import cuda_build
from convex_mpc_tpu_torch.utils.profiling import count


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def block_at(C, box_diag, w):
    """A' w of the block form in the kernels' pinned order: per column the
    4-term sum over its block's face rows in face order, the box term last."""
    B, nb = C.shape[0], C.shape[1]
    m_fr = 4 * nb
    wf = w[:, :m_fr].reshape(B, nb, 4)
    acc = C[:, :, 0, :] * wf[:, :, 0:1]
    for f in range(1, 4):
        acc = acc + C[:, :, f, :] * wf[:, :, f:f + 1]
    return acc.reshape(B, 3 * nb) + box_diag * w[:, m_fr:]


def block_a(C, box_diag, v):
    """A v of the block form in the kernels' pinned order: per face row the
    3-term sum over its block's columns in order; then the box rows."""
    B, nb = C.shape[0], C.shape[1]
    vr = v.reshape(B, nb, 3)
    acc = C[:, :, :, 0] * vr[:, :, 0:1]
    for r in range(1, 3):
        acc = acc + C[:, :, :, r] * vr[:, :, r:r + 1]
    return torch.cat([acc.reshape(B, 4 * nb), box_diag * v], dim=-1)


def admm_iterations_structured_plain(C, box_diag, Minv, q, l, u, rho_vec, x0, z0, y0,
                                     iters: int, sigma: float = 1e-6, alpha: float = 1.6):
    """``iters`` over-relaxed ADMM steps per scenario, plain PyTorch."""
    nz = C.shape[1] * 3
    np2 = _next_pow2(max(nz, 128))

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
        rhs = sigma * x - q + block_at(C, box_diag, rho_vec * z - y)
        xt = kkt_matvec(rhs)
        axt = block_a(C, box_diag, xt)
        x_new = alpha * xt + (1.0 - alpha) * x
        ax_rel = alpha * axt + (1.0 - alpha) * z
        z_new = torch.clamp(ax_rel + y / rho_vec, l, u)
        y = y + rho_vec * (ax_rel - z_new)
        x, z = x_new, z_new
    return x, z, y


def structured_cluster_shape(nb: int) -> tuple[int, int, int]:
    """The structured kernel's launch for nb friction blocks on the current
    card: (CTAs a cluster, clusters resident at once, slots: the scenarios a
    CTA runs side by side). One slot in the smallest cluster of at least 2
    CTAs whose share of Minv fits one CTA (2 at nb = 40 and 64), but at nb =
    96 one slot in clusters of 3 (two CTAs an SM) and at nb = 128 three
    slots in clusters of 8."""
    return cuda_build.query("admm_structured", "admm_structured_shape", (nb,), (ctypes.c_int,) * 3)


_STRUCTURED = cuda_build.Kernel("admm_iterations_structured", "admm_structured",
                                "admm_structured_f32", pointers=13, ints=3, floats=3)


def admm_iterations_structured(C, box_diag, Minv, q, l, u, rho_vec, x0, z0, y0,
                               iters: int, sigma: float = 1e-6, alpha: float = 1.6):
    """The structured ADMM chunk; returns (x, z, y). A launch that runs
    several scenarios in each CTA counts ``admm_slotted``."""
    B, nb = C.shape[0], C.shape[1]
    nz, m = 3 * nb, 7 * nb
    args = (C, box_diag, Minv, q, l, u, rho_vec, x0, z0, y0)
    vz, vm = (B, nz), (B, m)
    dev = cuda_build.operands(
        "admm_iterations_structured", C=(C, (B, nb, 4, 3)), box_diag=(box_diag, vz),
        Minv=(Minv, (B, nz, nz)), q=(q, vz), l=(l, vm), u=(u, vm), rho_vec=(rho_vec, vm),
        x0=(x0, vz), z0=(z0, vm), y0=(y0, vm))
    if dev.type == "cpu":
        return admm_iterations_structured_plain(*args, iters=iters, sigma=sigma, alpha=alpha)
    args = [t.contiguous() for t in args]
    out = tuple(torch.empty_like(t) for t in args[-3:])
    cuda_build.launch(_STRUCTURED, args + list(out), (B, nb, iters), (sigma, alpha, 1.0 - alpha))
    if cuda_build.query("admm_structured", "admm_structured_slots", (nb,), (ctypes.c_int,))[0] > 1:
        count("admm_slotted")
    return out


# ---------------------------------------------------------------------------
# the adaptive solve's per-chunk step (admm.solve_adaptive)
# ---------------------------------------------------------------------------
def px_tree(P, x):
    """P x per scenario in the adapt kernel's pinned order: row n's products
    P[n, c] x[c] over columns zero-padded to 128 KP (KP chunks of 128, a
    power of two), lane l of chunk k holding columns 128 k + 4 l .. + 3; the
    chunks halved (k + h into k), then in the lane (c0 + c1) + (c2 + c3),
    then across the 32 lanes by halving (the warp's shuffles)."""
    B, nz = x.shape
    kp = _next_pow2(-(-nz // 128))
    prod = torch.nn.functional.pad(P * x[:, None, :], (0, 128 * kp - nz))
    v = prod.reshape(B, nz, kp, 32, 4)
    k = kp
    while k > 1:
        h = k // 2
        v = v[:, :, :h] + v[:, :, h:k]
        k = h
    v = v[:, :, 0]
    s = (v[..., 0] + v[..., 1]) + (v[..., 2] + v[..., 3])
    for off in (16, 8, 4, 2, 1):
        s = s[..., :off] + s[..., off:2 * off]
    return s[..., 0]


def adapt_check_plain(P, C, box_diag, q, d, x, x_prev, z, y, rho, converged, conv_iter,
                      iters_done: int, eps_abs: float, eps_rel: float, rho_accept_max: float,
                      stall_tol: float, stall_dual_cap: float):
    """The residual and convergence check after a chunk, plain PyTorch.
    Returns (pr, dr, step, converged, conv_iter, open): the primal and dual
    residuals over their tolerances, the largest scaled step, the updated
    flags, and (1,) int32: the scenarios not converged."""
    ax = block_a(C, box_diag, x)
    aty = block_at(C, box_diag, y)
    px = px_tree(P, x)
    rp = torch.amax(torch.abs(ax - z), dim=-1)
    ep = eps_abs + eps_rel * torch.maximum(
        torch.amax(torch.abs(ax), dim=-1), torch.amax(torch.abs(z), dim=-1))
    rd = torch.amax(torch.abs(px + q + aty), dim=-1)
    ed = eps_abs + eps_rel * torch.maximum(
        torch.amax(torch.abs(px), dim=-1),
        torch.maximum(torch.amax(torch.abs(aty), dim=-1), torch.amax(torch.abs(q), dim=-1)))
    pr, dr = rp / ep, rd / ed
    step = torch.amax(torch.abs(d * (x - x_prev)), dim=-1)
    rho_ok = rho <= rho_accept_max
    stalled = rho_ok & (pr <= 1.0) & (dr <= stall_dual_cap) & (step <= stall_tol)
    newly = (rho_ok & (pr <= 1.0) & (dr <= 1.0)) | stalled
    conv_iter = torch.where(newly & (conv_iter < 0), iters_done, conv_iter).to(torch.int32)
    converged = converged | newly
    return pr, dr, step, converged, conv_iter, (~converged).sum(dtype=torch.int32).reshape(1)


def adapt_rho_plain(pr, dr, step, rho, converged, conv_iter, d_count, pol_ok, x, d, nu: int,
                    polish: bool, apply_polish: bool, at_boundary: bool, rescue: bool,
                    max_adapts: int, stall_tol: float, small_force_scale: float,
                    log_ratio: float, rho_accept_max: float):
    """The rho step after a chunk's polish decision, plain PyTorch: with
    ``polish``, a scenario's iterate counts as converged only where its step
    or its first-step forces are large enough (``apply_polish``: and its
    polish certified); then the bounded descent (``at_boundary``), the
    rescue (``rescue``) and the gate. Returns (rho_new, d_count, changed,
    converged, conv_iter, flags): flags (2,) int32, the scenarios whose rho
    moved and the scenarios not converged."""
    if polish:
        x_scale = torch.amax(torch.abs((d * x)[:, :nu]), dim=-1)
        step_ok = (step <= stall_tol) | (x_scale >= small_force_scale)
        if apply_polish:
            converged = converged & pol_ok & step_ok
        conv_iter = torch.where(converged, conv_iter, -1).to(torch.int32)
    can = ((~converged) & (d_count < max_adapts) if at_boundary
           else torch.zeros_like(converged))
    ratio = torch.sqrt(pr / torch.clamp(dr, min=1e-12))
    rho_desc = torch.clamp(rho * torch.clamp(ratio, 0.1, 1.0), 1e-6, 1e6)
    moved = torch.abs(torch.log(rho_desc / rho)) > log_ratio
    descend = can & moved
    d_count = d_count + descend.to(torch.int32)
    rho_new = torch.where(descend, rho_desc, rho)
    if rescue:
        rescue_rows = (~converged) & (rho <= rho_accept_max)
    else:
        rescue_rows = torch.zeros_like(converged)
    rho_new = torch.where(rescue_rows, 0.1, rho_new)
    d_count = torch.where(rescue_rows, 0, d_count).to(torch.int32)
    gate = (~converged) & (pr <= 1.0) & (dr <= 1.0) & ~(rho <= rho_accept_max)
    rho_new = torch.where(gate, torch.clamp(rho * 0.1, min=1e-4), rho_new)
    # each of the three moves rho; every other scenario keeps its rho bit for bit
    changed = descend | rescue_rows | gate
    flags = torch.stack([changed.sum(dtype=torch.int32), (~converged).sum(dtype=torch.int32)])
    return rho_new, d_count, changed, converged, conv_iter, flags


def _workspace(device) -> torch.Tensor:
    """The adapt kernels' counters (int32 zeros, per device): adapt_check's
    at 0, adapt_rho's at 4. Each launch leaves its part zero."""
    return const(("adapt_ws",), device, lambda d: torch.zeros(8, dtype=torch.int32, device=d))


_CHECK = cuda_build.Kernel("adapt_check", "admm_adapt", "adapt_check_f32", pointers=19, ints=3,
                          floats=5)
_RHO = cuda_build.Kernel("adapt_rho", "admm_adapt", "adapt_rho_f32", pointers=17, ints=8, floats=4)


def adapt_check(P, C, box_diag, q, d, x, x_prev, z, y, rho, converged, conv_iter,
                iters_done: int, eps_abs: float, eps_rel: float, rho_accept_max: float,
                stall_tol: float, stall_dual_cap: float):
    """The residual and convergence check after a chunk (see
    :func:`adapt_check_plain`); one kernel launch on the card, counted
    ``adapt_fused`` there."""
    B, nb = C.shape[0], C.shape[1]
    nz, m = 3 * nb, 7 * nb
    vz, vm, vb = (B, nz), (B, m), (B,)
    spec = dict(P=(P, (B, nz, nz)), C=(C, (B, nb, 4, 3)), box_diag=(box_diag, vz), q=(q, vz),
                d=(d, vz), x=(x, vz), x_prev=(x_prev, vz), z=(z, vm), y=(y, vm), rho=(rho, vb),
                converged=(converged, vb, torch.bool), conv_iter=(conv_iter, vb, torch.int32))
    dev = cuda_build.operands("adapt_check", **spec)
    ops = [t for t, *_ in spec.values()]
    consts = (eps_abs, eps_rel, rho_accept_max, stall_tol, stall_dual_cap)
    if dev.type == "cpu":
        return adapt_check_plain(*ops, iters_done, *consts)
    pr, dr, step = torch.empty((3, B), dtype=torch.float32, device=dev)
    conv_out = torch.empty_like(converged)
    ints = torch.empty((B + 1,), dtype=torch.int32, device=dev)  # conv_iter, then the open count
    it_out, n_open = ints[:B], ints[B:]
    cuda_build.launch(_CHECK, [t.contiguous() for t in ops] + [
        pr, dr, step, conv_out, it_out, _workspace(dev), n_open], (B, nb, iters_done), consts)
    count("adapt_fused")
    return pr, dr, step, conv_out, it_out, n_open


def adapt_rho(pr, dr, step, rho, converged, conv_iter, d_count, pol_ok, x, d, nu: int,
              polish: bool, apply_polish: bool, at_boundary: bool, rescue: bool,
              max_adapts: int, stall_tol: float, small_force_scale: float, log_ratio: float,
              rho_accept_max: float):
    """The rho step after a chunk's polish decision (see
    :func:`adapt_rho_plain`); one kernel launch on the card."""
    B, nz = x.shape
    vb = (B,)
    spec = dict(pr=(pr, vb), dr=(dr, vb), step=(step, vb), rho=(rho, vb), x=(x, (B, nz)),
                d=(d, (B, nz)), converged=(converged, vb, torch.bool),
                pol_ok=(pol_ok, vb, torch.bool), conv_iter=(conv_iter, vb, torch.int32),
                d_count=(d_count, vb, torch.int32))
    dev = cuda_build.operands("adapt_rho", **spec)
    if not 0 <= nu <= nz:
        raise ValueError(f"adapt_rho: nu = {nu} outside 0..{nz}")
    host = (nu, polish, apply_polish, at_boundary, rescue, max_adapts)
    consts = (stall_tol, small_force_scale, log_ratio, rho_accept_max)
    if dev.type == "cpu":
        return adapt_rho_plain(pr, dr, step, rho, converged, conv_iter, d_count, pol_ok, x, d,
                               *host, *consts)
    rho_out = torch.empty((B,), dtype=torch.float32, device=dev)
    dc_out, it_out = torch.empty((2, B), dtype=torch.int32, device=dev)
    conv_out, changed = torch.empty((2, B), dtype=torch.bool, device=dev)
    flags = torch.empty((2,), dtype=torch.int32, device=dev)
    cuda_build.launch(_RHO, [t.contiguous() for t, *_ in spec.values()] + [
        rho_out, dc_out, it_out, conv_out, changed, _workspace(dev)[4:], flags], (B, nz, *host),
        consts)
    return rho_out, dc_out, changed, conv_out, it_out, flags


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
    return cuda_build.query("admm_dense", "admm_dense_shape", (m, n), (ctypes.c_int,) * 4)


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


_DENSE = cuda_build.Kernel("admm_iterations", "admm_dense", "admm_dense_f32", pointers=12, ints=4,
                           floats=3)


def admm_iterations(A, Minv, q, l, u, rho, x0, z0, y0, iters: int, sigma: float = 1e-6,
                    alpha: float = 1.6):
    """``iters`` dense-A ADMM iterations; returns (x, z, y)."""
    B, m, n = A.shape
    args = (A, Minv, q, l, u, rho, x0, z0, y0)
    vn, vm = (B, n), (B, m)
    dev = cuda_build.operands(
        "admm_iterations", A=(A, (B, m, n)), Minv=(Minv, (B, n, n)), q=(q, vn), l=(l, vm),
        u=(u, vm), rho=(rho, vm), x0=(x0, vn), z0=(z0, vm), y0=(y0, vm))
    if dev.type == "cpu":
        return admm_iterations_plain(*args, iters=iters, sigma=sigma, alpha=alpha)
    if n % 4:
        args = _pad_dense(*args)
    args = [t.contiguous() for t in args]
    if args[0].data_ptr() % 16 or args[1].data_ptr() % 16:
        raise ValueError("admm_iterations kernel: A and Minv must be 16-byte aligned (the "
                         "kernel's float4 loads)")
    x, z, y = (torch.empty_like(t) for t in args[-3:])
    cuda_build.launch(_DENSE, args + [x, z, y], (B, m, args[0].shape[-1], iters),
                      (sigma, alpha, 1.0 - alpha), what=f"admm_iterations at A ({m}, {n})")
    return x[:, :n].contiguous(), z, y
