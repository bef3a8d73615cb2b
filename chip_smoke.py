"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. card identity (``nvidia-smi`` name and power limit);
2. build the four CUDA kernels from ``convex_mpc_tpu_torch/csrc`` (one
   ``nvcc`` per source, started together);
3. each kernel against its plain PyTorch version on the card at its path's
   shapes, with CUDA-event times of the kernel, the plain version and a
   yardstick the port never calls: ``spd_inverse`` at B = 512 on random SPD
   batches at n = 192, 288 and 384 (horizons 16, 24, 32; where its working
   set lives and its CTAs per SM, at least 2 at n = 192; one matrix of each
   made non-SPD at its first pivot and one at its last panel must come back
   all NaN) and on the solver's KKT matrix at
   attractor-region rho (1e-4), and at the rho the solver and its warm
   carry reach below it (1e-5 and 1e-6: error and residual against the f64
   inverse at most twice the plain version's, as at 1e-4); the structured
   ADMM chunk at B = 512,
   nb = 64, 96 and 128, bitwise equal to its plain version after 25 and 150
   iterations; the fused tick window (its launch shape printed) at B = 512
   for 20 ticks (5e-3 per channel) and one tick (2e-4), at ragged B = 5,
   13 and 517 (one block per scenario, so no block is partly filled) and at
   B = 512 on a duty = 1 gait and on a heterogeneous battery (each
   scenario's gait from ``scenarios.gait_sweep``, 16 frequencies x 32
   duties, and its contact from ``scenarios.friction_randomization``)
   (no leg swings; at most ``MAX_FLIPS`` scenarios that took another
   contact branch within ``FLIP_MARGIN`` of its threshold are excused from
   the bar), with the eager ``engine._run_ticks`` window as its yardstick;
   the dense ADMM
   iterations at B = 512, A (448, 192) (the condensed QP; rtol and atol
   2e-4) and A (640, 384) (the full form's QP of the main path's start
   batch; against the f64 iterations, within twice the plain version's
   error: ``dense_f64_errors``; beside it, how many entries the plain
   version with its sums reordered, ``permuted_plain``, has outside rtol
   and atol 2e-4), for 25 and 50 iterations in clusters of 8 CTAs, each
   shape's shared bytes and resident clusters printed, and A (960, 576)
   (the full form at horizon 24) must raise. Before them, each kernel's
   ``ptxas -v`` lines; every kernel must show no stack frame and no
   spills;
4. the main path: ``mpc_cycle_batch`` with ``engine_kwargs_batched(
   DEFAULT_CONFIG)`` at B = 512, horizon 16 from the start state of the JAX
   package's ``bench.py``; 16 settle cycles, then one timed 16-cycle window,
   and the same window from the same state with ``use_fused_ticks=True``,
   each with the kernels' launch counters set to 0 just before it and read
   just after; then B = 8 cycles on the card and on the CPU (plain
   versions), whose applied forces must agree within 2.0 N, unfused (one
   cycle) and fused (two cycles);
5. the legacy path: ``mpc_cycle_fixed`` at B = 512 with
   ``solver_iters=150`` (``bench.py``'s curve point) for a short window, its
   counters set to 0 just before it; then one B = 8 cycle on the card and on
   the CPU within 2.0 N;
6. horizons 24 and 32: ``mpc_cycle_batch`` at B = 512 with
   ``mpc_dt`` = gait period / horizon, 4 settle cycles and a 4-cycle
   window with the counters set to 0 just before it (both solve kernels
   must launch), then one B = 8 cycle on the card and on the CPU within
   2.0 N;
7. the full QP form: ``mpc_cycle_fixed(formulation="full",
   solver_iters=150)`` at B = 512 for a 4-cycle window, its counters set
   to 0 (kernel 4 must launch, on A (640, 384)), then one B = 8 cycle on
   the card and on the CPU within 2.0 N;
8. the scenario batches through ``scenarios.simulate_batch``
   (``SCENARIO_BATCHES``): ``velocity_sweep`` at B = 1,024 on the legacy
   path (300 iterations), ``friction_randomization`` at B = 512 on the
   production path with the fused tick window, ``gait_sweep`` (16 x 32) at
   B = 512 on the production path; settle cycles, then a timed window with
   the counters set to 0 (finite, 0.1 < z < 0.6, each kernel of its path
   launched), then one B = 8 cycle on the card and on the CPU within 2.0 N;
9. scale-out (``parallel/mesh.py``) on one NCCL rank (NCCL refuses two
   ranks on one card): ``init_distributed`` on ``nccl``, world size 1, a
   free localhost port; ``shard_batch`` of phase 4's settled B = 512 batch
   must equal it; one ``sharded_rollout_fn`` step of ``mpc_cycle_batch``,
   its counters set to 0 just before it (both solve kernels must launch),
   must equal the unsharded step bitwise, and its all-reduced mean height
   the local mean; then ``dryrun(mesh)``;
10. measurement: ``tools/torch_bench.py`` at B = 512 with one window per
   configuration (its JSON line printed; each configuration's kernels
   launched in its windows); ``tools/torch_realtime_latency.py``'s B = 1
   cycle over one 16-cycle window with eager and with fused ticks, the
   counters set to 0 just before each; ``utils.profiling.trace`` around
   one fused B = 512 cycle and its device-busy share (the trace is written
   under ``build/`` and deleted); ``profiling.time_fn`` of one kernel-2
   chunk within 20% of ``cuda_ms``; phase 4's settled state through
   ``utils.checkpoint`` (saved under ``build/``), bitwise equal when loaded,
   and one cycle from it bitwise equal to one from the original;
11. force parity against the native f64 oracle (``native/qp_solver.cpp``,
   built with ``g++``, whose version line is printed; a missing compiler
   fails the run), each entry point run as a subprocess on the card, its
   exit code and its own launch counts checked (its kernels must launch):
   ``tools/torch_parity_sweep.py --n 50`` (kernel 4; at most
   ``SWEEP_MAX_OVER`` instances over 2%, the JAX tool's own count on the
   same instances), ``tools/torch_loop_parity.py --adaptive --seconds 2``
   (100 cycles at B = 1, kernels 1 and 2; no cycle over 2%) and
   ``examples/torch_trot_demo.py --schedule const --vx 0.5 --seconds 2``
   (its final vx and z within ``DEMO_VX_BAND`` and ``DEMO_Z_BAND``); the
   phase's time is printed.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports no JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
import subprocess
import sys
import time
import traceback
from collections import namedtuple
from pathlib import Path

import numpy as np
import torch

B_MAIN = 512
HORIZON = 16
SETTLE = 16
WINDOW = 16
B_SMALL = 8
FIXED_WINDOW = 4
FIXED_ITERS = 150
HORIZONS = (24, 32)
H_SETTLE = 4
H_WINDOW = 4

# the tick window's comparison may excuse at most MAX_FLIPS scenarios that took
# another contact branch, each only if it flipped within FLIP_MARGIN (m) of the
# threshold (f32 foot heights of ~0.3 m round at ~3e-8 m)
MAX_FLIPS = 4
FLIP_MARGIN = 1e-5

# NVIDIA H100 SXM data-sheet peaks (dense, full 700 W power limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms from CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def host_identity() -> str:
    """The host's CPU model and core count, and a hash of the port's sources
    beside this script, so that runs on different hosts or trees are told apart."""
    model = f"{platform.machine()} CPU, model not reported"
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        model = next(l.split(":", 1)[1].strip() for l in out.splitlines()
                     if l.startswith("Model name"))
    except (OSError, subprocess.SubprocessError, StopIteration):
        pass
    here = Path(__file__).resolve().parent
    h = hashlib.sha256()
    for p in sorted([here / "chip_smoke.py", *(here / "convex_mpc_tpu_torch").rglob("*")]):
        if p.is_file() and p.suffix in (".py", ".cu"):
            h.update(p.relative_to(here).as_posix().encode() + p.read_bytes())
    return f"host {model} x {os.cpu_count()} cores; sources sha256 {h.hexdigest()[:16]}"


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    line = out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    if out.returncode != 0 or not line:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return line


# ---------------------------------------------------------------------------
# phase 3 helpers
# ---------------------------------------------------------------------------
def structured_problem(B: int, nb: int, seed: int, dev):
    """A convergent structured ADMM problem (friction-pyramid blocks, the
    true KKT inverse) made from a numpy seed, as in tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    nz, m_fr = nb * 3, nb * 4
    m = m_fr + nz
    base = np.array([[1, 0, 0.8], [-1, 0, 0.8], [0, 1, 0.8], [0, -1, 0.8]], np.float32)
    C = (np.broadcast_to(base, (B, nb, 4, 3))
         + 0.05 * rng.standard_normal((B, nb, 4, 3))).astype(np.float32)
    box = (1.0 + 0.2 * rng.standard_normal((B, nz))).astype(np.float32)
    Pm = (0.05 * rng.standard_normal((B, nz, nz))).astype(np.float32)
    rho = (0.1 * (1.0 + 0.5 * rng.random((B, m)))).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)
    C_t, box_t, Pm_t, rho_t = t(C), t(box), t(Pm), t(rho)
    Pm_t = Pm_t @ Pm_t.transpose(1, 2) + torch.eye(nz, device=dev)
    A = torch.zeros((B, m, nz), dtype=torch.float64, device=dev)
    for k in range(nb):
        A[:, 4 * k:4 * k + 4, 3 * k:3 * k + 3] = C_t[:, k].double()
    A[:, m_fr:, :] = torch.diag_embed(box_t.double())
    K = (Pm_t.double() + 1e-6 * torch.eye(nz, dtype=torch.float64, device=dev)
         + torch.einsum("bmn,bm,bmk->bnk", A, rho_t.double(), A))
    Minv = torch.cholesky_inverse(torch.linalg.cholesky(K)).float()
    q = t(rng.standard_normal((B, nz)).astype(np.float32))
    l = torch.full((B, m), -float("inf"), device=dev)
    l[:, m_fr:] = -2.0
    u = torch.full((B, m), 5.0, device=dev)
    x = t((0.1 * rng.standard_normal((B, nz))).astype(np.float32))
    z = torch.clamp(t((0.1 * rng.standard_normal((B, m))).astype(np.float32)), l, u)
    y = t((0.1 * rng.standard_normal((B, m))).astype(np.float32))
    return [a.contiguous() for a in (C_t, box_t, Minv, q, l, u, rho_t, x, z, y)]


def admm_chunk_bmm(C, box, Minv, q, l, u, rho, x, z, y, iters, sigma=1e-6, alpha=1.6):
    """Library yardstick: the same chunk with the KKT matvec as torch.bmm and
    the block matvecs as einsums (timed only; the port never calls it)."""
    B, nb = C.shape[0], C.shape[1]
    nz, m_fr = 3 * nb, 4 * nb
    for _ in range(iters):
        w = rho * z - y
        at = torch.einsum("bnfr,bnf->bnr", C, w[:, :m_fr].reshape(B, nb, 4)).reshape(B, nz)
        rhs = sigma * x - q + at + box * w[:, m_fr:]
        xt = torch.bmm(Minv, rhs[:, :, None])[:, :, 0]
        axt = torch.cat([torch.einsum("bnfr,bnr->bnf", C, xt.reshape(B, nb, 3)).reshape(B, m_fr),
                         box * xt], dim=-1)
        x_new = alpha * xt + (1.0 - alpha) * x
        ax_rel = alpha * axt + (1.0 - alpha) * z
        z_new = torch.clamp(ax_rel + y / rho, l, u)
        y = y + rho * (ax_rel - z_new)
        x, z = x_new, z_new
    return x, z, y


def spd_batch(B: int, n: int, seed: int, dev) -> torch.Tensor:
    """A random SPD batch, M M' / n + 3 I, from a numpy seed."""
    rng = np.random.default_rng(seed)
    M = torch.as_tensor(rng.normal(size=(B, n, n)).astype(np.float32), device=dev)
    return M @ M.transpose(1, 2) / n + 3.0 * torch.eye(n, device=dev)


def spd_times(A: torch.Tensor) -> tuple:
    """(kernel, plain, library, bound ms, bound_by) of spd_inverse on A."""
    from convex_mpc_tpu_torch.ops.chol_kernel import spd_inverse, spd_inverse_plain

    B, n = A.shape[0], A.shape[1]
    ms = cuda_ms(lambda: spd_inverse(A))
    plain_ms = cuda_ms(lambda: spd_inverse_plain(A))

    def library():
        L, _ = torch.linalg.cholesky_ex(A)
        return torch.cholesky_inverse(L)

    lib_ms = cuda_ms(library)
    # least work: Cholesky n^3/3 + triangular inverse n^3/3 + symmetric Gram
    # n^3/3 flops per matrix (LAPACK potrf + potri); bytes: A in, inverse out
    b_ms, b_by = bound(2 * B * n * n * 4, B * n ** 3)
    print(f"spd_inverse times B={B} n={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return ms, plain_ms, lib_ms, b_ms, b_by


def spd_nonspd(A: torch.Tensor, first: int, last: int) -> None:
    """Make two matrices of an SPD batch non-SPD in place: ``first`` fails at
    its first pivot (A - 4 I), ``last`` only in its last 16 x 16 panel (a
    rank-1 term confined to its last 16 rows and columns)."""
    n = A.shape[-1]
    A[first] -= 4.0 * torch.eye(n, device=A.device)
    A[last, n - 16:, n - 16:] -= 50.0


def check_spd_random(n: int, dev) -> float:
    """spd_inverse against its plain version on a random SPD batch of size n
    at B_MAIN, two matrices of it made non-SPD (``spd_nonspd``: their outputs
    must be all NaN, the others finite). Prints where the kernel keeps its
    working set and its CTAs per SM (at least 2 at n = 192). Returns
    max|kernel - plain| over the SPD matrices."""
    from convex_mpc_tpu_torch.ops.chol_kernel import spd_inverse, spd_inverse_plain, spd_inverse_shape

    smem, scratch, ctas = spd_inverse_shape(n)
    where = (f"on chip, {smem} B of shared memory" if smem else
             f"in device memory, {scratch} floats of scratch per matrix")
    print(f"spd_inverse n={n}: working set {where}; {ctas} CTAs resident per SM")
    if n == 192 and ctas < 2:
        fail(f"spd_inverse at n=192 keeps {ctas} CTA per SM, not at least 2")
    B, bad = B_MAIN, (5, B_MAIN - 3)
    A = spd_batch(B, n, 7, dev)
    spd_nonspd(A, *bad)
    out = spd_inverse(A)
    torch.cuda.synchronize()
    ref = spd_inverse_plain(A)
    keep = torch.ones(B, dtype=torch.bool, device=dev)
    keep[list(bad)] = False
    nan_ok = bool(torch.isnan(out[~keep]).all() and torch.isfinite(out[keep]).all()
                  and torch.isnan(ref[~keep]).all())
    o, r = out[keep], ref[keep]
    err = (o - r).abs().max().item()
    scale = r.abs().max().item()
    resid = (A[keep] @ o - torch.eye(n, device=dev)).abs().max().item()
    print(f"spd_inverse random SPD B={B} n={n}: "
          f"max|k-plain|={err:.3e} (bar {5e-5 * scale:.3e}) |A out - I|={resid:.3e} (bar 1e-4) "
          f"bitwise={torch.equal(o, r)}; non-SPD matrices (first pivot, last panel) all NaN, "
          f"the others finite: {nan_ok}")
    if not (err <= 5e-5 * scale and resid < 1e-4 and nan_ok):
        fail(f"spd_inverse disagrees with its plain version on the random batch at n={n}")
    return err


def spd_kkt_errors(kkt: torch.Tensor) -> dict:
    """spd_inverse (the kernel) and its plain version on ``kkt`` against the
    f64 inverse: max errors (``e_kernel``, ``e_plain``) and residuals
    |K out - I| (``r_kernel``, ``r_plain``), the f64 inverse's largest entry
    ``kscale``, max|kernel - plain| ``kerr`` beside the plain version's
    largest entry ``pscale``, and ``within_bar``: the kernel finite with
    error and residual at most twice the plain version's."""
    from convex_mpc_tpu_torch.ops.chol_kernel import spd_inverse, spd_inverse_plain

    out_k = spd_inverse(kkt)
    torch.cuda.synchronize()
    ref_k = spd_inverse_plain(kkt)
    K64 = kkt.double()
    truth = torch.cholesky_inverse(torch.linalg.cholesky(K64))
    eye64 = torch.eye(kkt.shape[-1], dtype=torch.float64, device=kkt.device)
    k = dict(kscale=truth.abs().max().item(),
             e_kernel=(out_k.double() - truth).abs().max().item(),
             e_plain=(ref_k.double() - truth).abs().max().item(),
             r_kernel=(K64 @ out_k.double() - eye64).abs().max().item(),
             r_plain=(K64 @ ref_k.double() - eye64).abs().max().item(),
             kerr=(out_k - ref_k).abs().max().item(), pscale=ref_k.abs().max().item(),
             bitwise=torch.equal(out_k, ref_k))
    k["within_bar"] = bool(torch.isfinite(out_k).all()
                           and k["e_kernel"] <= 2 * k["e_plain"] + 1e-5 * k["kscale"]
                           and k["r_kernel"] <= 2 * k["r_plain"] + 1e-5)
    return k


def check_spd_inverse(kkt: torch.Tensor) -> dict:
    dev = kkt.device
    n = 192
    # horizons 24 and 32 (n = 288 on chip, 384 in device memory)
    err = max(check_spd_random(nn, dev) for nn in (192, 288, 384))
    for nn in (288, 384):
        spd_times(spd_batch(B_MAIN, nn, 7, dev))

    # the solver's KKT at attractor-region rho: cond ~1e4, so the bar is
    # relative to the f64 inverse (within twice the plain version's error)
    k = spd_kkt_errors(kkt)
    print(f"spd_inverse KKT rho=1e-4 B={B_MAIN}: max|k-plain|={k['kerr']:.3e} "
          f"(= {k['kerr'] / k['kscale']:.2e} x scale) "
          f"|k-f64|={k['e_kernel'] / k['kscale']:.2e} x scale vs plain "
          f"{k['e_plain'] / k['kscale']:.2e}; "
          f"|A out - I| kernel {k['r_kernel']:.3e} plain {k['r_plain']:.3e}; bitwise={k['bitwise']}")
    # the random-SPD bar, reported but not required here: on this cond ~1e4
    # matrix the plain version is itself farther than that from the f64 inverse
    met = k["kerr"] <= 5e-5 * k["pscale"] and k["r_kernel"] < 1e-4
    print(f"spd_inverse KKT against the random-SPD bar (|k-plain| <= 5e-5 x scale = "
          f"{5e-5 * k['pscale']:.3e}, |A out - I| < 1e-4): {'met' if met else 'NOT met'}")
    if not k["within_bar"]:
        fail("spd_inverse on the attractor-rho KKT is less accurate than twice the plain version")

    # below the attractor region: the solver lets rho fall to 1e-6, its warm
    # carry keeps it down to 1e-5; the same bar
    for rho in (1e-5, 1e-6):
        k = spd_kkt_errors(attractor_kkt(dev, rho))
        print(f"spd_inverse KKT rho={rho:g} B={B_MAIN}: |k-f64| = "
              f"{k['e_kernel'] / k['kscale']:.2e} x scale vs plain "
              f"{k['e_plain'] / k['kscale']:.2e} (bar twice the plain + 1e-5 x scale); "
              f"|A out - I| kernel {k['r_kernel']:.3e} plain {k['r_plain']:.3e} (bar twice the "
              f"plain + 1e-5); max|k-plain| {k['kerr']:.3e}; within bar: {k['within_bar']}")
        if not k["within_bar"]:
            fail(f"spd_inverse on the KKT at rho={rho:g} is less accurate than twice the plain "
                 f"version")

    # the main path's size (horizon 16) for the kernel table
    ms, plain_ms, lib_ms, b_ms, b_by = spd_times(spd_batch(B_MAIN, n, 7, dev))
    return dict(name="spd_inverse", route="cuda",
                source="convex_mpc_tpu_torch/csrc/spd_inverse.cu",
                replaces="convex_mpc_tpu/ops/chol_kernel.py:227",
                max_abs_err=max(err, k["kerr"]), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def check_admm_chunk(dev) -> dict:
    """The structured chunk at B_MAIN for nb = 64, 96, 128 (horizons 16, 24,
    32): bitwise equal to its plain version after 25 and 150 iterations, and
    its times per 25 iterations. Returns the kernel-table row of nb = 64."""
    from convex_mpc_tpu_torch.mpc.kernels import (
        admm_iterations_structured, admm_iterations_structured_plain, structured_cluster_shape)

    B, worst, row = B_MAIN, 0.0, None
    for nb in (64, 96, 128):
        args = structured_problem(B, nb, seed=11, dev=dev)
        csize, resident = structured_cluster_shape(nb)
        print(f"admm_iterations_structured nb={nb}: clusters of {csize} CTAs, {resident} "
              f"resident at once, {B / resident:.2f} waves at B={B}")
        for iters in (25, 150):
            out = admm_iterations_structured(*args, iters=iters)
            torch.cuda.synchronize()
            ref = admm_iterations_structured_plain(*args, iters=iters)
            errs = [(a - b).abs().max().item() for a, b in zip(out, ref)]
            bitwise = all(torch.equal(a, b) for a, b in zip(out, ref))
            print(f"admm_iterations_structured B={B} nb={nb} iters={iters}: max|k-plain| "
                  f"x/z/y = {errs} bitwise={bitwise}")
            if not (bitwise and all(torch.isfinite(a).all() for a in out)):
                fail(f"admm_iterations_structured is not bitwise equal to its plain version "
                     f"(nb={nb}, {iters} iterations)")
            worst = max(worst, *errs)

        iters = 25  # check_every on the main path
        ms = cuda_ms(lambda: admm_iterations_structured(*args, iters=iters))
        plain_ms = cuda_ms(lambda: admm_iterations_structured_plain(*args, iters=iters), reps=3)
        lib_ms = cuda_ms(lambda: admm_chunk_bmm(*args, iters=iters), reps=3)
        nz, m = 3 * nb, 7 * nb
        in_bytes = 4 * B * (12 * nb + nz * nz + 3 * nz + 5 * m)
        out_bytes = 4 * B * (nz + 2 * m)
        # per iteration: KKT matvec 2 nz^2, A'w 10 nz, Av 6 m_fr + nz, updates ~12 m
        flops = B * iters * (2 * nz * nz + 10 * nz + 6 * 4 * nb + nz + 12 * m)
        b_ms, b_by = bound(in_bytes + out_bytes, flops)
        print(f"admm_iterations_structured times B={B} nb={nb} (25 iters): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        if nb == 64:  # the main path's size (horizon 16) for the kernel table
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        del args
    return dict(name="admm_iterations_structured", route="cuda",
                source="convex_mpc_tpu_torch/csrc/admm_structured.cu",
                replaces="convex_mpc_tpu/mpc/kernels.py:456", max_abs_err=worst, **row)


TickTraj = namedtuple("TickTraj", ["pos_des_world", "vel_des_world"])


def tick_battery(B: int, seed: int, dev, duty: float = 0.6):
    """``run_ticks_fused``'s arguments for a random mid-gait batch covering
    swing/stance edges and contact (tests/test_tick_fused.py's battery, built
    in torch from the same numpy draws); ``duty`` = 1 gives a gait in which
    no leg swings (zero swing time)."""
    from convex_mpc_tpu_torch.control import gait as G
    from convex_mpc_tpu_torch.control import leg as L
    from convex_mpc_tpu_torch.control import reference as R
    from convex_mpc_tpu_torch.models import dynamics as D
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.sim import physics as P

    rng = np.random.default_rng(seed)
    dyn = D.build_dyn(device=dev)
    contact = P.default_contact(device=dev)
    gait = G.make_gait_params(3.0, duty, device=dev)
    q = np.tile(P.init_plant(dyn, contact=contact).q.cpu().numpy(), (B, 1))
    q[:, 0:2] += rng.normal(0, 0.02, (B, 2))
    q[:, 2] += rng.normal(0, 0.01, B)
    q[:, 7:] += rng.normal(0, 0.05, (B, 12))
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    plant = P.PlantState(q=f(q), dq=f(rng.normal(0, 0.2, (B, 18))))
    leg = L.LegControlState(
        last_mask=torch.as_tensor(rng.integers(0, 3, (B, 4)), dtype=torch.int32, device=dev),
        takeoff_time=f(rng.uniform(0, 0.05, (B, 4))),
        swing_p0=f(rng.normal(0, 0.01, (B, 4, 3)) + np.array([0.2, 0.15, 0.02])),
        swing_td=f(rng.normal(0, 0.01, (B, 4, 3)) + np.array([0.25, 0.15, 0.02])),
    )
    u0 = f(rng.normal(0, 5, (B, 4, 3)) + np.array([0, 0, 40.0]))
    cmd = R.BodyCommand(vx=f(np.full(B, 0.5)), vy=f(np.zeros(B)), z_pos=f(np.full(B, 0.27)),
                        yaw_rate=f(rng.normal(0, 0.5, B)))
    traj = TickTraj(pos_des_world=f(q[:, 0:3] + np.array([0.02, 0, 0])),
                    vel_des_world=f(np.tile([0.5, 0, 0.0], (B, 1))))
    return (dyn, E.broadcast_batch(gait, B), E.broadcast_batch(contact, B), cmd, traj, u0,
            plant, leg, f(rng.normal(0, 0.1, B)), f(rng.normal(0, 0.1, B)),
            f(rng.normal(0, 0.1, (B, 6))), f(rng.uniform(0.1, 0.4, B)))


def hetero_battery(seed: int, dev):
    """``tick_battery(B_MAIN, seed)`` with every scenario's gait and contact
    its own: the gait of ``scenarios.gait_sweep`` over 16 frequencies in
    2.5-3.5 Hz x 32 duties in 0.5-0.7 and the contact of
    ``scenarios.friction_randomization`` (mu, kn per scenario)."""
    from convex_mpc_tpu_torch.sim import scenarios as S

    args = tick_battery(B_MAIN, seed, dev)
    gait = S.gait_sweep(args[0], freqs=np.linspace(2.5, 3.5, 16),
                        duties=np.linspace(0.5, 0.7, 32)).gait
    contact = S.friction_randomization(args[0], B_MAIN).contact
    return (args[0], gait, contact) + args[3:]


def _window_fields(res) -> dict:
    (plant, leg, yc, yp, vf, t), ticks = res
    d = {"q": plant.q, "dq": plant.dq, "yaw_cont": yc, "yaw_prev": yp, "vel_filt": vf, "t": t}
    d.update({f"leg.{k}": v for k, v in zip(leg._fields, leg)})
    d.update({f"ticks.{k}": v for k, v in zip(ticks._fields, ticks)})
    return d


def window_misses(out, ref, rel: float):
    """Per-scenario misses of a tick window against a reference: floats
    beyond ``rel`` x the per-channel scale (max |ref| over batch and time,
    per trailing component), integers unequal. Returns (miss (B,) bool,
    {field: worst error over scale, or count of unequal integer entries},
    max absolute float error)."""
    o, r = _window_fields(out), _window_fields(ref)
    B = r["q"].shape[0]
    miss = torch.zeros(B, dtype=torch.bool, device=r["q"].device)
    worst, max_abs = {}, 0.0
    for k, d in r.items():
        a = o[k]
        if not d.is_floating_point():
            bad = (a != d).reshape(B, -1)
            worst[k] = int(bad.sum())
            miss |= bad.any(-1)
            continue
        d64, a64 = d.double(), a.double()
        if d.ndim > 1:
            scale = d64.abs().reshape(-1, d.shape[-1]).amax(0) + 1e-6
        else:
            scale = d64.abs().amax() + 1e-6
        diff = (a64 - d64).abs()
        err = (diff / scale).reshape(B, -1)
        worst[k] = float(err.nan_to_num(float("inf")).max())
        max_abs = max(max_abs, float(diff.nan_to_num(float("inf")).max()))
        miss |= ~(err <= rel).all(-1)
    return miss, worst, max_abs


def contact_branches(res, contact):
    """Per-tick contact branch flags from a window's logs: the plant's
    ``active`` (penetration > 0) and the controller's ``touching``, with
    the signed margins of each test, (B, steps, 4)."""
    from convex_mpc_tpu_torch.control import leg as L

    foot_z = res[1].foot_pos_now[..., 2]
    pen = contact.ground_z[:, None, None] - (foot_z - contact.foot_radius[:, None, None])
    touch = (L.GROUND_Z + 1e-3) - (foot_z - L.FOOT_RADIUS)
    return pen > 0.0, touch >= 0.0, pen, touch


def rounding_flips(out, ref, contact):
    """Scenarios whose contact branches (``active``, ``touching``) differ
    between two windows, and which of them flipped within rounding: at the
    first tick where the flags differ, every flipped test's margin is under
    ``FLIP_MARGIN`` in both windows. Returns (excused (B,) bool, {scenario:
    that margin in m})."""
    a_k, t_k, pen_k, touch_k = contact_branches(out, contact)
    a_p, t_p, pen_p, touch_p = contact_branches(ref, contact)
    # the larger of the two windows' |margin| on each flipped test, 0 elsewhere
    margin = torch.maximum(
        torch.where(a_k != a_p, torch.maximum(pen_k.abs(), pen_p.abs()), 0.0),
        torch.where(t_k != t_p, torch.maximum(touch_k.abs(), touch_p.abs()), 0.0))
    flips = ((a_k != a_p) | (t_k != t_p)).any(-1)  # (B, steps)
    excused = torch.zeros(flips.shape[0], dtype=torch.bool, device=flips.device)
    margins = {}
    for b in flips.any(-1).nonzero()[:, 0].tolist():
        first = int(flips[b].nonzero()[0, 0])
        margins[b] = float(margin[b, first].max())
        excused[b] = margins[b] < FLIP_MARGIN
    return excused, margins


# Operations of tick_window.cu, worked out from its arithmetic with structural
# zeros and constant ones left out. A mul, add, sub, division, sqrt or
# transcendental (sinf, cosf, atan2f, fmodf) counts 1, an FMA 2; compares,
# selects, min/max and negation count 0. Helpers: a 3x3 product 45, a 3x3
# matvec 15, a cross product 9, the adjugate 3x3 inverse 41, quat_to_R 36,
# quat_mul 28; on the forward-mode Dual (value, derivative) an add is 2, a
# Dual x Dual product 4 and a Dual x float product 2.
TICK_OPS = {
    # every scenario-tick, 14,824: the model<Dual> 12,246 (quat_to_R 75,
    # R v and R w 60, trunk 388, four legs 4 x 2,885 = FK chain 300 + three
    # bodies 2,174 + foot 312 + B/Br blocks 99, mass and bias assembly 183);
    # attitude and yaw unwrap 13; qdot 39; velocity filter 33; phase clock
    # and yaw sin/cos 3; per leg 111 (gait mask 3, touching 1, penetration 2,
    # implicit-step right side 102, joint diagonal 3); body right side 75;
    # arrow factor of the implicit matrix 1,455; arrow solve 414; integration 102
    "tick": 14824,
    # per leg in swing: min-jerk and bump trajectory 69, s_phase 1, the
    # operational-space inertia (J M^-1 J')^-1 653, feedforward and torque 54
    "swing_leg": 777,
    # per scenario-tick with a leg in swing: the arrow factor of M behind the
    # operational-space inertia
    "swing_tick": 1452,
    "stance_leg": 15,   # per stance leg: tau = -Q' u0
    "early_leg": 30,    # per swing leg touching the ground: the early-contact force
    # per leg in contact: normal and friction coefficients 9, J' f0 13, the
    # dt J' C J blocks of the implicit matrix 405
    "active_leg": 427,
    "takeoff": 30,      # per leg taking off: hip offset 6 and touchdown target 24
    "window": 12,       # per scenario: gait and filter constants
}


def tick_window_ops(out, last_mask0, contact) -> int:
    """Operations that a window of tick_window.cu needs on this run's data
    (``TICK_OPS``): which legs swing, touch, take off and are in contact is
    read from the window's logs (``out``) and its input ``last_mask``."""
    mask = out[1].contact_mask
    B, steps, _ = mask.shape
    swing = mask == 0
    prev = torch.cat([last_mask0[:, None, :], mask[:, :-1]], dim=1)
    active, touching, _, _ = contact_branches(out, contact)
    n = lambda x: int(x.sum())  # noqa: E731
    return (TICK_OPS["tick"] * B * steps + TICK_OPS["window"] * B
            + TICK_OPS["swing_leg"] * n(swing) + TICK_OPS["swing_tick"] * n(swing.any(-1))
            + TICK_OPS["stance_leg"] * n(~swing) + TICK_OPS["early_leg"] * n(swing & touching)
            + TICK_OPS["active_leg"] * n(active) + TICK_OPS["takeoff"] * n(swing & (prev != 0)))


def check_tick_window(dev) -> dict:
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.sim import tick_fused as TF

    worst = 0.0
    for B in (B_MAIN, 5, 13, 517):
        threads, blocks, resident = TF.tick_window_shape(B)
        print(f"tick window launch B={B}: {blocks} blocks of {threads} threads "
              f"(one scenario a block), {resident} blocks resident per SM")
    # duty "sweep": the heterogeneous battery (per-scenario gait and contact)
    for B, steps, rel, seed, duty in [(B_MAIN, 20, 5e-3, 13, 0.6), (B_MAIN, 1, 2e-4, 14, 0.6),
                                      (5, 20, 5e-3, 1, 0.6), (13, 20, 5e-3, 2, 0.6),
                                      (517, 20, 5e-3, 3, 0.6), (B_MAIN, 20, 5e-3, 15, 1.0),
                                      (B_MAIN, 20, 5e-3, 16, "sweep")]:
        args = hetero_battery(seed, dev) if duty == "sweep" else tick_battery(B, seed, dev, duty)
        out = TF.run_ticks_fused(*args, steps, 45.0, 1e-3, 30.0)
        torch.cuda.synchronize()
        ref = TF.run_ticks_fused_plain(*args, steps, 45.0, 1e-3, 30.0)  # on the card
        if (B, steps, duty) == (B_MAIN, 20, 0.6):
            out_main = out
        miss, errs, max_abs = window_misses(out, ref, rel)
        excused, margins = rounding_flips(out, ref, args[2])
        n_miss, n_flip = int(miss.sum()), len(margins)
        print(f"tick window B={B} steps={steps} duty={duty}: worst |k-plain| / channel scale "
              f"{max(errs[k] for k in errs if not k.endswith('mask')):.3e} (bar {rel}), max "
              f"|k-plain| {max_abs:.3e}; integer mismatches {{last_mask: "
              f"{errs['leg.last_mask']}, contact_mask: {errs['ticks.contact_mask']}}}; "
              f"scenarios off the bar {n_miss}, with a different contact branch {n_flip}")
        if n_flip:
            print(f"  branch-flip scenarios and their margin at the first flip (m): "
                  f"{dict(list(margins.items())[:16])}; excused (margin < {FLIP_MARGIN} m): "
                  f"{int(excused.sum())}")
        if n_flip > MAX_FLIPS:
            fail(f"tick window: {n_flip} scenarios took another contact branch (at most "
                 f"{MAX_FLIPS} may, each within rounding of its threshold)")
        unexplained = (miss & ~excused).nonzero()[:, 0].tolist()
        if unexplained:
            fail(f"tick window kernel disagrees with its plain version (B={B}, steps={steps}, "
                 f"duty={duty}) "
                 f"in scenarios {unexplained[:16]} not excused as rounding flips: {errs}")
        worst = max(worst, max_abs)

    B, steps = B_MAIN, 20
    args = tick_battery(B, 13, dev)
    dyn, gait, contact, cmd, traj, u0, plant, leg, yc, yp, vf, t0 = args
    carry, batch = TF._inputs(gait, contact, cmd, traj, u0, plant, leg, yc, yp, vf, t0)
    cst = TF.make_consts(dyn, 45.0)
    alpha = E._filter_alpha(30.0, 1e-3)
    ms = cuda_ms(lambda: TF._launch(carry, batch, cst, steps, 1e-3, alpha))
    plain_ms = cuda_ms(lambda: TF.run_ticks_fused_plain(*args, steps, 45.0, 1e-3, 30.0), reps=2)
    lib_ms = cuda_ms(lambda: E._run_ticks(*args, steps, 45.0, 1e-3, 30.0), reps=2)
    ops = tick_window_ops(out_main, leg.last_mask, contact)  # the same battery's window
    # bytes: carry (78 floats) and inputs (35) read, carry written, 71 log floats a tick
    b_bytes = 4 * B * (78 + 35 + 78 + 71 * steps) + 4 * 220
    b_ms, b_by = bound(b_bytes, ops)
    print(f"tick window times (B={B}, {steps} ticks): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"eager port _run_ticks window {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{ops} operations, {ops / (B * steps):.1f} per scenario-tick, from TICK_OPS; "
          f"{b_bytes} bytes)")
    # no single PyTorch call computes the window: library_ms is null, and the
    # eager tick loop above is the yardstick
    return dict(name="run_ticks_fused", route="cuda",
                source="convex_mpc_tpu_torch/csrc/tick_window.cu",
                replaces="convex_mpc_tpu/sim/tick_fused.py:1031",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def dense_problem(B: int, nb: int, seed: int, dev):
    """The structured problem with its constraint matrix written out dense:
    A (B, 7 nb, 3 nb) = [friction blocks; diag(box)]."""
    C, box, Minv, q, l, u, rho, x, z, y = structured_problem(B, nb, seed, dev)
    nz, m_fr = 3 * nb, 4 * nb
    A = torch.zeros((B, m_fr + nz, nz), device=dev)
    for k in range(nb):
        A[:, 4 * k:4 * k + 4, 3 * k:3 * k + 3] = C[:, k]
    A[:, m_fr:, :] = torch.diag_embed(box)
    return [a.contiguous() for a in (A, Minv, q, l, u, rho, x, z, y)]


def admm_dense_bmm(A, Minv, q, l, u, rho, x, z, y, iters, sigma=1e-6, alpha=1.6):
    """Library yardstick: the dense iterations as torch.bmm calls (timed
    only; the port never calls it)."""
    At = A.transpose(1, 2)
    for _ in range(iters):
        rhs = sigma * x - q + torch.bmm(At, (rho * z - y)[:, :, None])[:, :, 0]
        xt = torch.bmm(Minv, rhs[:, :, None])[:, :, 0]
        axt = torch.bmm(A, xt[:, :, None])[:, :, 0]
        x_new = alpha * xt + (1.0 - alpha) * x
        ax_rel = alpha * axt + (1.0 - alpha) * z
        z_new = torch.clamp(ax_rel + y / rho, l, u)
        y = y + rho * (ax_rel - z_new)
        x, z = x_new, z_new
    return x, z, y


def full_form_problem(B: int, dev, rho: float = 0.1):
    """The dense iterations' operands on the full-form QP (A (640, 384)) of
    the main path's start batch, as the legacy solver's first segment hands
    them to the kernel: Ruiz-scaled A, q, l, u, the KKT inverse at ``rho``
    (equality rows weighted 1e3), and the cold start."""
    from convex_mpc_tpu_torch.control import reference as R
    from convex_mpc_tpu_torch.mpc import admm, qp
    from convex_mpc_tpu_torch.sim import engine as E

    dyn, gait_b, _, sched_b, state = start_batch(B, dev)
    obs = E.observe(dyn, state.plant, state.yaw_cont, state.yaw_prev, state.vel_filt)[0]
    traj = R.generate(state.refgen, gait_b, obs, E.lookup_command(sched_b, state.t), state.t,
                      (1.0 / 3.0) / HORIZON, HORIZON)[0]
    p0 = traj.x0[:, 0:3]
    x0_s = torch.cat([torch.zeros_like(p0), traj.x0[:, 3:]], dim=-1)
    x_ref_s = torch.cat([traj.x_ref[:, :, 0:3] - p0[:, None, :], traj.x_ref[:, :, 3:]], dim=-1)
    data = qp.build_qp(traj.dyn, x0_s, x_ref_s, traj.contact,
                       (1, 1, 50, 10, 20, 1, 2, 2, 1, 1, 1, 1), 1e-5, 0.8, 10.0)
    s = admm.ruiz_equilibrate(data, admm.SCALING_ITERS)
    w = torch.where((data.u - data.l) < 1e-9, admm.EQ_SCALE, 1.0)
    rho_vec = rho * w
    K = torch.matmul(s.A.transpose(1, 2), s.A * rho_vec[:, :, None])
    Minv = admm._segment_inverse(torch.diag_embed(s.p_diag + admm.SIGMA) + K)
    n, m = data.q.shape[-1], data.l.shape[-1]
    zero = lambda k: torch.zeros((B, k), device=dev)  # noqa: E731
    return [a.contiguous() for a in (s.A, Minv, s.q, s.l, s.u, rho_vec, zero(n), zero(m), zero(m))]


def check_admm_dense(dev) -> list:
    """The dense iterations at B_MAIN, on the legacy condensed shape A (448,
    192) and on the full form's A (640, 384), within rtol and atol 2e-4 of
    the plain version after 25 and 50 iterations, and their times; the full
    form at horizon 24, A (960, 576), must raise. Returns a kernel-table row
    for each shape."""
    rows = [dense_shape_row(dev, "condensed", dense_problem(B_MAIN, 64, seed=11, dev=dev)),
            dense_shape_row(dev, "full form", full_form_problem(B_MAIN, dev))]
    torch.cuda.empty_cache()
    from convex_mpc_tpu_torch.mpc import kernels as K

    m, n = 960, 576
    csize, resident, smem = K.dense_cluster_shape(m, n)
    args = [torch.zeros(s, device=dev) for s in
            [(2, m, n), (2, n, n), (2, n), (2, m), (2, m), (2, m), (2, n), (2, m), (2, m)]]
    try:
        K.admm_iterations(*args, iters=1)
    except RuntimeError as exc:
        print(f"admm_iterations (dense) A={(m, n)}: {resident} clusters resident, {smem} B; "
              f"the wrapper raises: {exc}")
    else:
        fail(f"admm_iterations at A {(m, n)} launched: no cluster should hold it")
    if resident or smem:
        fail(f"admm_iterations at A {(m, n)}: the launcher reports {resident} clusters of "
             f"{smem} B")
    return rows


def dense_f64_errors(out, ref, args, iters: int) -> dict:
    """The kernel's and the plain version's max errors against the same
    iterations in f64, per output (x, z, y), and ``within_bar``: the kernel
    finite and within twice the plain version's error plus 1e-5 x the f64
    output's largest entry. The full form's iterations amplify rounding
    (equality rows carry rho x 1e3), so that two f32 orders of the same sums
    differ by more than 2e-4 entry by entry: the plain version with A's
    columns permuted misses that bar by itself
    (tests/test_torch_qp.py::test_full_form_iterations_f32_order)."""
    from convex_mpc_tpu_torch.mpc import kernels as K

    truth = K.admm_iterations_plain(*[a.double() for a in args], iters=iters)
    e_k = [(a.double() - t).abs().max().item() for a, t in zip(out, truth)]
    e_p = [(b.double() - t).abs().max().item() for b, t in zip(ref, truth)]
    scale = [t.abs().max().item() for t in truth]
    ok = all(torch.isfinite(a).all() for a in out) and all(
        ek <= 2 * ep + 1e-5 * sc for ek, ep, sc in zip(e_k, e_p, scale))
    return dict(e_kernel=e_k, e_plain=e_p, scale=scale, within_bar=bool(ok))


def outside_2e4(out, ref) -> list:
    """Entries of each output (x, z, y) outside rtol and atol 2e-4 of ``ref``."""
    return [int((~torch.isclose(a, b, rtol=2e-4, atol=2e-4)).sum()) for a, b in zip(out, ref)]


def permuted_plain(args, iters: int, seed: int = 0):
    """The plain dense iterations with A's columns (and Minv's rows and
    columns, q and x) permuted, and x permuted back: the same sums in
    another f32 order."""
    from convex_mpc_tpu_torch.mpc import kernels as K

    A, Minv, q, l, u, rho, x, z, y = args
    perm = torch.randperm(A.shape[-1], generator=torch.Generator().manual_seed(seed))
    perm = perm.to(A.device)
    inv = torch.argsort(perm)
    permuted = [a.contiguous() for a in (A[:, :, perm], Minv[:, perm][:, :, perm], q[:, perm],
                                         l, u, rho, x[:, perm], z, y)]
    xp, zp, yp = K.admm_iterations_plain(*permuted, iters=iters)
    return xp[:, inv], zp, yp


def dense_shape_row(dev, form: str, args) -> dict:
    """One shape of the dense iterations: its launch, the check against the
    plain version, and the times of the kernel, the plain version and
    torch.bmm iterations, beside the bound."""
    from convex_mpc_tpu_torch.mpc import kernels as K

    B, m, n = args[0].shape
    csize, resident, smem = K.dense_cluster_shape(m, n)
    if resident < 1:
        fail(f"admm_iterations: no cluster of {csize} CTAs holds A {(m, n)} on the card")
    print(f"admm_iterations (dense, {form}) A={(m, n)}: clusters of {csize} CTAs, "
          f"{smem} B of shared memory per CTA, {resident} resident at once, "
          f"{B / resident:.2f} waves at B={B}")
    worst = 0.0
    for iters in (25, 50):
        out = K.admm_iterations(*args, iters=iters)
        torch.cuda.synchronize()
        ref = K.admm_iterations_plain(*args, iters=iters)
        errs = [(a - b).abs().max().item() for a, b in zip(out, ref)]
        outside = outside_2e4(out, ref)
        print(f"admm_iterations (dense) B={B} A={(m, n)} iters={iters}: max|k-plain| x/z/y = "
              f"{errs}, entries outside atol 2e-4 rtol 2e-4: {outside}")
        if form == "condensed":
            ok = not any(outside)
        else:
            d = dense_f64_errors(out, ref, args, iters)
            ok = d["within_bar"]
            print(f"  against the f64 iterations, x/z/y: kernel {d['e_kernel']}, plain "
                  f"{d['e_plain']} (bar twice the plain + 1e-5 x scale {d['scale']}); the "
                  f"plain version with its sums reordered has "
                  f"{outside_2e4(permuted_plain(args, iters), ref)} entries outside rtol and "
                  f"atol 2e-4 of the plain")
        if not (ok and all(torch.isfinite(a).all() for a in out)):
            fail(f"admm_iterations disagrees with its plain version at {iters} iterations "
                 f"(A {(m, n)})")
        worst = max(worst, *errs)
    iters = 25
    ms = cuda_ms(lambda: K.admm_iterations(*args, iters=iters))
    plain_ms = cuda_ms(lambda: K.admm_iterations_plain(*args, iters=iters), reps=3)
    lib_ms = cuda_ms(lambda: admm_dense_bmm(*args, iters=iters), reps=3)
    in_bytes = 4 * B * (m * n + n * n + 2 * n + 6 * m)
    out_bytes = 4 * B * (n + 2 * m)
    # per iteration: A't and A xt 2mn each, Minv rhs 2n^2, vector updates ~12m + 6n
    flops = B * iters * (4 * m * n + 2 * n * n + 12 * m + 6 * n)
    b_ms, b_by = bound(in_bytes + out_bytes, flops)
    print(f"admm_iterations (dense, {form}) A={(m, n)} times (25 iters): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    name = "admm_iterations" if form == "condensed" else f"admm_iterations ({form}, A {m}x{n})"
    return dict(name=name, route="cuda", source="convex_mpc_tpu_torch/csrc/admm_dense.cu",
                replaces="convex_mpc_tpu/mpc/kernels.py:186",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, shape=[m, n])


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------
def start_batch(B: int, dev, n: int = HORIZON, x_spread: float = 0.02):
    """bench.py's start state: trot 3 Hz duty 0.6, vx = 0.5, x offsets
    across +-``x_spread`` m; ``n`` the MPC horizon of the solver state."""
    from convex_mpc_tpu_torch.control import gait as G
    from convex_mpc_tpu_torch.models import dynamics as D
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.sim import physics as P

    dyn = D.build_dyn(device=dev)
    contact = P.default_contact(kn=30000, dn=1000, device=dev)
    gait_b = E.broadcast_batch(G.make_gait_params(3.0, 0.6, device=dev), B)
    contact_b = E.broadcast_batch(contact, B)
    sched_b = E.broadcast_batch(E.constant_schedule(vx=0.5, device=dev), B)
    state = E.init_state(dyn, n=n)._replace(plant=P.init_plant(dyn, contact=contact))
    state_b = E.broadcast_batch(state, B)
    q = state_b.plant.q.clone()
    q[:, 0] += torch.linspace(-x_spread, x_spread, B, device=dev)
    state_b = state_b._replace(plant=state_b.plant._replace(q=q))
    return dyn, gait_b, contact_b, sched_b, state_b


def attractor_kkt(dev, rho: float = 1e-4) -> torch.Tensor:
    """The solver's KKT matrices at ``rho`` (default 1e-4, the attractor
    region) for the main path's first QP batch."""
    from convex_mpc_tpu_torch.mpc import admm
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.utils.config import DEFAULT_CONFIG, engine_kwargs_batched

    kw = engine_kwargs_batched(DEFAULT_CONFIG)
    dyn, gait_b, _, sched_b, state_b = start_batch(B_MAIN, dev)
    qd = torch.as_tensor(kw["q_diag"], dtype=torch.float32, device=dev)
    data = E.cycle_update(dyn, gait_b, sched_b, state_b, qd, kw["n"], kw["mpc_dt"],
                          kw["r_value"], kw["mu_mpc"], kw["fz_min"])[0]
    return admm.kkt_at_rho(data, torch.full((B_MAIN,), rho, device=dev)).contiguous()


def healthy(state) -> bool:
    z = state.plant.q[:, 2]
    return bool(torch.isfinite(state.plant.q).all() and ((z > 0.1) & (z < 0.6)).all())


def _all_kernels():
    from convex_mpc_tpu_torch.mpc.kernels import admm_iterations, admm_iterations_structured
    from convex_mpc_tpu_torch.ops.chol_kernel import spd_inverse
    from convex_mpc_tpu_torch.sim.tick_fused import run_ticks_fused

    return {"spd_inverse": spd_inverse, "admm_iterations_structured": admm_iterations_structured,
            "run_ticks_fused": run_ticks_fused, "admm_iterations": admm_iterations}


def drive(name, cycle, args, state, cycles, kw, profile=None):
    """``cycles`` timed cycles with every kernel's launch counter set to 0 just
    before and read just after. Returns (state, stats)."""
    kernels = _all_kernels()
    if profile is not None:
        kw = dict(kw, profile=profile)
    iters = []
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    for _ in range(cycles):
        state, log = cycle(*args, state, **kw)
        iters.append(log.solver_iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    it = torch.cat(iters).float().cpu().numpy()
    B = state.plant.q.shape[0]
    out = {"batch": B, "window_cycles": cycles, "solves_per_s": B * cycles / wall,
           "cycle_ms": wall / cycles * 1e3, "iters_mean": float(it.mean()),
           "iters_p99": float(np.percentile(it, 99))}
    if profile:
        out.update({f"{k}_ms": profile[k] / cycles * 1e3 for k in ("update", "solve", "apply")})
    out.update(launches_per_cycle={n: v / cycles for n, v in launches.items()},
               healthy=healthy(state))
    print(f"{name} window: " + json.dumps(out))
    if not out["healthy"]:
        fail(f"{name}: the batch is not healthy after the window (non-finite or z outside (0.1, 0.6))")
    out["launches"] = launches
    return state, out


def card_vs_cpu(name, cycle, dyn, batch, cycles, kw):
    """``cycles`` cycles of the first B_SMALL scenarios of ``batch`` (gait,
    contact, schedule, state) on the card and on the CPU (plain versions);
    the applied forces must agree within 2.0 N after each."""
    from convex_mpc_tpu_torch.utils import interop

    small = [interop.tree_map(lambda x: x[:B_SMALL].contiguous(), a) for a in batch]
    cpu = torch.device("cpu")
    dyn_cpu = interop.tree_map(lambda x: x.to(cpu), dyn)
    gpu_args = small[:3]
    cpu_args = [interop.tree_map(lambda x: x.to(cpu), a) for a in small[:3]]
    s_gpu, s_cpu = small[3], interop.tree_map(lambda x: x.to(cpu), small[3])
    for c in range(cycles):
        s_gpu, _ = cycle(dyn, *gpu_args, s_gpu, **kw)
        s_cpu, _ = cycle(dyn_cpu, *cpu_args, s_cpu, **kw)
        du0 = (s_gpu.u0.cpu() - s_cpu.u0).abs().max().item()
        print(f"{name}: B={B_SMALL} cycle {c}, card vs CPU plain versions: max|du0| = "
              f"{du0:.4f} N (bar 2.0 N)")
        if not du0 < 2.0:
            fail(f"{name}: the card's cycle disagrees with the CPU cycle")


def main_path(dev) -> dict:
    """Phase 4: the production cycle, unfused and with the fused tick window."""
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.utils.config import DEFAULT_CONFIG, engine_kwargs_batched

    kw = engine_kwargs_batched(DEFAULT_CONFIG)
    dyn, gait_b, contact_b, sched_b, state = start_batch(B_MAIN, dev)
    args = (dyn, gait_b, contact_b, sched_b)
    t0 = time.perf_counter()
    for _ in range(SETTLE):
        state, _ = E.mpc_cycle_batch(*args, state, **kw)
    torch.cuda.synchronize()
    print(f"main path: {SETTLE} settle cycles at B={B_MAIN} in {time.perf_counter() - t0:.2f} s")

    settled = state
    _, main = drive("main path", E.mpc_cycle_batch, args, settled, WINDOW, kw, profile={})
    if min(main["launches"][k] for k in ("spd_inverse", "admm_iterations_structured")) <= 0:
        fail(f"a kernel of the main path was never launched: {main['launches']}")
    fkw = dict(kw, use_fused_ticks=True)
    state, fused = drive("fused-tick path", E.mpc_cycle_batch, args, settled, WINDOW, fkw,
                         profile={})
    fl = fused["launches"]
    if fl["run_ticks_fused"] != WINDOW or min(fl["spd_inverse"], fl["admm_iterations_structured"]) <= 0:
        fail(f"fused-tick path: run_ticks_fused launched {fl['run_ticks_fused']} times in "
             f"{WINDOW} cycles, or a solve kernel never ran: {fl}")
    print("main vs fused-tick window, ms per cycle: " + json.dumps(
        {k: [main[k], fused[k]] for k in ("cycle_ms", "update_ms", "solve_ms", "apply_ms")}))

    batch = (gait_b, contact_b, sched_b, settled)
    card_vs_cpu("main path", E.mpc_cycle_batch, dyn, batch, 1, kw)
    card_vs_cpu("fused-tick path", E.mpc_cycle_batch, dyn, batch, 2, fkw)
    return {"main": main, "fused": fused, "settled": (dyn, *batch)}


def fixed_path(dev) -> dict:
    """Phase 5: the legacy fixed-segment solver's cycle."""
    from convex_mpc_tpu_torch.sim import engine as E

    kw = dict(solver_iters=FIXED_ITERS)
    dyn, gait_b, contact_b, sched_b, state = start_batch(B_MAIN, dev)
    args = (dyn, gait_b, contact_b, sched_b)
    E.mpc_cycle_fixed(*args, state, **kw)  # first use: allocator and library warm-up
    _, fixed = drive("legacy fixed-segment path", E.mpc_cycle_fixed, args, state, FIXED_WINDOW,
                     kw)
    if fixed["launches"]["admm_iterations"] <= 0:
        fail(f"the legacy path never launched admm_iterations: {fixed['launches']}")
    card_vs_cpu("legacy fixed-segment path", E.mpc_cycle_fixed, dyn,
                (gait_b, contact_b, sched_b, state), 1, kw)
    return fixed


def horizons_path(dev) -> None:
    """Phase 6: the production cycle at horizons 24 and 32 (nz = 288, 384:
    ``spd_inverse`` with its working set on chip and in device memory, the
    structured chunk in clusters of 2 and 3 CTAs), mpc_dt = gait period /
    horizon."""
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.utils.config import EngineConfig, MpcConfig, engine_kwargs_batched

    for n in HORIZONS:
        kw = engine_kwargs_batched(EngineConfig(mpc=MpcConfig(horizon=n)))
        dyn, gait_b, contact_b, sched_b, state = start_batch(B_MAIN, dev, n)
        args = (dyn, gait_b, contact_b, sched_b)
        t0 = time.perf_counter()
        for _ in range(H_SETTLE):
            state, _ = E.mpc_cycle_batch(*args, state, **kw)
        torch.cuda.synchronize()
        print(f"horizon {n} (mpc_dt {kw['mpc_dt']:.6f} s): {H_SETTLE} settle cycles at "
              f"B={B_MAIN} in {time.perf_counter() - t0:.2f} s")
        _, res = drive(f"horizon {n} path", E.mpc_cycle_batch, args, state, H_WINDOW, kw,
                       profile={})
        if min(res["launches"][k] for k in ("spd_inverse", "admm_iterations_structured")) <= 0:
            fail(f"horizon {n}: a solve kernel was never launched: {res['launches']}")
        card_vs_cpu(f"horizon {n} path", E.mpc_cycle_batch, dyn,
                    (gait_b, contact_b, sched_b, state), 1, kw)


def full_form_path(dev) -> dict:
    """Phase 7: the legacy cycle on the full-form QP (``formulation="full"``,
    A (640, 384) at horizon 16): one warm-up cycle, a FIXED_WINDOW window
    with the counters set to 0 (kernel 4 must launch, on the full form's
    shapes), then one B = 8 cycle on the card and on the CPU within 2.0 N."""
    from convex_mpc_tpu_torch.mpc import qp
    from convex_mpc_tpu_torch.sim import engine as E

    kw = dict(solver_iters=FIXED_ITERS, formulation="full")
    dyn, gait_b, contact_b, sched_b, state = start_batch(B_MAIN, dev)
    full = E.broadcast_batch(E.init_state(dyn, n=HORIZON, formulation="full").solver, B_MAIN)
    state = state._replace(solver=full)
    args = (dyn, gait_b, contact_b, sched_b)
    E.mpc_cycle_fixed(*args, state, **kw)  # first use: allocator and library warm-up
    out_state, res = drive("full-form path", E.mpc_cycle_fixed, args, state, FIXED_WINDOW, kw)
    shapes = (tuple(out_state.solver.x.shape), tuple(out_state.solver.z.shape))
    if res["launches"]["admm_iterations"] <= 0 or shapes != (
            (B_MAIN, qp.n_vars(HORIZON)), (B_MAIN, qp.n_rows(HORIZON))):
        fail(f"full-form path: admm_iterations launched {res['launches']['admm_iterations']} "
             f"times on solver state {shapes}")
    card_vs_cpu("full-form path", E.mpc_cycle_fixed, dyn, (gait_b, contact_b, sched_b, state),
                1, kw)
    return res


# phase 8: the scenario batches (BASELINE.json configs 3-5): (name, size,
# the sim/scenarios.py function that makes it, simulate_batch keyword arguments,
# settle cycles, window cycles)
SCENARIO_BATCHES = (
    ("velocity_sweep", 1024, lambda S, dyn, B: S.velocity_sweep(dyn, B, seed=0),
     dict(adaptive=False, solver_iters=300), 2, 4),
    ("friction_randomization", 512, lambda S, dyn, B: S.friction_randomization(dyn, B),
     dict(adaptive=True, solver_iters=1000, use_fused_ticks=True), 4, 8),
    ("gait_sweep", 512, lambda S, dyn, B: S.gait_sweep(
        dyn, freqs=np.linspace(2.5, 3.5, 16), duties=np.linspace(0.5, 0.7, 32)),
     dict(adaptive=True, solver_iters=1000), 4, 4),
)


def scenario_paths(dev) -> dict:
    """Phase 8: each scenario batch through ``scenarios.simulate_batch``: its
    settle cycles, then a timed window with the counters set to 0 just
    before and read just after (finite, 0.1 < z < 0.6); solves/s, stage
    times (adaptive path), iterations, the share upright and each kernel's
    launches; then one cycle of its first B_SMALL scenarios on the card and
    on the CPU within 2.0 N."""
    from convex_mpc_tpu_torch.models import dynamics as D
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.sim import scenarios as S

    dyn = D.build_dyn(device=dev)
    kernels = _all_kernels()
    out = {}
    for name, B, build, kw, settle, window in SCENARIO_BATCHES:
        batch = build(S, dyn, B)
        if batch.size != B:
            fail(f"{name}: built {batch.size} scenarios, not {B}")
        t0 = time.perf_counter()
        batch, _, _ = S.simulate_batch(dyn, batch, settle, **kw)
        torch.cuda.synchronize()
        print(f"{name}: {settle} settle cycles at B={B} in {time.perf_counter() - t0:.2f} s")
        settled = batch
        prof = {} if kw["adaptive"] else None
        wkw = dict(kw, profile=prof) if prof is not None else kw
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        batch, metrics, logs = S.simulate_batch(dyn, batch, window, collect_logs=True, **wkw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        it = logs.solver_iters.float().cpu().numpy()
        res = {"batch": B, "window_cycles": window, "solves_per_s": B * window / wall,
               "cycle_ms": wall / window * 1e3, "iters_mean": float(it.mean()),
               "iters_p99": float(np.percentile(it, 99)),
               "upright_share": float(metrics["upright"].float().mean()),
               "height_mean": float(metrics["height"].mean()),
               "vx_err_mean": float(metrics["vx_err"].mean()),
               "wz_err_mean": float(metrics["wz_err"].mean())}
        if prof:
            res.update({f"{k}_ms": prof[k] / window * 1e3 for k in ("update", "solve", "apply")})
        res["launches_per_cycle"] = {n: k.launches / window for n, k in kernels.items()}
        res["healthy"] = healthy(batch.state)
        print(f"{name} window: " + json.dumps(res))
        if not res["healthy"]:
            fail(f"{name}: the batch is not healthy after the window (non-finite or z outside "
                 f"(0.1, 0.6))")
        need = ["admm_iterations"] if not kw["adaptive"] else (
            ["spd_inverse", "admm_iterations_structured"]
            + (["run_ticks_fused"] if kw.get("use_fused_ticks") else []))
        if min(kernels[n].launches for n in need) <= 0:
            fail(f"{name}: a kernel of its path was never launched: "
                 f"{ {n: k.launches for n, k in kernels.items()} }")
        res["launches"] = {n: k.launches for n, k in kernels.items()}
        cycle = E.mpc_cycle_batch if kw["adaptive"] else E.mpc_cycle_fixed
        ckw = {k: v for k, v in kw.items() if k != "adaptive"}
        card_vs_cpu(f"{name} batch", cycle, dyn,
                    (settled.gait, settled.contact, settled.sched, settled.state), 1, ckw)
        out[name] = res
        del batch, settled, logs
        torch.cuda.empty_cache()
    return out


def _leaves(trees) -> list:
    from convex_mpc_tpu_torch.utils import interop

    return [leaf for t in trees for leaf in interop.tree_leaves(t)]


def _bitwise(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.device == y.device and torch.equal(x, y) for x, y in zip(la, lb))


def _counted(need, fn):
    """``fn()`` with every kernel's launch counter set to 0 just before it and
    read just after; fails unless each kernel of ``need`` launched."""
    kernels = _all_kernels()
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    if min(launches[n] for n in need) <= 0:
        fail(f"a kernel of the path was never launched: {launches}")
    return out, launches


def scale_out_path(dev, settled) -> None:
    """Phase 9: ``parallel/mesh.py`` on one NCCL rank."""
    import socket

    import torch.distributed as dist

    from convex_mpc_tpu_torch.parallel import mesh as M
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.utils.config import DEFAULT_CONFIG, engine_kwargs_batched

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    M.init_distributed(backend="nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                       rank=0)
    try:
        mesh = M.make_mesh()
        print(f"scale-out: backend {dist.get_backend()}, mesh rank {mesh.rank} of {mesh.size} "
              f"on {mesh.device}")
        if dist.get_backend() != "nccl" or mesh.device.type != "cuda":
            fail("scale-out: the mesh is not one NCCL rank on the card")
        dyn, batch = settled[0], tuple(settled[1:])
        local = M.shard_batch(mesh, batch)
        if not _bitwise(local, batch):
            fail("scale-out: shard_batch of the B = 512 batch on one rank is not that batch")
        kw = engine_kwargs_batched(DEFAULT_CONFIG)

        def step(a):
            return (*a[:3], E.mpc_cycle_batch(dyn, *a, **kw)[0])

        ref = step(batch)
        fn = M.sharded_rollout_fn(mesh, step, lambda a: {"height": a[3].plant.q[:, 2]})
        (out, metrics), launches = _counted(
            ("spd_inverse", "admm_iterations_structured"), lambda: fn(local))
        h = out[3].plant.q[:, 2]
        local_mean = h.sum() / h.shape[0]
        same, mean_ok = _bitwise(out, ref), torch.equal(metrics["height"], local_mean)
        print("scale-out step: " + json.dumps({
            "bitwise_equal_to_unsharded": same, "mean_height": float(metrics["height"]),
            "local_mean": float(local_mean), "launches": launches, "healthy": healthy(out[3])}))
        if not (same and mean_ok and healthy(out[3])):
            fail("scale-out: the sharded step differs from the unsharded step, or its "
                 "all-reduced mean from the local mean")
        M.dryrun(mesh)
    finally:
        dist.destroy_process_group()


def measurement_path(dev, settled) -> dict:
    """Phase 10: the bench, the B = 1 latency, a trace, ``time_fn`` and a
    checkpoint round trip. Returns the bench's line."""
    import shutil

    from convex_mpc_tpu_torch.mpc.kernels import admm_iterations_structured
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.utils import checkpoint, profiling
    from convex_mpc_tpu_torch.utils.config import DEFAULT_CONFIG, engine_kwargs_batched

    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here / "tools"))
    import torch_bench
    import torch_realtime_latency as rt

    bench = torch_bench.main(batch=B_MAIN, windows=1)
    need = {"adaptive": ("spd_inverse", "admm_iterations_structured"),
            "fixed150": ("admm_iterations",), "fixed400": ("admm_iterations",)}
    for run, names in need.items():
        if min(bench["launches_per_cycle"][run][n] for n in names) <= 0:
            fail(f"bench {run}: a kernel of its path was never launched: "
                 f"{bench['launches_per_cycle'][run]}")
    if not bench["healthy"]:
        fail("bench: the adaptive batch is not healthy after its window")

    for fused in (False, True):
        names = ("spd_inverse", "admm_iterations_structured") + (
            ("run_ticks_fused",) if fused else ())
        b1, launches = _counted(names, lambda: rt.b1_headline(dev, 20.833, windows=1,
                                                               fused=fused))
        print(f"realtime B=1, use_fused_ticks={fused}: " + json.dumps(dict(b1, launches=launches)))
        if not b1["healthy"]:
            fail(f"realtime B=1 (use_fused_ticks={fused}): the scenario is not healthy")

    dyn, batch = settled[0], tuple(settled[1:])
    kw = engine_kwargs_batched(DEFAULT_CONFIG)
    fkw = dict(kw, use_fused_ticks=True)
    E.mpc_cycle_batch(dyn, *batch, **fkw)  # the profiler's first use outside the trace
    trace_dir = here / "build" / "chip_smoke_trace"
    torch.cuda.synchronize()
    with profiling.trace(trace_dir) as prof:
        t0 = time.perf_counter()
        E.mpc_cycle_batch(dyn, *batch, **fkw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = profiling.device_busy_ms(prof)
    size = (trace_dir / "trace.json").stat().st_size
    shutil.rmtree(trace_dir)
    print("traced fused cycle: " + json.dumps({
        "batch": B_MAIN, "cycle_ms": wall_ms, "device_busy_ms": busy,
        "device_busy_share": busy / wall_ms, "trace_bytes": size}))
    if not busy > 0.0:
        fail("trace: no device interval in the traced cycle")

    args = structured_problem(B_MAIN, 64, seed=11, dev=dev)
    chunk = lambda: admm_iterations_structured(*args, iters=25)  # noqa: E731
    t_fn = profiling.time_fn(chunk, reps=10) * 1e3
    t_ev = cuda_ms(chunk)
    print(f"time_fn of one kernel-2 chunk (B={B_MAIN}, nb=64, 25 iterations): {t_fn:.4f} ms, "
          f"CUDA events {t_ev:.4f} ms, ratio {t_fn / t_ev:.4f}")
    if abs(t_fn - t_ev) > 0.2 * t_ev:
        fail("time_fn and CUDA events disagree by more than 20%")
    del args

    state = batch[3]
    path = here / "build" / "chip_smoke_state.npz"
    checkpoint.save_pytree(path, state)
    size = path.stat().st_size
    loaded = checkpoint.load_pytree(path, state)
    path.unlink()
    same = _bitwise((loaded,), (state,))
    a = E.mpc_cycle_batch(dyn, *batch[:3], state, **kw)[0]
    b = E.mpc_cycle_batch(dyn, *batch[:3], loaded, **kw)[0]
    cycle_same = _bitwise((a,), (b,))
    print(f"checkpoint of the settled B={B_MAIN} state ({size} B): loaded bitwise equal "
          f"{same}, one cycle from it bitwise equal {cycle_same}")
    if not (same and cycle_same):
        fail("checkpoint: the loaded state or its next cycle differs from the original")
    return bench


# phase 11: force parity against the native f64 oracle, and the trot demo.
# The sweep's bar is the JAX tool's own count on the same 50 instances: on
# the CPU, tools/parity_sweep.py --n 50 --cpu leaves 1 of 50 over 2% (max
# 2.051%), so the port may leave as many. The demo's bands are set around
# the JAX demo's values on the CPU (examples/trot_demo.py --schedule const
# --vx 0.5 --seconds 2 --cpu: vx_b 0.557, z 0.273), written down before the
# first run on the card.
SWEEP_MAX_OVER = 1
DEMO_VX_BAND = (0.527, 0.587)
DEMO_Z_BAND = (0.268, 0.278)


def run_entry_point(argv: list, need: tuple, timeout: float) -> list:
    """Run one of the port's entry points (a path of this checkout and its
    arguments) as a subprocess on the card's default device; fails on a
    non-zero exit, or unless each kernel of ``need`` launched in it (its own
    ``launches:`` line, counted from 0 in that process). Returns its lines."""
    here = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    try:
        res = subprocess.run([sys.executable, *argv], cwd=here, capture_output=True, text=True,
                             timeout=timeout)
    except subprocess.TimeoutExpired:
        fail(f"{' '.join(argv)}: did not end within {timeout:.0f} s")
    lines = res.stdout.splitlines()
    print(f"$ python3 {' '.join(argv)}  (exit {res.returncode}, "
          f"{time.perf_counter() - t0:.1f} s)")
    if res.returncode != 0:
        print("\n".join(lines[-40:]) + "\n" + res.stderr[-4000:])
        fail(f"{' '.join(argv)} exited {res.returncode}")
    launched = [json.loads(l.split("launches: ", 1)[1]) for l in lines if "launches: " in l]
    if not launched or min(launched[-1][n] for n in need) <= 0:
        fail(f"{' '.join(argv)}: a kernel of its path was never launched: {launched}")
    return lines


def parity_path() -> None:
    """Phase 11: the native oracle's build, the 50-instance force-parity sweep
    (kernel 4), the 100-cycle adaptive loop parity (kernels 1 and 2) and the
    2 s trot demo (kernels 1 and 2), each through its entry point."""
    from convex_mpc_tpu_torch.utils import native_oracle

    t0 = time.perf_counter()
    try:
        print(f"native oracle: {native_oracle.compiler_version()}")
        lib = native_oracle.build()
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        fail(f"native oracle: {exc}")
    print(f"native oracle built: {lib.relative_to(Path(__file__).resolve().parent)}")

    lines = run_entry_point(["tools/torch_parity_sweep.py", "--n", "50",
                             "--max-over", str(SWEEP_MAX_OVER)], ("admm_iterations",), 600)
    for l in lines:
        if l.startswith(("instances:", "first-step", "over the")):
            print(f"  sweep: {l}")

    lines = run_entry_point(["tools/torch_loop_parity.py", "--adaptive", "--seconds", "2"],
                            ("spd_inverse", "admm_iterations_structured"), 600)
    for l in lines:
        if l.startswith(("height:", "in-loop", "applied-TORQUE", "solver iters", "over 2%")):
            print(f"  loop: {l}")

    lines = run_entry_point(["examples/torch_trot_demo.py", "--schedule", "const", "--vx", "0.5",
                             "--seconds", "2"], ("spd_inverse", "admm_iterations_structured"),
                            600)
    row = json.loads(next(l for l in lines if l.startswith("[demo] phases: "))
                     .split(": ", 1)[1])[0]
    print(f"  demo: vx_b {row['vx_b']:.4f} (band {DEMO_VX_BAND}), z {row['z']:.4f} "
          f"(band {DEMO_Z_BAND}), |att|max {row['att_max']:.4f}")
    if not (DEMO_VX_BAND[0] <= row["vx_b"] <= DEMO_VX_BAND[1]
            and DEMO_Z_BAND[0] <= row["z"] <= DEMO_Z_BAND[1]):
        fail("trot demo: the final vx or z lies outside its band")
    print(f"phase 11 took {time.perf_counter() - t0:.1f} s")


def ptxas_report(logs: dict) -> None:
    """Each kernel's registers, stack frame and spills as ``nvcc -Xptxas -v``
    printed them. Every entry function of every kernel must report its stack
    frame, spill nothing and keep no array in local memory (a stack frame);
    all lines are printed first."""
    import re

    faults = []
    for name, log in logs.items():
        fn, entries, reported = None, set(), set()
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
                entries.add(fn)
                continue
            if "stack frame" in line or "registers" in line:
                print(f"  {name}: {fn}: {line.split('ptxas info    :')[-1].strip()}")
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
            if m:
                reported.add(fn)
                if int(m.group(1)) or int(m.group(2)):
                    faults.append(f"{name}.cu: {fn} keeps {m.group(1)} bytes of stack frame, "
                                  f"{m.group(2)} bytes of spill stores")
        if not entries or entries - reported:
            faults.append(f"{name}.cu: ptxas reported no stack frame for "
                          f"{sorted(entries - reported) or 'any entry function'}")
    if faults:
        fail("; ".join(faults))


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run only on the card")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import convex_mpc_tpu_torch  # noqa: F401
        from convex_mpc_tpu_torch.utils import cuda_build
    except ImportError as exc:
        fail(f"the port's package is not beside this script: {exc}")

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(host_identity())
    ident = card_identity()
    print(ident, flush=True)

    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    ptxas_report(logs)

    kkt = attractor_kkt(dev)
    kernels = [check_spd_inverse(kkt), check_admm_chunk(dev), check_tick_window(dev),
               *check_admm_dense(dev)]
    del kkt
    torch.cuda.empty_cache()

    paths = main_path(dev)
    paths["fixed"] = fixed_path(dev)
    horizons_path(dev)
    paths["full"] = full_form_path(dev)
    torch.cuda.empty_cache()
    scenario_paths(dev)
    scale_out_path(dev, paths["settled"])
    measurement_path(dev, paths["settled"])
    parity_path()
    # each kernel's launches from the run of its own path: kernel 4 has a row
    # for the condensed shape (legacy path) and one for the full form's
    runs = {"spd_inverse": "main", "admm_iterations_structured": "main",
            "run_ticks_fused": "fused", "admm_iterations": "fixed"}
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        run = runs.get(k["name"], "full")
        k["launches"] = paths[run]["launches"][k["name"].split(" ")[0]]
    kernels = [{key: k[key] for key in order + (("shape",) if "shape" in k else ())}
               for k in kernels]
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(ident)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        print("chip_smoke: FAILED", flush=True)
        sys.exit(1)
