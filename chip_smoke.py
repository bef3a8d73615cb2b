"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. card identity (``nvidia-smi`` name and power limit);
2. build both CUDA kernels from ``convex_mpc_tpu_torch/csrc`` (one ``nvcc``
   per source, started together);
3. each kernel against its plain PyTorch version on the card at the main
   path's shapes — ``spd_inverse`` at B = 512, n = 192 on a random SPD
   batch and on the solver's KKT matrix at attractor-region rho (1e-4); the
   structured ADMM chunk at B = 512, nb = 64 for 25 and 150 iterations —
   with CUDA-event times of the kernel, the plain version and a library
   yardstick that the port never calls;
4. the main path: ``mpc_cycle_batch`` with ``engine_kwargs_batched(
   DEFAULT_CONFIG)`` at B = 512, horizon 16 from the start state of the JAX
   package's ``bench.py``; 16 settle cycles, then one timed 16-cycle window
   with the kernels' launch counters set to 0 just before it and read just
   after; then one B = 8 cycle on the card and the same cycle on the CPU
   (plain versions), whose applied forces must agree within 2.0 N.

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
from pathlib import Path

import numpy as np
import torch

B_MAIN = 512
HORIZON = 16
SETTLE = 16
WINDOW = 16
B_SMALL = 8

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


def check_spd_inverse(kkt: torch.Tensor) -> dict:
    from convex_mpc_tpu_torch.ops.chol_kernel import spd_inverse, spd_inverse_plain

    dev = kkt.device
    B, n = B_MAIN, 192
    rng = np.random.default_rng(7)
    M = torch.as_tensor(rng.normal(size=(B, n, n)).astype(np.float32), device=dev)
    A = M @ M.transpose(1, 2) / n + 3.0 * torch.eye(n, device=dev)
    eye = torch.eye(n, device=dev)

    out = spd_inverse(A)
    torch.cuda.synchronize()
    ref = spd_inverse_plain(A)
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    resid = (A @ out - eye).abs().max().item()
    bitwise = torch.equal(out, ref)
    print(f"spd_inverse random SPD B={B} n={n}: max|k-plain|={err:.3e} "
          f"(bar {5e-5 * scale:.3e}) |A out - I|={resid:.3e} (bar 1e-4) bitwise={bitwise}")
    if not (err <= 5e-5 * scale and resid < 1e-4):
        fail("spd_inverse disagrees with its plain version on the random SPD batch")

    # the solver's KKT at attractor-region rho: cond ~1e4, so the bar is
    # relative to the f64 inverse (within twice the plain version's error)
    out_k = spd_inverse(kkt)
    torch.cuda.synchronize()
    ref_k = spd_inverse_plain(kkt)
    K64 = kkt.double()
    truth = torch.cholesky_inverse(torch.linalg.cholesky(K64))
    kscale = truth.abs().max().item()
    e_kernel = (out_k.double() - truth).abs().max().item()
    e_plain = (ref_k.double() - truth).abs().max().item()
    eye64 = torch.eye(n, dtype=torch.float64, device=dev)
    r_kernel = (K64 @ out_k.double() - eye64).abs().max().item()
    r_plain = (K64 @ ref_k.double() - eye64).abs().max().item()
    kerr = (out_k - ref_k).abs().max().item()
    pscale = ref_k.abs().max().item()
    print(f"spd_inverse KKT rho=1e-4 B={B}: max|k-plain|={kerr:.3e} (= {kerr / kscale:.2e} x scale) "
          f"|k-f64|={e_kernel / kscale:.2e} x scale vs plain {e_plain / kscale:.2e}; "
          f"|A out - I| kernel {r_kernel:.3e} plain {r_plain:.3e}; "
          f"bitwise={torch.equal(out_k, ref_k)}")
    # the random-SPD bar, reported but not required here: on this cond ~1e4
    # matrix the plain version is itself farther than that from the f64 inverse
    met = kerr <= 5e-5 * pscale and r_kernel < 1e-4
    print(f"spd_inverse KKT against the random-SPD bar (|k-plain| <= 5e-5 x scale = "
          f"{5e-5 * pscale:.3e}, |A out - I| < 1e-4): {'met' if met else 'NOT met'}")
    if not (torch.isfinite(out_k).all() and e_kernel <= 2 * e_plain + 1e-5 * kscale
            and r_kernel <= 2 * r_plain + 1e-5):
        fail("spd_inverse on the attractor-rho KKT is less accurate than twice the plain version")

    ms = cuda_ms(lambda: spd_inverse(A))
    plain_ms = cuda_ms(lambda: spd_inverse_plain(A))

    def library():
        L, _ = torch.linalg.cholesky_ex(A)
        return torch.cholesky_inverse(L)

    lib_ms = cuda_ms(library)
    # least work: Cholesky n^3/3 + triangular inverse n^3/3 + symmetric Gram
    # n^3/3 flops per matrix (LAPACK potrf + potri); bytes: A in, inverse out
    b_ms, b_by = bound(2 * B * n * n * 4, B * n ** 3)
    print(f"spd_inverse times: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(name="spd_inverse", route="cuda",
                source="convex_mpc_tpu_torch/csrc/spd_inverse.cu",
                replaces="convex_mpc_tpu/ops/chol_kernel.py:227",
                max_abs_err=max(err, kerr), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def check_admm_chunk(dev) -> dict:
    from convex_mpc_tpu_torch.mpc.kernels import (
        admm_iterations_structured, admm_iterations_structured_plain)

    B, nb = B_MAIN, 64
    args = structured_problem(B, nb, seed=11, dev=dev)
    worst = 0.0
    for iters in (25, 150):
        out = admm_iterations_structured(*args, iters=iters)
        torch.cuda.synchronize()
        ref = admm_iterations_structured_plain(*args, iters=iters)
        errs = [(a - b).abs().max().item() for a, b in zip(out, ref)]
        bitwise = all(torch.equal(a, b) for a, b in zip(out, ref))
        ok = all(torch.allclose(a, b, atol=2e-6, rtol=1e-5) for a, b in zip(out, ref))
        print(f"admm_iterations_structured B={B} nb={nb} iters={iters}: max|k-plain| "
              f"x/z/y = {errs} (bar atol 2e-6 rtol 1e-5) bitwise={bitwise}")
        if not (ok and all(torch.isfinite(a).all() for a in out)):
            fail(f"admm_iterations_structured disagrees with its plain version at {iters} iterations")
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
    print(f"admm_iterations_structured times (25 iters): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(name="admm_iterations_structured", route="cuda",
                source="convex_mpc_tpu_torch/csrc/admm_structured.cu",
                replaces="convex_mpc_tpu/mpc/kernels.py:456",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------
def start_batch(B: int, dev):
    """bench.py's start state: trot 3 Hz duty 0.6, vx = 0.5, x offsets."""
    from convex_mpc_tpu_torch.control import gait as G
    from convex_mpc_tpu_torch.models import dynamics as D
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.sim import physics as P

    dyn = D.build_dyn(device=dev)
    contact = P.default_contact(kn=30000, dn=1000, device=dev)
    gait_b = E.broadcast_batch(G.make_gait_params(3.0, 0.6, device=dev), B)
    contact_b = E.broadcast_batch(contact, B)
    sched_b = E.broadcast_batch(E.constant_schedule(vx=0.5, device=dev), B)
    state = E.init_state(dyn, n=HORIZON)._replace(plant=P.init_plant(dyn, contact=contact))
    state_b = E.broadcast_batch(state, B)
    q = state_b.plant.q.clone()
    q[:, 0] += torch.linspace(-0.02, 0.02, B, device=dev)
    state_b = state_b._replace(plant=state_b.plant._replace(q=q))
    return dyn, gait_b, contact_b, sched_b, state_b


def attractor_kkt(dev) -> torch.Tensor:
    """The solver's KKT matrices at rho = 1e-4 for the main path's first QP batch."""
    from convex_mpc_tpu_torch.mpc import admm
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.utils.config import DEFAULT_CONFIG, engine_kwargs_batched

    kw = engine_kwargs_batched(DEFAULT_CONFIG)
    dyn, gait_b, _, sched_b, state_b = start_batch(B_MAIN, dev)
    qd = torch.as_tensor(kw["q_diag"], dtype=torch.float32, device=dev)
    data = E.cycle_update(dyn, gait_b, sched_b, state_b, qd, kw["n"], kw["mpc_dt"],
                          kw["r_value"], kw["mu_mpc"], kw["fz_min"])[0]
    return admm.kkt_at_rho(data, torch.full((B_MAIN,), 1e-4, device=dev)).contiguous()


def healthy(state) -> bool:
    z = state.plant.q[:, 2]
    return bool(torch.isfinite(state.plant.q).all() and ((z > 0.1) & (z < 0.6)).all())


def main_path(dev) -> dict:
    from convex_mpc_tpu_torch.mpc.kernels import admm_iterations_structured
    from convex_mpc_tpu_torch.ops.chol_kernel import spd_inverse
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.utils import interop
    from convex_mpc_tpu_torch.utils.config import DEFAULT_CONFIG, engine_kwargs_batched

    kw = engine_kwargs_batched(DEFAULT_CONFIG)
    dyn, gait_b, contact_b, sched_b, state = start_batch(B_MAIN, dev)
    t0 = time.perf_counter()
    for _ in range(SETTLE):
        state, _ = E.mpc_cycle_batch(dyn, gait_b, contact_b, sched_b, state, **kw)
    torch.cuda.synchronize()
    print(f"main path: {SETTLE} settle cycles at B={B_MAIN} in {time.perf_counter() - t0:.2f} s")

    profile: dict = {}
    iters = []
    spd_inverse.launches = 0
    admm_iterations_structured.launches = 0
    t0 = time.perf_counter()
    for _ in range(WINDOW):
        state, log = E.mpc_cycle_batch(dyn, gait_b, contact_b, sched_b, state,
                                       profile=profile, **kw)
        iters.append(log.solver_iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"spd_inverse": spd_inverse.launches,
                "admm_iterations_structured": admm_iterations_structured.launches}
    it = torch.cat(iters).float().cpu().numpy()
    out = {
        "batch": B_MAIN, "horizon": HORIZON, "window_cycles": WINDOW,
        "solves_per_s": B_MAIN * WINDOW / wall,
        "cycle_ms": wall / WINDOW * 1e3,
        "iters_mean": float(it.mean()), "iters_p99": float(np.percentile(it, 99)),
        "update_ms": profile["update"] / WINDOW * 1e3,
        "solve_ms": profile["solve"] / WINDOW * 1e3,
        "apply_ms": profile["apply"] / WINDOW * 1e3,
        "launches_per_cycle": {k: v / WINDOW for k, v in launches.items()},
        "healthy": healthy(state),
    }
    print("main path window: " + json.dumps(out))
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path was never launched: {launches}")
    if not out["healthy"]:
        fail("the batch is not healthy after the window (non-finite or z outside (0.1, 0.6))")

    # one B = 8 cycle on the card and the same cycle on the CPU
    take = lambda tree, d: interop.tree_map(lambda x: x[:B_SMALL].to(d), tree)
    small = [take(x, dev) for x in (gait_b, contact_b, sched_b, state)]
    s_gpu, _ = E.mpc_cycle_batch(dyn, *small, **kw)
    cpu = torch.device("cpu")
    dyn_cpu = interop.tree_map(lambda x: x.to(cpu), dyn)
    s_cpu, _ = E.mpc_cycle_batch(dyn_cpu, *[take(x, cpu) for x in small], **kw)
    du0 = (s_gpu.u0.cpu() - s_cpu.u0).abs().max().item()
    print(f"B={B_SMALL} cycle, card vs CPU plain versions: max|du0| = {du0:.4f} N (bar 2.0 N)")
    if not du0 < 2.0:
        fail("the card's cycle disagrees with the CPU cycle")
    out["launches"] = launches
    return out


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
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(host_identity())
    ident = card_identity()
    print(ident, flush=True)

    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    kkt = attractor_kkt(dev)
    kernels = [check_spd_inverse(kkt), check_admm_chunk(dev)]
    del kkt
    torch.cuda.empty_cache()

    path = main_path(dev)
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        k["launches"] = path["launches"][k["name"]]
    kernels = [{key: k[key] for key in order} for k in kernels]
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
