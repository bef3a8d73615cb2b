"""The port's CUDA kernels against their plain versions — needs the card.

Marked ``cuda``; each test skips when no CUDA device is present (decided
inside the test). Imports no JAX: the inputs are built in torch from a numpy
seed (``chip_smoke.structured_problem``). The repo's ``tests/conftest.py``
configures JAX, so on a machine without JAX run, from the repo root:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Bars as in tests/test_torch_mpc.py: spd_inverse within 5e-5 x max|plain|
with |A out - I| < 1e-4 on a random SPD batch (n = 32 up to 384: the smallest
tile count, the largest n whose packed working set fits in shared memory at
several CTAs per SM, and n = 384 with it in device memory; B = 1 and
B = 133), a matrix failing at its first pivot and one failing only in its
last panel all NaN and their neighbours finite; on the solver's KKT at
attractor-region rho, spd_inverse's error and residual against the f64
inverse at most twice the plain version's; the structured ADMM chunk
bitwise equal to its plain version (nb = 64, 96, 128: horizons 16, 24, 32). As in
tests/test_torch_tick_fused.py and tests/test_torch_fixed.py: the fused tick
window within 5e-3 per channel over 20 ticks and 2e-4 over one tick, masks
equal (the tick battery comes from ``chip_smoke.tick_battery``, also on a
duty = 1 gait; at ragged B, up to ``chip_smoke.MAX_FLIPS`` scenarios that
took another contact branch within rounding are excused, as in
``chip_smoke.py``), and its launch one block of four lanes per scenario; the dense
ADMM iterations within rtol and atol 2e-4 (``chip_smoke.dense_problem``,
A (448, 192)) and, on the full form's ``chip_smoke.full_form_problem`` (A
(640, 384)), within twice the plain version's error against the f64
iterations (``chip_smoke.dense_f64_errors``), and at A (960, 576) a raise,
not a launch; the tick window also on
``chip_smoke.hetero_battery`` (each scenario's own gait and contact).
The horizon-24 production cycle and the full-form legacy cycle at B = 8
agree with the same cycles on the CPU within 2.0 N of applied force. A CUDA
state round-trips ``utils.checkpoint`` bitwise (and so does its next cycle),
and ``utils.profiling.time_fn`` of a kernel-2 chunk is within 20% of its
CUDA-event time.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (  # noqa: E402
    MAX_FLIPS, attractor_kkt, dense_f64_errors, dense_problem, full_form_problem,
    hetero_battery, rounding_flips,
    spd_batch, spd_kkt_errors, spd_nonspd, start_batch, structured_problem, tick_battery,
    window_misses)

from convex_mpc_tpu_torch.mpc import kernels as TK  # noqa: E402
from convex_mpc_tpu_torch.ops import chol_kernel as TCK  # noqa: E402
from convex_mpc_tpu_torch.sim import engine as TE  # noqa: E402
from convex_mpc_tpu_torch.sim import tick_fused as TTF  # noqa: E402
from convex_mpc_tpu_torch.utils import config as TCFG  # noqa: E402
from convex_mpc_tpu_torch.utils import interop  # noqa: E402

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")


def _check_spd(A, bad=()):
    """spd_inverse on A: one launch, the matrices in ``bad`` all NaN, the
    others finite and within the bars of the plain version."""
    n = A.shape[-1]
    before = TCK.spd_inverse.launches
    out = TCK.spd_inverse(A)
    torch.cuda.synchronize()
    assert TCK.spd_inverse.launches == before + 1
    ref = TCK.spd_inverse_plain(A)
    keep = torch.ones(A.shape[0], dtype=torch.bool, device="cuda")
    keep[list(bad)] = False
    assert torch.isnan(out[~keep]).all()
    out, ref, A = out[keep], ref[keep], A[keep]
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 5e-5 * ref.abs().max().item()
    assert (A @ out - torch.eye(n, device="cuda")).abs().max().item() < 1e-4


@pytest.mark.parametrize("n", [32, 96, 192, 224, 256, 288, 384])
def test_spd_inverse_kernel_matches_plain(n):
    _need_cuda()
    A = spd_batch(16, n, 7, torch.device("cuda"))
    spd_nonspd(A, 3, 9)  # 3 fails at its first pivot, 9 only in its last panel
    _check_spd(A, bad=(3, 9))


@pytest.mark.parametrize("B", [1, 133])
def test_spd_inverse_kernel_batch_sizes(B):
    """One matrix, and more matrices than the card has SMs (132)."""
    _need_cuda()
    _check_spd(spd_batch(B, 192, 5, torch.device("cuda")))


def test_spd_inverse_kernel_on_attractor_kkt():
    """The solver's KKT at attractor-region rho (cond ~1e4, B = 512, n = 192):
    the kernel finite, its error and residual against the f64 inverse at
    most twice the plain version's."""
    _need_cuda()
    k = spd_kkt_errors(attractor_kkt(torch.device("cuda")))
    assert k["within_bar"], k


def test_spd_inverse_shape():
    """The C side's choice: n = 192 on chip with at least 2 CTAs per SM,
    288 on chip, 384 in a scratch of n (n + 4) / 2 floats per matrix."""
    _need_cuda()
    smem, scratch, ctas = TCK.spd_inverse_shape(192)
    assert (smem, scratch) == (192 * 196 * 2, 0) and ctas >= 2
    smem, scratch, ctas = TCK.spd_inverse_shape(288)
    assert (smem, scratch) == (288 * 292 * 2, 0) and ctas >= 1
    smem, scratch, ctas = TCK.spd_inverse_shape(384)
    assert (smem, scratch) == (0, 384 * 388 // 2) and ctas >= 1


@pytest.mark.parametrize("nb", [64, 96, 128])
@pytest.mark.parametrize("iters", [1, 25, 150])
def test_admm_kernel_matches_plain(iters, nb):
    _need_cuda()
    args = structured_problem(8, nb, seed=11, dev=torch.device("cuda"))
    before = TK.admm_iterations_structured.launches
    out = TK.admm_iterations_structured(*args, iters=iters)
    torch.cuda.synchronize()
    assert TK.admm_iterations_structured.launches == before + 1
    ref = TK.admm_iterations_structured_plain(*args, iters=iters)
    for a, b in zip(out, ref):
        assert torch.equal(a, b), (a - b).abs().max().item()


def _tick_window_pair(B, steps, seed, duty=0.6):
    """The kernel's window (one launch) and the plain version's on one battery."""
    args = tick_battery(B, seed=seed, dev=torch.device("cuda"), duty=duty)
    before = TTF.run_ticks_fused.launches
    out = TTF.run_ticks_fused(*args, steps, 45.0, 1e-3, 30.0)
    torch.cuda.synchronize()
    assert TTF.run_ticks_fused.launches == before + 1
    return args, out, TTF.run_ticks_fused_plain(*args, steps, 45.0, 1e-3, 30.0)


@pytest.mark.parametrize("B, steps, rel, duty", [(5, 20, 5e-3, 0.6), (64, 20, 5e-3, 0.6),
                                                 (64, 1, 2e-4, 0.6), (64, 20, 5e-3, 1.0)])
def test_tick_window_kernel_matches_plain(B, steps, rel, duty):
    _need_cuda()
    _, out, ref = _tick_window_pair(B, steps, 3, duty)
    miss, errs, _ = window_misses(out, ref, rel)
    assert not miss.any(), errs


@pytest.mark.parametrize("B", [13, 517])
def test_tick_window_kernel_ragged_batch(B):
    """An odd B, and one past the main path's 512. A block is one scenario,
    so no block is partly filled at any B: these hold the lane-group
    indexing at counts other than the main path's."""
    _need_cuda()
    args, out, ref = _tick_window_pair(B, 20, 2)
    miss, errs, _ = window_misses(out, ref, 5e-3)
    excused, margins = rounding_flips(out, ref, args[2])
    assert len(margins) <= MAX_FLIPS, margins
    assert not (miss & ~excused).any(), errs


def test_tick_window_shape():
    """A block of four lanes per scenario; on the H100's 132 SMs B = 512 fits
    in one resident wave."""
    _need_cuda()
    for B in (1, 5, 13, 512, 517, 8192):
        threads, blocks, resident = TTF.tick_window_shape(B)
        assert (threads, blocks) == (4, B) and resident >= 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if sms >= 132:
        assert sms * TTF.tick_window_shape(512)[2] >= 512


@pytest.mark.parametrize("iters", [1, 25, 50])
def test_admm_dense_kernel_matches_plain(iters):
    _need_cuda()
    args = dense_problem(8, 64, seed=11, dev=torch.device("cuda"))
    before = TK.admm_iterations.launches
    out = TK.admm_iterations(*args, iters=iters)
    torch.cuda.synchronize()
    assert TK.admm_iterations.launches == before + 1
    ref = TK.admm_iterations_plain(*args, iters=iters)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)


def test_horizon24_cycle_card_vs_cpu():
    """One production cycle at horizon 24 (nz = 288) on the card and on the CPU."""
    _need_cuda()
    kw = TCFG.engine_kwargs_batched(TCFG.EngineConfig(mpc=TCFG.MpcConfig(horizon=24)))
    dyn, *batch = start_batch(8, torch.device("cuda"), 24)
    cpu = lambda tree: interop.tree_map(lambda x: x.cpu(), tree)  # noqa: E731
    before = (TCK.spd_inverse.launches, TK.admm_iterations_structured.launches)
    s_gpu, _ = TE.mpc_cycle_batch(dyn, *batch, **kw)
    torch.cuda.synchronize()
    after = (TCK.spd_inverse.launches, TK.admm_iterations_structured.launches)
    assert after[0] > before[0] and after[1] > before[1]
    s_cpu, _ = TE.mpc_cycle_batch(cpu(dyn), *[cpu(a) for a in batch], **kw)
    du0 = (s_gpu.u0.cpu() - s_cpu.u0).abs().max().item()
    assert du0 < 2.0, du0  # Newtons


def test_tick_window_kernel_heterogeneous_battery():
    """B = 512 scenarios, each with its own gait (16 frequencies x 32
    duties) and contact (mu, kn): the flip rule of the ragged batches."""
    _need_cuda()
    args = hetero_battery(16, torch.device("cuda"))
    out = TTF.run_ticks_fused(*args, 20, 45.0, 1e-3, 30.0)
    torch.cuda.synchronize()
    ref = TTF.run_ticks_fused_plain(*args, 20, 45.0, 1e-3, 30.0)
    miss, errs, _ = window_misses(out, ref, 5e-3)
    excused, margins = rounding_flips(out, ref, args[2])
    assert len(margins) <= MAX_FLIPS, margins
    assert not (miss & ~excused).any(), errs


@pytest.mark.parametrize("iters", [1, 25, 50])
def test_admm_dense_kernel_full_form_matches_plain(iters):
    """A (640, 384): the full form's QP, one CTA per SM (A (448, 192) fits
    two)."""
    _need_cuda()
    args = full_form_problem(8, torch.device("cuda"))
    assert tuple(args[0].shape) == (8, 640, 384)
    csize, resident, smem = TK.dense_cluster_shape(640, 384)
    assert csize == 8 and resident >= 1 and 116224 < smem <= 232448
    assert 0 < TK.dense_cluster_shape(448, 192)[2] <= 116224
    before = TK.admm_iterations.launches
    out = TK.admm_iterations(*args, iters=iters)
    torch.cuda.synchronize()
    assert TK.admm_iterations.launches == before + 1
    ref = TK.admm_iterations_plain(*args, iters=iters)
    d = dense_f64_errors(out, ref, args, iters)
    assert d["within_bar"], d


def test_admm_dense_kernel_raises_where_nothing_fits():
    """The full form at horizon 24, A (960, 576): no cluster holds it; the
    wrapper raises with the shape and launches nothing."""
    _need_cuda()
    m, n = 960, 576
    assert TK.dense_cluster_shape(m, n)[1:] == (0, 0)
    args = [torch.zeros(s, device="cuda") for s in
            [(2, m, n), (2, n, n), (2, n), (2, m), (2, m), (2, m), (2, n), (2, m), (2, m)]]
    before = TK.admm_iterations.launches
    with pytest.raises(RuntimeError, match=r"A \(960, 576\)"):
        TK.admm_iterations(*args, iters=1)
    assert TK.admm_iterations.launches == before


def test_full_form_cycle_card_vs_cpu():
    """One legacy cycle on the full form at B = 8 on the card and on the CPU."""
    _need_cuda()
    dyn, gait, contact, sched, state = start_batch(8, torch.device("cuda"))
    full = TE.init_state(dyn, n=16, formulation="full").solver
    state = state._replace(solver=TE.broadcast_batch(full, 8))
    batch = (gait, contact, sched, state)
    kw = dict(solver_iters=150, formulation="full")
    cpu = lambda tree: interop.tree_map(lambda x: x.cpu(), tree)  # noqa: E731
    before = TK.admm_iterations.launches
    s_gpu, _ = TE.mpc_cycle_fixed(dyn, *batch, **kw)
    torch.cuda.synchronize()
    assert TK.admm_iterations.launches > before
    s_cpu, _ = TE.mpc_cycle_fixed(cpu(dyn), *[cpu(a) for a in batch], **kw)
    du0 = (s_gpu.u0.cpu() - s_cpu.u0).abs().max().item()
    assert du0 < 2.0, du0  # Newtons


def test_checkpoint_roundtrip_cuda_state(tmp_path):
    """A CUDA EngineState (B = 8, two cycles in) through utils.checkpoint:
    loaded bitwise equal on the card, and one cycle from it bitwise equal to
    one from the original."""
    _need_cuda()
    from convex_mpc_tpu_torch.utils import checkpoint

    dyn, gait, contact, sched, state = start_batch(8, torch.device("cuda"))
    kw = TCFG.engine_kwargs_batched(TCFG.DEFAULT_CONFIG)
    for _ in range(2):
        state, _ = TE.mpc_cycle_batch(dyn, gait, contact, sched, state, **kw)
    checkpoint.save_pytree(tmp_path / "state", state)
    loaded = checkpoint.load_pytree(tmp_path / "state", state)
    for a, b in zip(interop.tree_leaves(loaded), interop.tree_leaves(state)):
        assert a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
    a, _ = TE.mpc_cycle_batch(dyn, gait, contact, sched, state, **kw)
    b, _ = TE.mpc_cycle_batch(dyn, gait, contact, sched, loaded, **kw)
    for x, y in zip(interop.tree_leaves(a), interop.tree_leaves(b)):
        assert torch.equal(x, y)


def test_time_fn_matches_cuda_ms():
    """utils.profiling.time_fn of one structured chunk (B = 512, nb = 64, 25
    iterations) within 20% of the CUDA-event time."""
    _need_cuda()
    from chip_smoke import cuda_ms

    from convex_mpc_tpu_torch.utils import profiling

    args = structured_problem(512, 64, seed=11, dev=torch.device("cuda"))
    chunk = lambda: TK.admm_iterations_structured(*args, iters=25)  # noqa: E731
    t_fn = profiling.time_fn(chunk, reps=10) * 1e3
    t_ev = cuda_ms(chunk)
    assert abs(t_fn - t_ev) <= 0.2 * t_ev, (t_fn, t_ev)
