"""The port's CUDA kernels against their plain versions — needs the card.

Marked ``cuda``; each test skips when no CUDA device is present (decided
inside the test). Imports no JAX: the inputs are built in torch from a numpy
seed (``chip_smoke.structured_problem``). The repo's ``tests/conftest.py``
configures JAX, so on a machine without JAX run, from the repo root:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Bars as in tests/test_torch_mpc.py: spd_inverse within 5e-5 x max|plain|
with |A out - I| < 1e-4 on a random SPD batch (n = 32 up to 480: the smallest
tile count, the largest n whose packed working set fits in shared memory at
several CTAs per SM, n = 352 and 384 split over a cluster of 2 CTAs, 416 and
480 in device memory; B = 1 and B = 133 at n = 192 and 384), a matrix
failing at its first pivot and one failing only in its last panel all NaN
and their neighbours finite; on the solver's KKT at attractor-region rho at
horizons 16 and 32, spd_inverse's error and residual against the f64
inverse at most twice the plain version's; the structured ADMM chunk
bitwise equal to its plain version (nb = 40, 64, 96, 128: horizons 10, 16, 24, 32;
nb = 40 and 100 run the kernel's generic instances), and at nb = 96 (one
slot in clusters of 3) and nb = 128 (three slots in clusters of 8) also at
B = 1, 7, 133, 512 and 2,561 after 1, 2, 25 and 150 iterations, with
``admm_slotted`` counted once a launch at nb = 128 and never at the other
sizes, which run one slot. As in
tests/test_torch_tick_fused.py and tests/test_torch_fixed.py: the fused tick
window within 5e-3 per channel over 20 ticks and 2e-4 over one tick, masks
equal (the tick battery comes from ``chip_smoke.tick_battery``, also on a
duty = 1 gait; at ragged B, up to ``chip_smoke.MAX_FLIPS`` scenarios that
took another contact branch within rounding are excused, as in
``chip_smoke.py``), and its launch one block of four lanes per scenario; the dense
ADMM iterations within rtol and atol 2e-4 (``chip_smoke.dense_problem``,
A (448, 192), and the condensed QP at horizons 24 and 32, A (672, 288) and
(896, 384)) and, on the full form's ``chip_smoke.full_form_problem`` (A
(640, 384), and at horizons 24 and 32 A (960, 576) and (1280, 768)), within
twice the plain version's error against the f64 iterations
(``chip_smoke.dense_f64_errors``), each shape on the instance and cluster
``dense_cluster_shape`` reports (A and Minv on chip in clusters of 8 up to
(672, 288) and (640, 384); A through the TMA ring in clusters of 8 at (896,
384) and (960, 576), of 16 at (1280, 768)), the ring's shapes also after 1,
2, 7 and 10 iterations at B = 1 and B = 133, A (1904, 816) on the
instance that reads A and Minv from device memory, and an n that is not a
multiple of 4 (A (21, 30)) padded and launched; the tick window also on
``chip_smoke.hetero_battery`` (each scenario's own gait and contact).
The horizon-24 production cycle and the full-form legacy cycle at B = 8
(horizons 16 and 24) agree with the same cycles on the CPU within 2.0 N of
applied force. A CUDA
state round-trips ``utils.checkpoint`` bitwise (and so does its next cycle),
and ``utils.profiling.time_fn`` of a kernel-2 chunk is within 20% of its
CUDA-event time. A profiled fused cycle at B = 64 names its stages with
host-only spans: no device event carries an ``mpc.`` name, the benchmark's
trace finds no device work without a launch, and the KKT factorizations
and polish solves counted add up to the kernel 1 launches. The solver's
refactor of only the scenarios whose rho moved (``admm._refactor``: 37 of
200 on the production KKT at horizons 32, 16 and 10, one of them not SPD)
equals the whole batch's factorization bit for bit (NaN in that row alone),
writes ``Minv`` in place, launches kernel 1 once and never waits on the
card. The adapt step's two kernels (``kernels.adapt_check``, ``adapt_rho``)
equal their plain versions bit for bit (nb = 40, 64, 96, 128; B = 1, 7, 512;
a NaN row; every chunk kind of ``adapt_rho``, and its log test packed around
its threshold; strided operands); a horizon-16 ``solve_adaptive`` through
them agrees with the CPU's within 2.0 N of first-step force; and a profiled
production cycle counts ``adapt_fused`` 40 times and launches no cuBLAS GEMV
from inside an ``mpc.solve.adapt`` span.
"""

from __future__ import annotations

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (  # noqa: E402
    ADAPT_RHO_CASES, ADAPT_SETTINGS, MAX_FLIPS, adapt_problem, adapt_rho_kwargs,
    adapt_rho_problem, attractor_kkt, dense_f64_errors, dense_problem, dense_problem_at,
    first_kkt_setup, fixed_kwargs, full_form_problem, hetero_battery, launches,
    random_dense_problem, rounding_flips, spd_batch, spd_kkt_errors, spd_nonspd, start_batch,
    structured_problem, tick_battery, window_misses)

from convex_mpc_tpu_torch.mpc import admm as TA  # noqa: E402
from convex_mpc_tpu_torch.mpc import kernels as TK  # noqa: E402
from convex_mpc_tpu_torch.ops import chol_kernel as TCK  # noqa: E402
from convex_mpc_tpu_torch.sim import engine as TE  # noqa: E402
from convex_mpc_tpu_torch.sim import tick_fused as TTF  # noqa: E402
from convex_mpc_tpu_torch.utils import config as TCFG  # noqa: E402
from convex_mpc_tpu_torch.utils import interop, profiling  # noqa: E402

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

# kernel 2's launch at nb = 40 and 64 on the H100 SXM (132 SMs): (CTAs a
# cluster, clusters resident, slots), as it was before slots existed
STRUCTURED_SHAPES = {40: (2, 264, 1), 64: (2, 198, 1)}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")


def _check_spd(A, bad=()):
    """spd_inverse on A: one launch, the matrices in ``bad`` all NaN, the
    others finite and within the bars of the plain version."""
    n = A.shape[-1]
    before = launches()
    out = TCK.spd_inverse(A)
    torch.cuda.synchronize()
    assert launches(before)["spd_inverse"] == 1
    ref = TCK.spd_inverse_plain(A)
    keep = torch.ones(A.shape[0], dtype=torch.bool, device="cuda")
    keep[list(bad)] = False
    assert torch.isnan(out[~keep]).all()
    out, ref, A = out[keep], ref[keep], A[keep]
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 5e-5 * ref.abs().max().item()
    assert (A @ out - torch.eye(n, device="cuda")).abs().max().item() < 1e-4


@pytest.mark.parametrize("n", [32, 96, 192, 224, 256, 288, 352, 384, 416, 480])
def test_spd_inverse_kernel_matches_plain(n):
    _need_cuda()
    A = spd_batch(16, n, 7, torch.device("cuda"))
    spd_nonspd(A, 3, 9)  # 3 fails at its first pivot, 9 only in its last panel
    _check_spd(A, bad=(3, 9))


@pytest.mark.parametrize("horizon", [10, 12, 14, 18, 20])
def test_spd_inverse_kernel_at_horizon_orders(horizon):
    """n = 12 x horizon off the 32-grid (120, 144, 168, 216, 240): on its
    16-row panel grid, padded where n is not a multiple of 16, at B = 200
    with two matrices not SPD; the n = 192 test's bars."""
    _need_cuda()
    n = 12 * horizon
    A = spd_batch(200, n, 13, torch.device("cuda"))
    spd_nonspd(A, 3, 150)
    _check_spd(A, bad=(3, 150))


@pytest.mark.parametrize("n", [37, 348, 436])
def test_spd_inverse_kernel_any_order(n):
    """Orders padded in each instance: a cluster of 2 (348 on 352), the
    scratch (436 on 448), and rows that are not 16-byte aligned (37 on 48),
    which run the scratch instance at any n."""
    _need_cuda()
    A = spd_batch(16, n, 3, torch.device("cuda"))
    spd_nonspd(A, 2, 11)
    _check_spd(A, bad=(2, 11))
    grid = TCK.grid_order(n)
    if n % 4:
        smem, scratch, resident, csize = TCK.spd_inverse_shape(n)
        assert (smem, scratch, csize) == (0, grid * (grid + 4) // 2, 1) and resident >= 1
    else:
        assert TCK.spd_inverse_shape(n) == TCK.spd_inverse_shape(grid)


@pytest.mark.parametrize("n", [192, 384])
@pytest.mark.parametrize("B", [1, 133])
def test_spd_inverse_kernel_batch_sizes(B, n):
    """One matrix, and more matrices than the card has SMs (132), in one CTA
    (n = 192) and in clusters of 2 (n = 384)."""
    _need_cuda()
    _check_spd(spd_batch(B, n, 5, torch.device("cuda")))


@pytest.mark.parametrize("horizon", [16, 32])
def test_spd_inverse_kernel_on_attractor_kkt(horizon):
    """The solver's KKT at attractor-region rho (cond ~1e4, B = 512, n = 192
    at horizon 16 and 384 at horizon 32): the kernel finite, its error and
    residual against the f64 inverse at most twice the plain version's."""
    _need_cuda()
    k = spd_kkt_errors(attractor_kkt(torch.device("cuda"), horizon=horizon))
    assert k["within_bar"], k


def test_spd_inverse_shape():
    """The C side's choice: n = 192 on chip in one CTA with at least 2 CTAs
    per SM, 288 on chip in one CTA; 384 split over a cluster of 2 CTAs, each
    with its half of the panels, two staging slots of 16 n floats and the
    peer's diagonal blocks (216,576 B), no scratch; 480 in a scratch of
    n (n + 4) / 2 floats per matrix."""
    _need_cuda()
    smem, scratch, resident, csize = TCK.spd_inverse_shape(192)
    assert (smem, scratch, csize) == (192 * 196 * 2, 0, 1) and resident >= 2
    smem, scratch, resident, csize = TCK.spd_inverse_shape(288)
    assert (smem, scratch, csize) == (288 * 292 * 2, 0, 1) and resident >= 1
    smem, scratch, resident, csize = TCK.spd_inverse_shape(384)
    assert (smem, scratch, csize) == (216576, 0, 2) and resident >= 1
    smem, scratch, resident, csize = TCK.spd_inverse_shape(480)
    assert (smem, scratch, csize) == (0, 480 * 484 // 2, 1) and resident >= 1


def _slotted() -> int:
    return profiling.counts().get("admm_slotted", 0)


@pytest.mark.parametrize("nb", [40, 64, 96, 100, 128])
@pytest.mark.parametrize("iters", [1, 25, 150])
def test_admm_kernel_matches_plain(iters, nb):
    """One launch, bit for bit the plain version; ``admm_slotted`` counted
    once where a CTA runs several scenarios (nb = 128) and nowhere else."""
    _need_cuda()
    args = structured_problem(8, nb, seed=11, dev=torch.device("cuda"))
    before, slotted = launches(), _slotted()
    out = TK.admm_iterations_structured(*args, iters=iters)
    torch.cuda.synchronize()
    assert launches(before)["admm_iterations_structured"] == 1
    assert _slotted() - slotted == (1 if nb == 128 else 0)
    ref = TK.admm_iterations_structured_plain(*args, iters=iters)
    for a, b in zip(out, ref):
        assert torch.equal(a, b), (a - b).abs().max().item()


@functools.lru_cache(maxsize=1)
def _structured_case(B: int, nb: int):
    return structured_problem(B, nb, seed=17, dev=torch.device("cuda"))


# (nb, B, iters): batches that leave slots of the last cluster empty (1, 7,
# 133), fewer scenarios than the card holds at once, and more (B = 2,561)
WIDE_CASES = [(nb, B, iters) for nb in (96, 128) for B in (1, 7, 133, 512, 2561)
              for iters in (1, 2, 25, 150)]


@pytest.mark.parametrize("nb,B,iters", WIDE_CASES)
def test_admm_kernel_wide_matches_plain(nb, B, iters):
    """The launches above nz = 256 (nb = 96: one slot, two CTAs an SM; nb =
    128: three slots a CTA) at every batch and iteration count: one launch,
    ``admm_slotted`` counted once where the launch has slots, x, z and y bit
    for bit the plain version's."""
    _need_cuda()
    args = _structured_case(B, nb)
    before, slotted = launches(), _slotted()
    out = TK.admm_iterations_structured(*args, iters=iters)
    torch.cuda.synchronize()
    assert launches(before)["admm_iterations_structured"] == 1
    assert _slotted() - slotted == (1 if TK.structured_cluster_shape(nb)[2] > 1 else 0)
    ref = TK.admm_iterations_structured_plain(*args, iters=iters)
    for a, b in zip(out, ref):
        assert torch.equal(a, b), (a - b).abs().max().item()


def test_structured_cluster_shape():
    """nb = 40, 64 and 100 keep their launch (one slot in clusters of 2, as
    many resident as before; on the H100 SXM's 132 SMs). Above nz = 256 the launch
    keeps more scenarios resident than one slot in the smallest cluster did
    (66 at nb = 96 in clusters of 2, 39 at nb = 128 in clusters of 3): nb =
    96 one slot in clusters of 3, two CTAs an SM; nb = 128 three slots in
    clusters of 8."""
    _need_cuda()
    for nb, shape in STRUCTURED_SHAPES.items():
        assert TK.structured_cluster_shape(nb) == shape
    csize, resident, slots = TK.structured_cluster_shape(96)
    assert (csize, slots) == (3, 1) and resident > 66
    csize, resident, slots = TK.structured_cluster_shape(128)
    assert (csize, slots) == (8, 3) and 3 * resident > 39
    csize, resident, slots = TK.structured_cluster_shape(100)  # the generic instance
    assert (csize, slots) == (2, 1) and resident >= 1


def _tick_window_pair(B, steps, seed, duty=0.6):
    """The kernel's window (one launch) and the plain version's on one battery."""
    args = tick_battery(B, seed=seed, dev=torch.device("cuda"), duty=duty)
    before = launches()
    out = TTF.run_ticks_fused(*args, steps, 45.0, 1e-3, 30.0)
    torch.cuda.synchronize()
    assert launches(before)["run_ticks_fused"] == 1
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
    before = launches()
    out = TK.admm_iterations(*args, iters=iters)
    torch.cuda.synchronize()
    assert launches(before)["admm_iterations"] == 1
    ref = TK.admm_iterations_plain(*args, iters=iters)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)


def test_horizon24_cycle_card_vs_cpu():
    """One production cycle at horizon 24 (nz = 288) on the card and on the CPU."""
    _need_cuda()
    kw = TCFG.engine_kwargs_batched(TCFG.EngineConfig(mpc=TCFG.MpcConfig(horizon=24)))
    dyn, *batch = start_batch(8, torch.device("cuda"), 24)
    cpu = lambda tree: interop.tree_map(lambda x: x.cpu(), tree)  # noqa: E731
    before = launches()
    s_gpu, _ = TE.mpc_cycle_batch(dyn, *batch, **kw)
    torch.cuda.synchronize()
    after = launches(before)
    assert after["spd_inverse"] > 0 and after["admm_iterations_structured"] > 0
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
    csize, resident, smem, inst = TK.dense_cluster_shape(640, 384)
    assert csize == 8 and resident >= 1 and 116224 < smem <= 232448 and inst == 0
    assert 0 < TK.dense_cluster_shape(448, 192)[2] <= 116224
    before = launches()
    out = TK.admm_iterations(*args, iters=iters)
    torch.cuda.synchronize()
    assert launches(before)["admm_iterations"] == 1
    ref = TK.admm_iterations_plain(*args, iters=iters)
    d = dense_f64_errors(out, ref, args, iters)
    assert d["within_bar"], d


def _check_dense(form, args, iters):
    """One launch of the dense iterations, within the bar of its form."""
    before = launches()
    out = TK.admm_iterations(*args, iters=iters)
    torch.cuda.synchronize()
    assert launches(before)["admm_iterations"] == 1
    ref = TK.admm_iterations_plain(*args, iters=iters)
    if form == "condensed":
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)
    else:
        d = dense_f64_errors(out, ref, args, iters)
        assert d["within_bar"], d


@pytest.mark.parametrize("form, horizon, instance, ctas", [
    ("condensed", 24, 0, 8), ("condensed", 32, 1, 8), ("full form", 24, 1, 8),
    ("full form", 32, 1, 16)])
def test_admm_dense_kernel_longer_horizons(form, horizon, instance, ctas):
    """The legacy path's A at horizons 24 and 32, B = 8, 25 iterations: the
    instance the launcher reports (an index into ``DENSE_INSTANCES``) and
    its CTAs per cluster, at least one cluster resident, one launch, and the
    bar of its form."""
    _need_cuda()
    args = dense_problem_at(form, horizon, 8, torch.device("cuda"))
    m, n = args[0].shape[1:]
    assert (m, n) == ((28 * horizon, 12 * horizon) if form == "condensed"
                      else (40 * horizon, 24 * horizon))
    csize, resident, smem, inst = TK.dense_cluster_shape(m, n)
    assert (csize, inst) == (ctas, instance) and resident >= 1 and 0 < smem <= 232448
    _check_dense(form, args, 25)


_RING_PROBLEMS: dict = {}


@pytest.mark.parametrize("B", [1, 133])
@pytest.mark.parametrize("iters", [1, 2, 7, 10])
@pytest.mark.parametrize("form, horizon", [("condensed", 32), ("full form", 24),
                                           ("full form", 32)])
def test_admm_dense_ring_short_launches(form, horizon, iters, B):
    """The ring instance's shapes at the legacy solver's launch lengths (at
    most 10 iterations; 1, 2 and 7 where a prologue or an odd count would
    break the pass order), at B = 1 and at B = 133 (not a multiple of the
    resident clusters): one launch each, within the bar of its form."""
    _need_cuda()
    key = (form, horizon, B)
    if key not in _RING_PROBLEMS:  # six problems, built once each (~1.4 GB at most)
        _RING_PROBLEMS[key] = dense_problem_at(form, horizon, B, torch.device("cuda"))
    args = _RING_PROBLEMS[key]
    assert TK.dense_cluster_shape(*args[0].shape[1:])[3] == 1
    _check_dense(form, args, iters)


@pytest.mark.parametrize("iters", [1, 7])
def test_admm_dense_kernel_pads_n(iters):
    """n = 30, not a multiple of 4: the wrapper pads n to 32, launches once
    and returns x of width 30, within rtol and atol 2e-4 of the plain
    version."""
    _need_cuda()
    args = random_dense_problem(8, 21, 30, seed=3, dev=torch.device("cuda"))
    before = launches()
    out = TK.admm_iterations(*args, iters=iters)
    torch.cuda.synchronize()
    assert launches(before)["admm_iterations"] == 1
    ref = TK.admm_iterations_plain(*args, iters=iters)
    assert tuple(out[0].shape) == (8, 30)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("iters", [1, 7])
def test_admm_dense_kernel_streams_both(iters):
    """The structured problem written out dense at nb = 272, A (1904, 816):
    wider than the ring's n <= 768, so the instance that reads A and Minv
    from device memory; one launch, within rtol and atol 2e-4 of the plain
    version."""
    _need_cuda()
    args = dense_problem(8, 272, seed=11, dev=torch.device("cuda"))
    csize, resident, smem, inst = TK.dense_cluster_shape(1904, 816)
    assert (csize, inst) == (8, 2) and resident >= 1
    _check_dense("condensed", args, iters)


@pytest.mark.parametrize("horizon", [16, 24])
def test_full_form_cycle_card_vs_cpu(horizon):
    """One legacy cycle on the full form at B = 8 on the card and on the CPU
    (A (640, 384) and (960, 576))."""
    _need_cuda()
    dyn, gait, contact, sched, state = start_batch(8, torch.device("cuda"), horizon)
    full = TE.init_state(dyn, n=horizon, formulation="full").solver
    state = state._replace(solver=TE.broadcast_batch(full, 8))
    batch = (gait, contact, sched, state)
    kw = fixed_kwargs(horizon, "full")
    cpu = lambda tree: interop.tree_map(lambda x: x.cpu(), tree)  # noqa: E731
    before = launches()
    s_gpu, _ = TE.mpc_cycle_fixed(dyn, *batch, **kw)
    torch.cuda.synchronize()
    assert launches(before)["admm_iterations"] > 0
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

    args = structured_problem(512, 64, seed=11, dev=torch.device("cuda"))
    chunk = lambda: TK.admm_iterations_structured(*args, iters=25)  # noqa: E731
    t_fn = profiling.time_fn(chunk, reps=10) * 1e3
    t_ev = cuda_ms(chunk)
    assert abs(t_fn - t_ev) <= 0.2 * t_ev, (t_fn, t_ev)


def test_profiled_cycle_spans_are_host_only():
    _need_cuda()
    from benchmark.trace import Trace

    dev = torch.device("cuda")
    dyn, gait, contact, sched, state = start_batch(64, dev)
    kw = TCFG.engine_kwargs_batched(TCFG.DEFAULT_CONFIG)
    kw["use_fused_ticks"] = True
    state, _ = TE.mpc_cycle_batch(dyn, gait, contact, sched, state, **kw)  # builds, warms
    torch.cuda.synchronize()
    profiling.reset_counts()
    before = launches()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        TE.mpc_cycle_batch(dyn, gait, contact, sched, state, **kw)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    named = [e for e in events if e.name().startswith("mpc.")]
    assert {e.name() for e in named} >= {"mpc.cycle", "mpc.update", "mpc.solve", "mpc.apply",
                                         "mpc.solve.chunk", "mpc.solve.read.flags"}
    assert all(e.device_type() != torch.autograd.DeviceType.CUDA for e in named)
    assert not any(e.is_user_annotation() for e in named)
    assert Trace(events, 1, 1.0).unmatched_device == 0
    c = profiling.counts()
    assert c["cycles"] == 1
    assert c["kkt_factorizations"] + c["polish_solves"] == launches(before)["spd_inverse"]


@pytest.mark.parametrize("horizon", [32, 16, 10])
def test_subset_refactor_bitwise_on_card(horizon):
    """37 of 200 scenarios move their rho (one to a non-SPD M): the subset
    refactor through kernel 1 (n = 384, 192, and horizon 10's nz = 120 on
    its padded grid of 128) equals the whole-batch factorization bit for
    bit, in place, with no host synchronisation."""
    _need_cuda()
    dev = torch.device("cuda")
    B, k = 200, 37
    setup = first_kkt_setup(dev, horizon, B)
    g = torch.Generator().manual_seed(17)
    rho = torch.logspace(-4, -1, B)[torch.randperm(B, generator=g)].to(dev)
    rows = torch.randperm(B, generator=g)[:k].to(dev)
    changed = torch.zeros(B, dtype=torch.bool, device=dev)
    changed[rows] = True
    rho_new = torch.where(changed, rho * 0.1, rho)
    rho_new[rows[0]] = -1e3  # M(rho) indefinite: NaN in this row alone
    Minv = TA._factorize(setup, rho)
    whole = TA._factorize(setup, rho_new)
    torch.cuda.synchronize()
    before = launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = TA._refactor(setup, rho_new, Minv, changed, k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert out is Minv
    assert launches(before)["spd_inverse"] == 1
    assert torch.isnan(out[rows[0]]).all()
    assert torch.isfinite(out[torch.arange(B, device=dev) != rows[0]]).all()
    torch.testing.assert_close(out, whole, rtol=0, atol=0, equal_nan=True)


def _bitwise(out, ref):
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("nb", [40, 64, 96, 128])
@pytest.mark.parametrize("B", [1, 7, 512])
def test_adapt_check_kernel_bitwise_plain(B, nb):
    """adapt_check (one launch) equals its plain version on the card bit for
    bit at horizons 10-32, a NaN row's residuals NaN and the row open."""
    _need_cuda()
    nan_row = 3 if B >= 7 else None
    p = adapt_problem(B, nb, 13, torch.device("cuda"), nan_row=nan_row)
    kw = dict(iters_done=100, eps_abs=2.0, eps_rel=0.8, **ADAPT_SETTINGS)
    before = launches()
    out = TK.adapt_check(*p.values(), **kw)
    torch.cuda.synchronize()
    assert launches(before)["adapt_check"] == 1
    _bitwise(out, TK.adapt_check_plain(*p.values(), **kw))
    if nan_row is not None:
        assert torch.isnan(out[0][nan_row]) and torch.isnan(out[1][nan_row])
        assert bool(out[3][nan_row]) == bool(p["converged"][nan_row])
    assert int(out[5]) == int((~out[3]).sum())


@pytest.mark.parametrize("case", list(ADAPT_RHO_CASES))
@pytest.mark.parametrize("B", [1, 7, 512])
def test_adapt_rho_kernel_bitwise_plain(B, case):
    """adapt_rho (one launch) equals its plain version on the card bit for bit
    in every chunk kind, with a NaN row; its two counts exact."""
    _need_cuda()
    v = adapt_rho_problem(B, 17, torch.device("cuda"), nan_row=5 if B >= 7 else None)
    before = launches()
    out = TK.adapt_rho(*v.values(), **adapt_rho_kwargs(case))
    torch.cuda.synchronize()
    assert launches(before)["adapt_rho"] == 1
    _bitwise(out, TK.adapt_rho_plain(*v.values(), **adapt_rho_kwargs(case)))
    assert out[5].tolist() == [int(out[2].sum()), int((~out[3]).sum())]


def test_adapt_rho_kernel_log_test_near_threshold():
    """65,536 open scenarios whose descent ratio lies within a few ulp of
    1 / 5 on either side: the kernel's logf decides |log(rho_desc / rho)| >
    log 5 as torch.log does, row for row."""
    _need_cuda()
    v = adapt_rho_problem(1 << 16, 19, torch.device("cuda"), log_sweep=True)
    kw = adapt_rho_kwargs("adapt boundary")
    out = TK.adapt_rho(*v.values(), **kw)
    ref = TK.adapt_rho_plain(*v.values(), **kw)
    _bitwise(out, ref)
    assert 0 < int(out[5][0]) < 1 << 16


def test_adapt_kernels_on_strided_operands():
    """Both kernels on strided operands, each pair of one size (x and x_prev,
    x and d, pr and dr interleaved; rho one scenario's, expanded): bit for
    bit their plain versions on the same views and the kernel on
    contiguous copies."""
    _need_cuda()
    dev = torch.device("cuda")
    p = adapt_problem(512, 64, 13, dev, nan_row=3)
    kw = dict(iters_done=100, eps_abs=2.0, eps_rel=0.8, **ADAPT_SETTINGS)
    s = dict(p, rho=p["rho"][:1].expand(512))
    s["x"], s["x_prev"] = torch.stack([p["x"], p["x_prev"]], dim=-1).unbind(-1)
    assert not (s["x"].is_contiguous() or s["x_prev"].is_contiguous() or s["rho"].is_contiguous())
    out = TK.adapt_check(*s.values(), **kw)
    _bitwise(out, TK.adapt_check_plain(*s.values(), **kw))
    _bitwise(out, TK.adapt_check(*(t.contiguous() for t in s.values()), **kw))
    v = adapt_rho_problem(512, 17, dev, nan_row=5)
    r = dict(v, rho=v["rho"][:1].expand(512))
    r["x"], r["d"] = torch.stack([v["x"], v["d"]], dim=-1).unbind(-1)
    r["pr"], r["dr"] = torch.stack([v["pr"], v["dr"]], dim=-1).unbind(-1)
    r_kw = adapt_rho_kwargs("mid-loop polish")
    out = TK.adapt_rho(*r.values(), **r_kw)
    _bitwise(out, TK.adapt_rho_plain(*r.values(), **r_kw))
    _bitwise(out, TK.adapt_rho(*(t.contiguous() for t in r.values()), **r_kw))


def test_solve_adaptive_h16_card_vs_cpu():
    """One solve_adaptive of the production cycle's first QP batch at horizon
    16 (B = 8) on the card (adapt_check and adapt_rho every chunk) and on the
    CPU (their plain versions): first-step forces within 2.0 N."""
    _need_cuda()
    from convex_mpc_tpu_torch.mpc import condensed as TC

    dev = torch.device("cuda")
    kw = TCFG.engine_kwargs_batched(TCFG.DEFAULT_CONFIG)
    dyn, gait_b, _, sched_b, state_b = start_batch(8, dev)
    qd = torch.as_tensor(kw["q_diag"], dtype=torch.float32, device=dev)
    data = TE.cycle_update(dyn, gait_b, sched_b, state_b, qd, kw["n"], kw["mpc_dt"],
                           kw["r_value"], kw["mu_mpc"], kw["fz_min"])[0]
    solve = dict(max_iter=kw["solver_iters"], check_every=kw["check_every"],
                 box_tail=12 * kw["n"], stall_tol=kw["stall_tol"], polish=kw["polish"],
                 nu=TC.NU)
    before = launches()
    s_gpu = TA.solve_adaptive(data, state_b.solver, **solve)
    torch.cuda.synchronize()
    counted = launches(before)
    chunks = counted["adapt_check"]
    assert chunks > 0 and counted["adapt_rho"] == chunks
    cpu = lambda tree: interop.tree_map(lambda x: x.cpu(), tree)  # noqa: E731
    s_cpu = TA.solve_adaptive(cpu(data), cpu(state_b.solver), **solve)
    du0 = (s_gpu.x[:, :12].cpu() - s_cpu.x[:, :12]).abs().max().item()
    assert du0 < 2.0, du0  # Newtons


def _device_ops_by_span(events):
    """Each device operation's name and the innermost ``mpc.`` span open on
    the host when its launch was called."""
    import bisect

    dev_t = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type() != dev_t]
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in host
                   if e.name().startswith("mpc."))
    starts = [s for s, _, _ in spans]
    launch = {e.correlation_id(): e.start_ns() for e in host
              if e.name().startswith(("cudaLaunchKernel", "cuLaunchKernel"))}
    out = []
    for e in events:
        if e.device_type() != dev_t or e.correlation_id() not in launch:
            continue
        t = launch[e.correlation_id()]
        inner = [sp for sp in spans[:bisect.bisect_right(starts, t)] if sp[1] >= t]
        out.append((e.name(), min(inner, key=lambda sp: sp[1] - sp[0])[2] if inner else None))
    return out


def test_profiled_cycle_adapt_fused_without_gemv():
    """A profiled production cycle at B = 256 (horizon 16, fused ticks, from
    a settled state) runs the 40-chunk cap: the solve counts adapt_fused
    once a chunk, 40, each kernel launches once a chunk, and no cuBLAS GEMV
    runs from inside an ``mpc.solve.adapt`` span."""
    _need_cuda()
    dev = torch.device("cuda")
    dyn, gait, contact, sched, state = start_batch(256, dev)
    kw = TCFG.engine_kwargs_batched(TCFG.DEFAULT_CONFIG)
    kw["use_fused_ticks"] = True
    for _ in range(2):
        state, _ = TE.mpc_cycle_batch(dyn, gait, contact, sched, state, **kw)
    torch.cuda.synchronize()
    profiling.reset_counts()
    before = launches()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        TE.mpc_cycle_batch(dyn, gait, contact, sched, state, **kw)
        torch.cuda.synchronize()
    c = profiling.counts()
    assert c["adapt_fused"] == c["host_reads.flags"] == launches(before)["adapt_check"] == 40, c
    ops = _device_ops_by_span(prof.profiler.kineto_results.events())
    in_adapt = [n for n, sp in ops if sp == "mpc.solve.adapt"]
    assert sum("adapt_check" in n for n in in_adapt) == 40
    assert sum("adapt_rho" in n for n in in_adapt) == 40
    assert not [n for n in in_adapt if "gemv" in n.lower()]
