"""The H100's peaks and the least time a kernel's work needs on it.

Peaks: NVIDIA's H100 SXM data sheet at the full 700 W power limit, dense:
3.35 TB/s of HBM3 and 67 TFLOP/s in float32 outside the tensor cores. The
bound of a piece of work is the larger of its bytes over the first and its
operations over the second. Bytes count each input read once and each
output written once; operations count what the algorithm needs for the
work the cycle did (its iterations, its factorizations), never what a
kernel's launches happen to repeat, so that a share stays at or under 100%
whatever implements the work.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
F32 = 4


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time and what binds it."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spd_inverse_work(n: int, matrices: int) -> tuple[float, float]:
    """(bytes, operations) of inverting ``matrices`` SPD n x n matrices:
    Cholesky n^3/3, triangular inverse n^3/3, Gram n^3/3 flops each
    (LAPACK potrf + potri); the matrix in, its inverse out."""
    return 2.0 * matrices * n * n * F32, float(matrices) * n ** 3


def admm_structured_work(batch: int, nz: int, iters: int) -> tuple[float, float]:
    """(bytes, operations) of ``iters`` ADMM iterations on ``batch``
    condensed QPs of nz = 3 nb variables and m = 7 nb rows (friction blocks
    (nb, 4, 3), box diagonal, KKT inverse, q, l, u, rho and the x, z, y
    iterates in; x, z, y out). An iteration: the KKT matvec 2 nz^2, A'w
    10 nz, Av 6 * 4 nb + nz, the updates 12 m."""
    nb = nz // 3
    m = 7 * nb
    in_bytes = F32 * batch * (12 * nb + nz * nz + 3 * nz + 5 * m)
    out_bytes = F32 * batch * (nz + 2 * m)
    flops = float(batch) * iters * (2 * nz * nz + 10 * nz + 6 * 4 * nb + nz + 12 * m)
    return float(in_bytes + out_bytes), flops


# Operations of the fused tick window, worked out from its arithmetic with
# structural zeros and constant ones left out: a mul, add, sub, division,
# sqrt or transcendental counts 1, an FMA 2; compares, selects, min/max and
# negation 0 (copied from the count the port's bring-up made of
# csrc/tick_window.cu).
TICK_OPS = {
    "tick": 14824,       # every scenario-tick: the model, filter, per-leg contact, solves
    "swing_leg": 777,    # per leg in swing: trajectory and operational-space inertia
    "swing_tick": 1452,  # per scenario-tick with a leg in swing: the arrow factor of M
    "stance_leg": 15,    # per stance leg: tau = -Q' u0
    "early_leg": 30,     # per swing leg touching the ground: the early-contact force
    "active_leg": 427,   # per leg in contact: the contact terms of the implicit step
    "takeoff": 30,       # per leg taking off: hip offset and touchdown target
    "window": 12,        # per scenario: gait and filter constants
}


def tick_window_work(batch: int, steps: int, swing, active, touching, takeoff) -> tuple[float, float]:
    """(bytes, operations) of a window of ``steps`` ticks: ``swing``,
    ``active``, ``touching`` and ``takeoff`` are counts of leg-ticks (and
    ``swing_ticks`` of scenario-ticks with a leg in swing is the second
    entry of ``swing``: (leg-ticks, scenario-ticks)). Bytes: the carry (78
    floats) and inputs (35) read, the carry written, 71 log floats a tick,
    and 220 floats of constants."""
    swing_legs, swing_ticks = swing
    ops = (TICK_OPS["tick"] * batch * steps + TICK_OPS["window"] * batch
           + TICK_OPS["swing_leg"] * swing_legs + TICK_OPS["swing_tick"] * swing_ticks
           + TICK_OPS["stance_leg"] * (batch * steps * 4 - swing_legs)
           + TICK_OPS["early_leg"] * touching + TICK_OPS["active_leg"] * active
           + TICK_OPS["takeoff"] * takeoff)
    return float(F32 * batch * (78 + 35 + 78 + 71 * steps) + F32 * 220), float(ops)
