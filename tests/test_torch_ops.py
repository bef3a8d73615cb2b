"""Port parity: ops/rotations.py and ops/linalg.py against the JAX package.

Elementwise f32 code with the same formulas: bars at a few f32 ulps of the
values' scale (1e-6 relative), looser (1e-5) where an inverse amplifies
rounding.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parity import assert_close_scaled, t  # noqa: E402

from convex_mpc_tpu.ops import linalg as JL
from convex_mpc_tpu.ops import rotations as JR
from convex_mpc_tpu_torch.ops import linalg as TL
from convex_mpc_tpu_torch.ops import rotations as TR

RNG = np.random.default_rng(123)
QUAT = RNG.normal(size=(7, 4)).astype(np.float32)
QUAT /= np.linalg.norm(QUAT, axis=-1, keepdims=True)
VEC = RNG.normal(size=(7, 3)).astype(np.float32)


@pytest.mark.parametrize("name,args", [
    ("hat", (VEC,)),
    ("quat_to_rotmat", (QUAT,)),
    ("rpy_to_quat", (VEC,)),
    ("quat_to_rpy", (QUAT,)),
    ("rpy_to_rotmat", (VEC,)),
    ("rot_z", (VEC[:, 0] * 4.0,)),
    ("quat_mul", (QUAT, QUAT[::-1].copy())),
    ("quat_integrate", (QUAT, VEC * 3.0, 1e-3)),
])
def test_rotations_match_jax(name, args):
    jax_out = getattr(JR, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    port_out = getattr(TR, name)(*[t(a) if isinstance(a, np.ndarray) else a for a in args])
    assert_close_scaled(port_out.numpy(), jax_out, 1e-6, name)


def test_yaw_unwrap_is_floor_mod():
    """jnp.mod is floor-mod; a negative wrapped delta must come out in [-pi, pi)."""
    meas = np.array([3.1, -3.1, 0.2, -2.0, 3.0], np.float32)
    prev = np.array([-3.1, 3.1, 0.1, 2.5, -0.5], np.float32)
    cont = np.array([10.0, -4.0, 0.0, 1.0, 2.0], np.float32)
    jc, jp = JR.yaw_unwrap_step(jnp.asarray(meas), jnp.asarray(prev), jnp.asarray(cont))
    tc, tp = TR.yaw_unwrap_step(t(meas), t(prev), t(cont))
    assert_close_scaled(tc.numpy(), jc, 1e-6, "yaw_cont")
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def _spd(batch, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(batch, n, n)).astype(np.float32)
    return (A @ np.swapaxes(A, -1, -2) / n + np.eye(n, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("name,n", [("inv3", 3), ("inv_small_unrolled", 7),
                                    ("inv6_spd_block", 6)])
def test_small_inverses_match_jax(name, n):
    A = _spd(5, n, seed=n)
    jax_out = getattr(JL, name)(jnp.asarray(A))
    port_out = getattr(TL, name)(t(A))
    assert_close_scaled(port_out.numpy(), jax_out, 1e-5, name)


def test_inv_small_unrolled_nan_signal():
    """A non-SPD block yields NaN (the polish certificate's reject signal),
    in exactly the matrices where the JAX function yields NaN."""
    A = _spd(3, 7, seed=1)
    A[1, 4, 4] = -5.0
    jax_out = np.asarray(JL.inv_small_unrolled(jnp.asarray(A)))
    port_out = TL.inv_small_unrolled(t(A)).numpy()
    np.testing.assert_array_equal(np.isnan(port_out), np.isnan(jax_out))
    assert np.isnan(port_out[1]).any() and np.isfinite(port_out[[0, 2]]).all()


def _arrow_matrix(batch, seed):
    """18x18 SPD with the Go2 arrow structure (zero cross-leg blocks)."""
    rng = np.random.default_rng(seed)
    A = np.zeros((batch, 18, 18), np.float32)
    G = rng.normal(size=(batch, 6, 6)).astype(np.float32)
    A[:, :6, :6] = G @ np.swapaxes(G, -1, -2) + 20 * np.eye(6, dtype=np.float32)
    for l in range(4):
        s = slice(6 + 3 * l, 9 + 3 * l)
        H = rng.normal(size=(batch, 3, 3)).astype(np.float32)
        A[:, s, s] = H @ np.swapaxes(H, -1, -2) + 3 * np.eye(3, dtype=np.float32)
        Bc = 0.3 * rng.normal(size=(batch, 6, 3)).astype(np.float32)
        A[:, :6, s] = Bc
        A[:, s, :6] = np.swapaxes(Bc, -1, -2)
    return A


def test_arrow_factor_solve_match_jax():
    A = _arrow_matrix(4, seed=5)
    r = np.random.default_rng(6).normal(size=(4, 18, 3)).astype(np.float32)
    jfac = JL.arrow_factor(jnp.asarray(A))
    tfac = TL.arrow_factor(t(A))
    for f in TL.ArrowFactor._fields:
        assert_close_scaled(getattr(tfac, f).numpy(), getattr(jfac, f), 1e-5, f)
    jx = JL.arrow_solve(jfac, jnp.asarray(r))
    tx = TL.arrow_solve(tfac, t(r))
    assert_close_scaled(tx.numpy(), jx, 1e-5, "arrow_solve")
    # and it solves the system
    resid = np.einsum("bij,bjk->bik", A.astype(np.float64), tx.numpy()) - r
    assert np.abs(resid).max() < 1e-4
