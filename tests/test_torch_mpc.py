"""Port parity: condensed QP assembly, the two solve kernels' plain versions,
Ruiz scaling and ``solve_adaptive`` against the JAX package.

Bars (each stated where it is used):
- QP assembly and Ruiz scaling: 1e-5 of scale (f32 suffix recursions);
- ``spd_inverse_plain``: 5e-5 x max|ref| against JAX ``spd_inverse`` (its XLA
  path and its Pallas kernel in interpret mode) and |A out - I| < 1e-4 —
  the JAX suite's own bar (tests/test_kernels.py);
- ``admm_iterations_structured_plain``: atol 2e-6 / rtol 1e-5 against the
  XLA twin over 1, 25 and 150 iterations (tests/test_kernels.py);
- ``solve_adaptive``: first-step forces within 0.5% relative
  (tests/test_adaptive.py).
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parity import assert_close_scaled, assert_tree_close, t, to_port  # noqa: E402
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import launches  # noqa: E402
from test_kernels import _structured_problem  # noqa: E402

from convex_mpc_tpu.control import gait as JG
from convex_mpc_tpu.models import dynamics as JD
from convex_mpc_tpu.mpc import admm as JA
from convex_mpc_tpu.mpc import condensed as JC
from convex_mpc_tpu.mpc import kernels as JK
from convex_mpc_tpu.ops.chol_kernel import spd_inverse as jax_spd_inverse
from convex_mpc_tpu.sim import engine as JE
from convex_mpc_tpu.sim import physics as JP
from convex_mpc_tpu_torch.mpc import admm as TA
from convex_mpc_tpu_torch.mpc import condensed as TC
from convex_mpc_tpu_torch.mpc import kernels as TK
from convex_mpc_tpu_torch.ops import chol_kernel as TCK
from convex_mpc_tpu_torch.sim import engine as TE

Q_DIAG = (1, 1, 50, 10, 20, 1, 2, 2, 1, 1, 1, 1)
MPC_DT = (1.0 / 3.0) / 16


@pytest.fixture(scope="module")
def update_batch():
    """B = 4 perturbed standing starts through the JAX update stage:
    (state, traj, StructuredQp) as numpy-backed JAX trees."""
    dyn = JD.build_dyn()
    contact = JP.default_contact(kn=30000, dn=1000)
    state = JE.init_state(dyn, n=16)._replace(plant=JP.init_plant(dyn, contact=contact))
    B = 4
    sb = JE.broadcast_batch(state, B)
    rng = np.random.default_rng(8)
    sb = sb._replace(
        plant=sb.plant._replace(
            q=sb.plant.q.at[:, 0].add(jnp.linspace(-0.02, 0.02, B)),
            dq=jnp.asarray(rng.normal(0, 0.05, (B, 18)), jnp.float32)),
        t=jnp.asarray([0.0, 0.05, 0.11, 0.2], jnp.float32),
    )
    gb = JE.broadcast_batch(JG.make_gait_params(3.0, 0.6), B)
    scb = JE.broadcast_batch(JE.constant_schedule(vx=0.4, wz=0.3), B)
    qd = jnp.asarray(Q_DIAG, jnp.float32)
    data, traj, refgen, cmd, yc, yp = jax.vmap(
        lambda g, s, st: JE.cycle_update(dyn, g, s, st, qd, 16, MPC_DT, 1e-5, 0.8, 10.0)
    )(gb, scb, sb)
    return dyn, gb, scb, sb, traj, data


def test_cycle_update_matches_jax(update_batch):
    """The whole update stage: lookup, observe, reference, condensed QP."""
    dyn, gb, scb, sb, traj, data = update_batch
    qd = torch.tensor(Q_DIAG, dtype=torch.float32)
    pdata, ptraj, _, _, _, _ = TE.cycle_update(
        to_port(dyn), to_port(gb), to_port(scb), to_port(sb), qd, 16, MPC_DT, 1e-5, 0.8, 10.0)
    np.testing.assert_array_equal(pdata.l.numpy(), np.asarray(data.l))
    np.testing.assert_array_equal(pdata.u.numpy(), np.asarray(data.u))
    assert_tree_close(data._replace(l=None, u=None), pdata._replace(l=None, u=None), 1e-5)


def test_build_condensed_structured_matches_jax(update_batch):
    """The suffix-recursion assembly on identical SRB inputs."""
    _, _, _, _, traj, _ = update_batch
    rng = np.random.default_rng(4)
    x0 = np.asarray(traj.x0) + rng.normal(0, 0.05, traj.x0.shape).astype(np.float32)
    x_ref = np.asarray(traj.x_ref)
    jdata, _ = jax.vmap(lambda d, a, b, c: JC.build_condensed_structured(
        d, a, b, c, jnp.asarray(Q_DIAG, jnp.float32), 1e-5, 0.8, 10.0))(
        traj.dyn, x0, x_ref, traj.contact)
    tdata, aux = TC.build_condensed_structured(
        to_port(traj.dyn), t(x0), t(x_ref), t(traj.contact, torch.int32),
        Q_DIAG, 1e-5, 0.8, 10.0)
    assert aux is None
    assert_tree_close(jdata, tdata, 1e-5)


def test_ruiz_matches_jax(update_batch):
    data = update_batch[-1]
    B, nz = data.q.shape
    ones = jnp.ones((B, nz), jnp.float32)
    js = JA.ruiz_equilibrate_structured(data.p_dense, data.q, data.C, ones, data.l, data.u, iters=5)
    p = to_port(data)
    ts = TA.ruiz_equilibrate_structured(p.p_dense, p.q, p.C, torch.ones(B, nz), p.l, p.u, iters=5)
    for f in ("p_dense", "q", "C", "box_diag", "d", "e", "c"):
        assert_close_scaled(getattr(ts, f).numpy(), getattr(js, f), 1e-5, f)
    for f in ("l", "u"):  # +-inf entries must match exactly, finite ones to 1e-5
        a, d = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        fin = np.isfinite(d)
        np.testing.assert_array_equal(np.isfinite(a), fin)
        np.testing.assert_array_equal(a[~fin], d[~fin])
        assert_close_scaled(a[fin], d[fin], 1e-5, f)


def _spd_batch(B, n, seed):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n)).astype(np.float32)
    return (M @ np.swapaxes(M, -1, -2) / n + 3.0 * np.eye(n, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("interpret", [False, True])
def test_spd_inverse_plain_matches_jax(interpret):
    """Against JAX spd_inverse off the TPU: its XLA path, and its Pallas
    kernel run by the interpreter."""
    A = _spd_batch(5, 96, seed=7)
    ref = np.asarray(jax_spd_inverse(jnp.asarray(A), blk=32, block_k=2, interpret=interpret))
    out = TCK.spd_inverse_plain(t(A)).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=5e-5 * scale, rtol=0)
    resid = np.einsum("bij,bjk->bik", A.astype(np.float64), out) - np.eye(96)
    assert np.abs(resid).max() < 1e-4


def test_spd_inverse_nan_signal_and_cpu_wrapper():
    """A non-SPD matrix gives NaN in that matrix only (the polish
    certificate's signal), whether its factorization fails early (matrix 1)
    or only in its last 16 x 16 panel (matrix 3: a rank-1 term confined to
    its last 16 rows and columns); the CPU wrapper runs the plain version
    and launches no kernel."""
    A = _spd_batch(4, 64, seed=2)
    A[1, 10, 10] = -4.0
    A[3, 48:, 48:] -= 50.0
    ref = np.asarray(jax_spd_inverse(jnp.asarray(A)))
    before = launches()
    out = TCK.spd_inverse(t(A)).numpy()
    assert not any(launches(before).values())
    np.testing.assert_array_equal(np.isnan(out).all(axis=(1, 2)), np.isnan(ref).all(axis=(1, 2)))
    assert np.isnan(out[[1, 3]]).all() and np.isfinite(out[[0, 2]]).all()


def test_spd_inverse_on_attractor_kkt(update_batch):
    """The solver's own KKT matrix at attractor-region rho (1e-4), the case
    where the rejected recursive inverse blew up (residual 7e10).

    There cond(M) ~ 1e4, so no f32 Cholesky meets the random-batch bar: JAX's
    own factorization path is ~5e-5 x scale off the f64 inverse with a
    residual ~2e-4. The bar is therefore relative to the f64 inverse: the
    port's error and residual within twice JAX's (plus 1e-5 x scale)."""
    data = update_batch[-1]
    p = to_port(data)
    B = p.q.shape[0]
    M = TA.kkt_at_rho(p, torch.full((B,), 1e-4))
    M64 = M.numpy().astype(np.float64)
    truth = np.linalg.inv(M64)
    scale = np.abs(truth).max()
    out = TCK.spd_inverse_plain(M).numpy().astype(np.float64)
    ref = np.asarray(jax_spd_inverse(jnp.asarray(M.numpy()))).astype(np.float64)
    assert np.isfinite(out).all()
    err_port = np.abs(out - truth).max()
    err_jax = np.abs(ref - truth).max()
    assert err_port <= 2.0 * err_jax + 1e-5 * scale, (err_port / scale, err_jax / scale)
    res_port = np.abs(M64 @ out - np.eye(M64.shape[-1])).max()
    res_jax = np.abs(M64 @ ref - np.eye(M64.shape[-1])).max()
    print(f"attractor KKT |A out - I|: port plain {res_port:.3e}, JAX {res_jax:.3e}; "
          f"|out - inv64| / scale: port {err_port / scale:.2e}, JAX {err_jax / scale:.2e}")
    assert res_port <= 2.0 * res_jax + 1e-5, (res_port, res_jax)


@pytest.mark.parametrize("B, nb, iters", [
    pytest.param(4, 64, 1, id="1"), pytest.param(4, 64, 25, id="25"),
    pytest.param(4, 64, 150, id="150"),
    # horizon 24's nz = 288: the fold's 512-lane tree (the kernel's VPL = 16)
    pytest.param(2, 96, 25, id="nb96-25"),
])
def test_admm_chunk_plain_matches_xla_twin(B, nb, iters):
    args = _structured_problem(B=B, nb=nb)
    ref = JK.admm_iterations_structured_xla(*args, iters=iters)
    out = TK.admm_iterations_structured_plain(*[t(a) for a in args], iters=iters)
    for name, a, d in zip("xzy", out, ref):
        d = np.asarray(d)
        assert np.isfinite(d).all()
        np.testing.assert_allclose(a.numpy(), d, atol=2e-6, rtol=1e-5, err_msg=name)


def test_solve_adaptive_matches_jax(update_batch):
    """Cold-start adaptive solve on a condensed QP batch: first-step forces
    within 0.5% relative of the JAX solver."""
    data = update_batch[-1]
    B, nz = data.q.shape
    m = data.l.shape[-1]
    cold = JA.AdmmState(x=jnp.zeros((B, nz)), z=jnp.zeros((B, m)), y=jnp.zeros((B, m)),
                        rho=jnp.full((B,), 0.1, jnp.float32))
    jsol = JA.solve_adaptive(data, cold, max_iter=1000, box_tail=192)
    tsol = TA.solve_adaptive(to_port(data), to_port(cold), max_iter=1000, box_tail=192)
    f_ref = np.asarray(jsol.x[:, :12])
    f = tsol.x[:, :12].numpy()
    assert np.abs(f - f_ref).max() / np.abs(f_ref).max() < 0.005
    print("solver_iters jax", np.asarray(jsol.iters), "port", tsol.iters.numpy())
    assert np.isfinite(tsol.state.x.numpy()).all()
    assert tsol.iters.dtype == torch.int32 and tuple(tsol.iters.shape) == (B,)
