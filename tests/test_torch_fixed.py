"""Port parity: the legacy fixed-segment solver path against the JAX package.

``mpc/kernels.py::admm_iterations`` (dense-A iterations; CPU tensors run its
plain version), ``mpc/condensed.py::build_condensed`` / ``recover_states``,
``mpc/admm.py::ruiz_equilibrate`` / ``solve`` / ``solve_batch`` and
``sim/engine.py::mpc_cycle_fixed`` / ``simulate_fixed``. Bars:

- the iterations: rtol and atol 2e-4 against JAX ``kernels.admm_iterations``
  (its Pallas kernel run by the interpreter) and the NumPy loop of
  tests/test_kernels.py, at 1 and 7 iterations (tests/test_kernels.py); on
  the operands padded to n % 4 == 0 for the kernel (``_pad_dense``), x
  sliced back, equal to the unpadded iterations (the padding adds exact
  zeros);
- QP assembly and Ruiz scaling: 1e-5 of scale, bounds exactly;
- ``solve`` on the condensed QP of tests/test_kernels.py::test_kernel_on_real_qp,
  with dense and diagonal P, with and without the identity box tail, with
  the scaled and the unscaled termination criterion and with rho adaptive
  and fixed: forces within 0.005 x scale (that test's bar). ``iters`` is printed: the
  port reports it at every ``check_every``-th iteration as JAX's default
  branch does, and a gap is f32 rounding at the check threshold;
- ``mpc_cycle_fixed``: applied forces within 2.0 N of the vmapped JAX cycle
  over two cycles (the JAX suite's batched-vs-single bar), on the condensed
  QP and on the full form (there also q within 5e-3).
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
import qp_oracle as oracle  # noqa: E402
from torch_parity import assert_close_scaled, t, to_port  # noqa: E402
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import launches  # noqa: E402
from test_kernels import make_problem, reference_iterations  # noqa: E402

from convex_mpc_tpu.control import gait as JG
from convex_mpc_tpu.control.srb import SrbDynamics
from convex_mpc_tpu.models import dynamics as JD
from convex_mpc_tpu.mpc import admm as JA
from convex_mpc_tpu.mpc import condensed as JC
from convex_mpc_tpu.mpc import kernels as JK
from convex_mpc_tpu.sim import engine as JE
from convex_mpc_tpu.sim import physics as JP
from convex_mpc_tpu_torch.mpc import admm as TA
from convex_mpc_tpu_torch.mpc import condensed as TC
from convex_mpc_tpu_torch.mpc import kernels as TK
from convex_mpc_tpu_torch.sim import engine as TE

Q_DIAG = (1, 1, 50, 10, 20, 1, 2, 2, 1, 1, 1, 1)
SOLVE_KW = dict(max_iter=400, scaled_termination=True, eps_abs=1e-4, eps_rel=1e-4)


@pytest.mark.parametrize("iters", [1, 7])
def test_admm_iterations_plain_matches_jax(iters):
    args = make_problem()
    ref_np = reference_iterations(*[a.copy() for a in args], iters=iters)
    ref_jax = JK.admm_iterations(*[jnp.asarray(a) for a in args], iters=iters, block_k=2)
    before = launches()
    out = TK.admm_iterations(*[t(a) for a in args], iters=iters)
    assert not any(launches(before).values())  # CPU tensors: the plain version
    for name, a, r1, r2 in zip("xzy", out, ref_np, ref_jax):
        np.testing.assert_allclose(a.numpy(), r1, rtol=2e-4, atol=2e-4, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(r2), rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("iters", [1, 7])
def test_pad_dense_matches_unpadded_and_jax(iters):
    """n = 30, not a multiple of 4: the operands the kernel's wrapper pads
    (``_pad_dense``: n to 32) run the same iterations: the plain version on
    them, x sliced back to 30, equals the plain version on the originals,
    and both match JAX ``kernels.admm_iterations`` (its Pallas kernel run by
    the interpreter, which pads to 128) within rtol and atol 2e-4."""
    args = make_problem(b=3, m=21, n=30, seed=4)
    ref_jax = JK.admm_iterations(*[jnp.asarray(a) for a in args], iters=iters, block_k=2)
    targs = [t(a) for a in args]
    padded = TK._pad_dense(*targs)
    assert tuple(padded[0].shape) == (3, 21, 32) and tuple(padded[1].shape) == (3, 32, 32)
    xp, zp, yp = TK.admm_iterations_plain(*padded, iters=iters)
    assert torch.equal(xp[:, 30:], torch.zeros(3, 2))
    out = TK.admm_iterations_plain(*targs, iters=iters)
    for name, a, b, r in zip("xzy", (xp[:, :30], zp, yp), out, ref_jax):
        assert torch.equal(a, b), name
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=2e-4, atol=2e-4, err_msg=name)


def test_admm_iterations_inert_rows_and_cpu_launch():
    """Rows with rho = 0 keep y and contribute nothing (the TPU kernel's
    padding rule). That the kernel's launch refuses CPU tensors is
    tests/test_torch_binding.py's case ``admm_iterations``."""
    A, Minv, q, l, u, rho, x, z, y = [t(a) for a in make_problem()]
    rho[:, -5:] = 0.0
    xo, zo, yo = TK.admm_iterations(A, Minv, q, l, u, rho, x, z, y, iters=3)
    assert torch.isfinite(xo).all() and torch.isfinite(zo).all()
    torch.testing.assert_close(yo[:, -5:], y[:, -5:], rtol=0, atol=0)


@pytest.fixture(scope="module")
def real_qp():
    """The condensed MPC QP of tests/test_kernels.py::test_kernel_on_real_qp,
    in both packages (the port's with a batch axis of 1)."""
    sc = oracle.trot_scenario(t0=0.123, vx=0.5, wz=0.5, seed=3)
    f32 = lambda k: jnp.asarray(sc[k], jnp.float32)  # noqa: E731
    dyn = SrbDynamics(Ad=f32("Ad"), Bd=f32("Bd"), gd=f32("gd"))
    inputs = (f32("x0"), f32("x_ref"), jnp.asarray(sc["contact"]))
    jdata, jaux = jax.jit(JC.build_condensed)(dyn, *inputs, jnp.asarray(Q_DIAG, jnp.float32),
                                              1e-5, 0.8, 10.0)
    b1 = lambda x, dt=torch.float32: t(np.asarray(x)[None], dt)  # noqa: E731
    pdyn = to_port(jax.tree.map(lambda x: x[None], dyn))
    tdata, taux = TC.build_condensed(pdyn, b1(inputs[0]), b1(inputs[1]),
                                     b1(inputs[2], torch.int32), Q_DIAG, 1e-5, 0.8, 10.0)
    return jdata, jaux, tdata, taux, inputs[0]


def test_build_condensed_matches_jax(real_qp):
    jdata, jaux, tdata, taux, x0 = real_qp
    for f in ("p_dense", "p_diag", "q", "A"):
        assert_close_scaled(getattr(tdata, f).numpy()[0], getattr(jdata, f), 1e-5, f)
    for f in ("l", "u"):  # +-inf included
        np.testing.assert_array_equal(getattr(tdata, f).numpy()[0], np.asarray(getattr(jdata, f)))
    for f in jaux._fields:
        assert_close_scaled(getattr(taux, f).numpy()[0], getattr(jaux, f), 1e-5, f)
    u = np.random.default_rng(0).normal(0, 30, tdata.q.shape[-1]).astype(np.float32)
    X_ref = JC.recover_states(jaux, x0, jnp.asarray(u))
    X = TC.recover_states(taux, t(np.asarray(x0)[None]), t(u[None]))
    assert_close_scaled(X.numpy()[0], X_ref, 1e-5, "recover_states")


def test_ruiz_matches_jax(real_qp):
    jdata, _, tdata, _, _ = real_qp
    js = JA.ruiz_equilibrate(jdata, 10)
    ts = TA.ruiz_equilibrate(tdata, 10)
    for f in ("p_dense", "p_diag", "q", "A", "d", "e", "c"):
        assert_close_scaled(getattr(ts, f).numpy()[0], getattr(js, f), 1e-5, f)
    for f in ("l", "u"):  # +-inf entries exactly, finite ones to 1e-5
        a, d = getattr(ts, f).numpy()[0], np.asarray(getattr(js, f))
        fin = np.isfinite(d)
        np.testing.assert_array_equal(a[~fin], d[~fin])
        assert_close_scaled(a[fin], d[fin], 1e-5, f)


@pytest.mark.parametrize("box_tail, diag_p, opts", [
    (0, False, {}), (192, False, {}), (0, True, {}),
    (192, False, {"scaled_termination": False}), (192, False, {"adaptive_rho": False})],
    ids=["dense-P", "dense-P-box-tail", "diagonal-P", "unscaled-termination", "fixed-rho"])
def test_solve_matches_jax(real_qp, box_tail, diag_p, opts):
    """``opts`` reach the solver's other branches: the unscaled row-type-aware
    termination criterion (the default of both packages' ``solve``) and a
    rho held fixed across segments."""
    jdata, _, tdata, _, _ = real_qp
    data1 = TA.QpData(*(None if v is None else v[0] for v in tdata))
    if diag_p:  # the same QP with P's off-diagonal part dropped
        jdata = jdata._replace(p_dense=None)
        data1 = data1._replace(p_dense=None)
    kw = dict(SOLVE_KW, box_tail=box_tail, **opts)
    jsol = JA.solve(jdata, JA.init_state(jdata), **kw)
    tsol = TA.solve(data1, TA.init_state(data1), **kw)
    u_ref = np.asarray(jsol.x).reshape(16, 12)
    scale = max(np.abs(u_ref).max(), 1.0)
    err = np.abs(tsol.x.numpy().reshape(16, 12) - u_ref).max() / scale
    print(f"box_tail {box_tail} {opts}: forces within {err:.2e} x scale; iters jax "
          f"{int(jsol.iters)} port {int(tsol.iters)}; rho jax {float(jsol.state.rho):.4g} "
          f"port {float(tsol.state.rho):.4g}")
    assert err < 0.005
    assert tsol.iters.dtype == torch.int32 and tsol.iters.ndim == 0
    assert tsol.state.rho.ndim == 0 and np.isfinite(float(tsol.dual_res))


def test_solve_batch_is_per_scenario(real_qp):
    """A batch of two copies solves as two single solves, each scenario with
    its own rho (the second copy starts from another one): forces within
    the 0.005 x scale bar (batched and single products round differently)."""
    _, _, tdata, _, _ = real_qp
    data2 = TA.QpData(*(None if v is None else torch.cat([v, v]) for v in tdata))
    st = TA.init_state(data2)
    st = st._replace(rho=torch.tensor([0.1, 1e-3]))
    both = TA.solve_batch(data2, st, **SOLVE_KW)
    assert float(both.state.rho[0]) != float(both.state.rho[1])
    for i in range(2):
        one = TA.solve(TA.QpData(*(None if v is None else v[i] for v in data2)),
                       TA.AdmmState(*(v[i] for v in st)), **SOLVE_KW)
        scale = max(float(one.x.abs().max()), 1.0)
        assert float((both.x[i] - one.x).abs().max()) / scale < 0.005
        print(f"scenario {i}: iters batched {int(both.iters[i])} single {int(one.iters)}")


def _start(B: int):
    """B standing starts at different gait phases and x offsets (JAX trees)."""
    dyn = JD.build_dyn()
    contact = JP.default_contact(kn=30000, dn=1000)
    state = JE.init_state(dyn, n=16)._replace(plant=JP.init_plant(dyn, contact=contact))
    sb = JE.broadcast_batch(state, B)
    sb = sb._replace(plant=sb.plant._replace(q=sb.plant.q.at[:, 0].add(jnp.linspace(-0.02, 0.02, B))),
                     t=jnp.linspace(0.0, 0.2, B).astype(jnp.float32))
    # strong types throughout, as a cycle returns them: the jitted cycle then
    # compiles once for both cycles
    sb = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), sb)
    return dyn, (JE.broadcast_batch(JG.make_gait_params(3.0, 0.6), B),
                 JE.broadcast_batch(contact, B),
                 JE.broadcast_batch(JE.constant_schedule(vx=0.4, wz=0.3), B), sb)


def test_mpc_cycle_fixed_matches_jax():
    dyn, (gb, cb, scb, sb) = _start(4)
    pdyn, pg, pc, psc, ps = to_port(dyn), to_port(gb), to_port(cb), to_port(scb), to_port(sb)
    jcycle = jax.jit(jax.vmap(lambda g, c, s, st: JE.mpc_cycle_fixed(dyn, g, c, s, st,
                                                                     solver_iters=150)))
    for cycle in range(2):
        sb, jlog = jcycle(gb, cb, scb, sb)
        ps, tlog = TE.mpc_cycle_fixed(pdyn, pg, pc, psc, ps, solver_iters=150)
        print(f"cycle {cycle}: solver_iters jax {np.asarray(jlog.solver_iters)} "
              f"port {tlog.solver_iters.numpy()}")
        du0 = np.abs(ps.u0.numpy() - np.asarray(sb.u0)).max()
        assert du0 < 2.0, (cycle, du0)  # Newtons
        assert tuple(ps.solver.rho.shape) == (4,)


def test_simulate_fixed_shapes():
    """simulate_fixed stacks logs as (n_cycles, B, ...); the batch stays
    upright; two B = 2 cycles of the full formulation (``qp.build_qp``, the
    solver state carried rho and all) match the vmapped JAX cycles: u0
    within 2.0 N, q within 5e-3."""
    dyn, args = _start(2)
    state, logs = TE.simulate_fixed(to_port(dyn), *[to_port(a) for a in args], 2,
                                    solver_iters=40)
    assert tuple(logs.ticks.q.shape) == (2, 2, 20, 19)
    assert tuple(logs.solver_iters.shape) == (2, 2) and logs.solver_iters.dtype == torch.int32
    assert tuple(state.solver.x.shape) == (2, 192)
    z = state.plant.q[:, 2].numpy()
    assert np.isfinite(z).all() and ((z > 0.1) & (z < 0.6)).all(), z

    gb, cb, scb, sb = args
    full = JE.broadcast_batch(JE.init_state(dyn, n=16, formulation="full").solver, 2)
    sb = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), sb._replace(solver=full))
    ps = to_port(sb)
    assert tuple(ps.solver.x.shape) == (2, 384) and tuple(ps.solver.z.shape) == (2, 640)
    jcycle = jax.jit(jax.vmap(lambda g, c, s, st: JE.mpc_cycle_fixed(
        dyn, g, c, s, st, solver_iters=150, formulation="full")))
    pargs = [to_port(a) for a in (dyn, gb, cb, scb)]
    for cycle in range(2):
        sb, jlog = jcycle(gb, cb, scb, sb)
        ps, tlog = TE.mpc_cycle_fixed(*pargs, ps, solver_iters=150, formulation="full")
        du0 = np.abs(ps.u0.numpy() - np.asarray(sb.u0)).max()
        dq = np.abs(ps.plant.q.numpy() - np.asarray(sb.plant.q)).max()
        print(f"full form cycle {cycle}: |du0| {du0:.4f} N, |dq| {dq:.2e}; iters jax "
              f"{np.asarray(jlog.solver_iters)} port {tlog.solver_iters.numpy()}")
        assert du0 < 2.0 and dq < 5e-3, (cycle, du0, dq)
