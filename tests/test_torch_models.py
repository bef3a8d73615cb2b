"""Port parity: models/kinematics.py and models/dynamics.py against JAX.

The port writes the batch axis out where the JAX code is vmapped; inputs
are a numpy-seeded batch of perturbed standing configurations. Bars: 1e-5
of each quantity's scale (f32 reassociation of short sums), 2e-5 for the
bias (a forward-mode tangent of the whole model).
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parity import assert_close_scaled, assert_tree_close, t  # noqa: E402

from convex_mpc_tpu.models import dynamics as JD
from convex_mpc_tpu.models import kinematics as JK
from convex_mpc_tpu.sim import physics as JP
from convex_mpc_tpu_torch import default_device
from convex_mpc_tpu_torch.models import dynamics as TD
from convex_mpc_tpu_torch.models import kinematics as TK


@pytest.fixture(scope="module")
def models():
    return JD.build_dyn(), TD.build_dyn(device="cpu")


@pytest.fixture(scope="module")
def qdq(models):
    jd, _ = models
    rng = np.random.default_rng(42)
    B = 5
    q = np.tile(np.asarray(JP.init_plant(jd).q), (B, 1))
    q[:, 0:3] += rng.normal(0, 0.05, (B, 3))
    quat = rng.normal(0, 1, (B, 4)) * np.array([0.1, 0.1, 0.3, 1.0])
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] += rng.normal(0, 0.15, (B, 12))
    dq = rng.normal(0, 0.5, (B, 18))
    return q.astype(np.float32), dq.astype(np.float32)


def test_constants_match(models):
    jd, td = models
    assert_tree_close(jax.tree.map(np.asarray, jd), td, 0.0)


def test_fk_and_jacobians(models, qdq):
    jd, td = models
    q, dq = qdq
    jp = jax.vmap(lambda a: JK.fk(jd.kin, a))(q)
    tp = TK.fk(td.kin, t(q))
    assert_tree_close(jp, tp, 1e-6)
    bodies = np.arange(13)
    jJ = jax.vmap(lambda p: JK.angular_jacobians(p, bodies))(jp)
    tJ = TK.angular_jacobians(tp, bodies)
    assert_close_scaled(tJ.numpy(), jJ, 1e-6, "angular_jacobians")
    jf = jax.vmap(lambda a: JK.foot_jacobians(jd.kin, a))(q)
    assert_close_scaled(TK.foot_jacobians(td.kin, t(q)).numpy(), jf, 1e-6, "foot_jacobians")
    jpos, jvel = jax.vmap(lambda a, b: JK.foot_state(jd.kin, a, b))(q, dq)
    tpos, tvel = TK.foot_state(td.kin, t(q), t(dq))
    assert_close_scaled(tpos.numpy(), jpos, 1e-6, "foot_pos")
    assert_close_scaled(tvel.numpy(), jvel, 1e-6, "foot_vel")
    assert_close_scaled(TK.qdot(t(q), t(dq)).numpy(),
                        jax.vmap(JK.qdot)(q, dq), 1e-6, "qdot")
    jjd = jax.vmap(lambda a, b: JK.foot_jdot_qd(jd.kin, a, b))(q, dq)
    assert_close_scaled(TK.foot_jdot_qd(td.kin, t(q), t(dq)).numpy(), jjd, 1e-5, "jdot_qd")


def test_dynamics_entry_points(models, qdq):
    jd, td = models
    q, dq = qdq
    assert_close_scaled(TD.mass_matrix(td, t(q)).numpy(),
                        jax.vmap(lambda a: JD.mass_matrix(jd, a))(q), 1e-5, "M")
    assert_close_scaled(TD.bias_forces(td, t(q), t(dq)).numpy(),
                        jax.vmap(lambda a, b: JD.bias_forces(jd, a, b))(q, dq), 2e-5, "bias")
    jc, jv = jax.vmap(lambda a, b: JD.com_state(jd, a, b))(q, dq)
    tc, tv = TD.com_state(td, t(q), t(dq))
    assert_close_scaled(tc.numpy(), jc, 1e-6, "com")
    assert_close_scaled(tv.numpy(), jv, 1e-5, "vcom")
    assert_close_scaled(TD.centroidal_inertia(td, t(q)).numpy(),
                        jax.vmap(lambda a: JD.centroidal_inertia(jd, a))(q), 1e-5, "Ig")


def test_tick_model_matches_vmapped_jax(models, qdq):
    """tick_model: one primal pass + one forward-mode tangent, every field."""
    jd, td = models
    q, dq = qdq
    jm = jax.vmap(lambda a, b: JD.tick_model(jd, a, b))(q, dq)
    tm = TD.tick_model(td, t(q), t(dq))
    for f in TD.TickModel._fields:
        rel = 2e-5 if f in ("bias", "jdot_qd", "M") else 1e-6
        assert_close_scaled(getattr(tm, f).numpy(), getattr(jm, f), rel, f)


def test_build_dyn_defaults_to_cuda():
    """No entry point carries on quietly on the CPU: device=None means CUDA."""
    if torch.cuda.is_available():
        assert TD.build_dyn().mass.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TD.build_dyn()
        with pytest.raises(RuntimeError, match="CUDA"):
            default_device(None)
