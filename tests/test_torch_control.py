"""Port parity: gait, srb, reference, leg and physics against the JAX package.

Batched numpy-seeded inputs go through ``jax.vmap`` of the per-scenario JAX
functions and through the port's batch-axis versions. Bars: 1e-6 of scale
for closed-form elementwise code, 1e-5 where a 3x3/18x18 solve or a
discretization sits in between; integer/bool outputs must match exactly.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parity import assert_close_scaled, assert_tree_close, t, to_port  # noqa: E402

from convex_mpc_tpu.control import gait as JG
from convex_mpc_tpu.control import leg as JL
from convex_mpc_tpu.control import reference as JR
from convex_mpc_tpu.control import srb as JS
from convex_mpc_tpu.models import dynamics as JD
from convex_mpc_tpu.models.kinematics import build_kin
from convex_mpc_tpu.sim import engine as JE
from convex_mpc_tpu.sim import physics as JP
from convex_mpc_tpu_torch.control import gait as TG
from convex_mpc_tpu_torch.control import leg as TL
from convex_mpc_tpu_torch.control import reference as TR
from convex_mpc_tpu_torch.control import srb as TS
from convex_mpc_tpu_torch.sim import physics as TP

B = 6
N = 16
DT = (1.0 / 3.0) / N


@pytest.fixture(scope="module")
def dyns():
    jd = JD.build_dyn()
    return jd, to_port(jd)


@pytest.fixture(scope="module")
def gaits():
    """Per-scenario gaits (frequency, duty and offsets vary)."""
    rng = np.random.default_rng(3)
    g = JG.GaitParams(
        period=jnp.asarray(1.0 / rng.uniform(2.5, 3.5, B), jnp.float32),
        duty=jnp.asarray(rng.uniform(0.5, 0.7, B), jnp.float32),
        phase_offset=jnp.asarray(
            np.tile([0.5, 0.0, 0.0, 0.5], (B, 1)) + rng.normal(0, 0.05, (B, 4)), jnp.float32),
        swing_height=jnp.full((B,), 0.1, jnp.float32),
        touchdown_z=jnp.full((B,), 0.02, jnp.float32),
    )
    return g, to_port(g)


@pytest.fixture(scope="module")
def plant_batch(dyns):
    jd, _ = dyns
    rng = np.random.default_rng(11)
    q = np.tile(np.asarray(JP.init_plant(jd).q), (B, 1))
    q[:, 0:2] += rng.normal(0, 0.02, (B, 2))
    q[:, 2] += rng.normal(0, 0.01, B)
    q[:, 7:] += rng.normal(0, 0.05, (B, 12))
    dq = rng.normal(0, 0.2, (B, 18))
    return JP.PlantState(q=jnp.asarray(q, jnp.float32), dq=jnp.asarray(dq, jnp.float32))


def test_gait_functions(gaits):
    jg, tg = gaits
    times = np.linspace(0.0, 0.9, B).astype(np.float32)
    ct = jax.vmap(lambda g, t0: JG.contact_table(g, t0, DT, N))(jg, times)
    np.testing.assert_array_equal(TG.contact_table(tg, t(times), DT, N).numpy(), ct)
    cm = jax.vmap(JG.current_mask)(jg, times)
    np.testing.assert_array_equal(TG.current_mask(tg, t(times)).numpy(), cm)
    lp = jax.vmap(JG.leg_phase)(jg, times)
    assert_close_scaled(TG.leg_phase(tg, t(times)).numpy(), lp, 1e-6, "leg_phase")

    rng = np.random.default_rng(5)
    hip = np.asarray(build_kin().hip_offset)
    base = rng.normal(0, 0.3, (B, 3)).astype(np.float32)
    vxy = rng.normal(0, 0.5, (B, 2)).astype(np.float32)
    yaw = rng.normal(0, 1.0, B).astype(np.float32)
    wz = rng.normal(0, 0.5, B).astype(np.float32)
    jn = jax.vmap(lambda g, b, v, y, w: jax.vmap(
        lambda h: JG.touchdown_nominal(g, b, v, y, w, h))(hip))(jg, base, vxy, yaw, wz)
    tn = TG.touchdown_nominal(tg, t(base)[:, None], t(vxy)[:, None], t(yaw)[:, None].expand(B, 4),
                              t(wz)[:, None], t(hip))
    assert_close_scaled(tn.numpy(), jn, 1e-6, "touchdown_nominal")

    com = base + rng.normal(0, 0.01, (B, 3)).astype(np.float32)
    vcom = rng.normal(0, 0.5, (B, 3)).astype(np.float32)
    pdes = rng.normal(0, 0.3, (B, 2)).astype(np.float32)
    jr = jax.vmap(lambda g, b, c, v, y, w, vd, pd: jax.vmap(
        lambda h: JG.touchdown_raibert(g, b, c, v, y, w, vd, pd, h))(hip))(
        jg, base, com, vcom, yaw, wz, vxy, pdes)
    tr = TG.touchdown_raibert(tg, t(base)[:, None], t(com)[:, None], t(vcom)[:, None],
                              t(yaw)[:, None].expand(B, 4), t(wz)[:, None], t(vxy)[:, None],
                              t(pdes)[:, None], t(hip))
    assert_close_scaled(tr.numpy(), jr, 1e-6, "touchdown_raibert")

    p0 = rng.normal(0, 0.2, (B, 4, 3)).astype(np.float32)
    pf = rng.normal(0, 0.2, (B, 4, 3)).astype(np.float32)
    ts = rng.uniform(-0.02, 0.2, (B, 4)).astype(np.float32)
    js = jax.vmap(lambda a, b_, c, g: JG.swing_eval(a, b_, c, g.swing_time, g.swing_height))(
        p0, pf, ts, jg)
    tsw = TG.swing_eval(t(p0), t(pf), t(ts), tg.swing_time[:, None], tg.swing_height[:, None])
    for name, a, d in zip(("p", "v", "a"), tsw, js):
        assert_close_scaled(a.numpy(), d, 1e-5, f"swing_{name}")


def test_srb_discretize():
    rng = np.random.default_rng(9)
    yaw = rng.normal(0, 1, B).astype(np.float32)
    r = rng.normal(0, 0.2, (B, N, 4, 3)).astype(np.float32)
    Ig = rng.normal(0, 0.05, (B, 3, 3)).astype(np.float32)
    Ig = (Ig @ np.swapaxes(Ig, -1, -2) + np.diag([0.1, 0.25, 0.28])).astype(np.float32)
    mass = np.full(B, 15.2, np.float32)
    jd = jax.vmap(lambda y, rr, m, I: JS.discretize(y, rr, m, I, DT))(yaw, r, mass, Ig)
    td = TS.discretize(t(yaw), t(r), t(mass), t(Ig), DT)
    assert_tree_close(jd, td, 1e-5)


@pytest.mark.parametrize("brake", [(0.0, 0.0), (2.5, 10.0)])
def test_reference_generate(dyns, gaits, plant_batch, brake):
    """vmap(reference.generate) == the port's batched generate, incl. the
    brake_accel / brake_alpha limiters and the horizon lever scan."""
    jd, _ = dyns
    jg, tg = gaits
    rng = np.random.default_rng(17)
    yc = jnp.asarray(rng.normal(0, 0.1, B), jnp.float32)
    vf = jnp.asarray(rng.normal(0, 0.2, (B, 6)), jnp.float32)
    obs, _, _ = jax.vmap(lambda p, y, v: JE.observe(jd, p, y, y, v))(plant_batch, yc, vf)
    state = JR.RefGenState(
        pos_des_world=obs.x_vec[:, 0:3] + jnp.asarray(rng.normal(0, 0.15, (B, 3)), jnp.float32),
        vel_cmd=jnp.asarray(rng.normal(0, 0.6, (B, 3)), jnp.float32),
    )
    cmd = JR.BodyCommand(
        vx=jnp.asarray(rng.normal(0.3, 0.3, B), jnp.float32),
        vy=jnp.asarray(rng.normal(0, 0.2, B), jnp.float32),
        z_pos=jnp.full((B,), 0.27, jnp.float32),
        yaw_rate=jnp.asarray(rng.normal(0, 0.5, B), jnp.float32),
    )
    t_now = jnp.asarray(rng.uniform(0, 1, B), jnp.float32)
    ba, bw = brake
    jt, js = jax.vmap(lambda s, g, o, c, tt: JR.generate(
        s, g, o, c, tt, DT, N, brake_accel=ba, brake_alpha=bw))(state, jg, obs, cmd, t_now)
    tt_, ts_ = TR.generate(to_port(state), tg, to_port(obs), to_port(cmd), t(t_now), DT, N,
                           brake_accel=ba, brake_alpha=bw)
    np.testing.assert_array_equal(tt_.contact.numpy(), np.asarray(jt.contact))
    assert_tree_close(jt._replace(contact=None), tt_._replace(contact=None), 1e-5)
    assert_tree_close(js, ts_, 1e-6)


def _leg_inputs(jd, plant, seed):
    rng = np.random.default_rng(seed)
    leg = JL.LegControlState(
        last_mask=jnp.asarray(rng.integers(0, 3, (B, 4)), jnp.int32),
        takeoff_time=jnp.asarray(rng.uniform(0, 0.05, (B, 4)), jnp.float32),
        swing_p0=jnp.asarray(rng.normal(0, 0.01, (B, 4, 3)) + [0.2, 0.15, 0.02], jnp.float32),
        swing_td=jnp.asarray(rng.normal(0, 0.01, (B, 4, 3)) + [0.25, 0.15, 0.02], jnp.float32),
    )
    u0 = jnp.asarray(rng.normal(0, 5, (B, 4, 3)) + [0, 0, 40.0], jnp.float32)
    pos_des = plant.q[:, 0:3] + jnp.asarray([0.02, 0.0, 0.0], jnp.float32)
    vel_des = jnp.asarray(np.tile([0.5, 0.0, 0.0], (B, 1)), jnp.float32)
    wz = jnp.asarray(rng.normal(0, 0.5, B), jnp.float32)
    tt = jnp.asarray(rng.uniform(0.1, 0.4, B), jnp.float32)
    yaw = jnp.asarray(rng.normal(0, 0.1, B), jnp.float32)
    return leg, u0, pos_des, vel_des, wz, tt, yaw


def test_leg_controller(dyns, gaits, plant_batch):
    """make_leg_obs + compute_torques, swing/stance/early-contact branches."""
    jd, td = dyns
    jg, tg = gaits
    leg, u0, pos_des, vel_des, wz, tt, yaw = _leg_inputs(jd, plant_batch, 21)
    jobs = jax.vmap(lambda q, dq, y: JL.make_leg_obs(jd, q, dq, y))(
        plant_batch.q, plant_batch.dq, yaw)
    tobs = TL.make_leg_obs(td, t(plant_batch.q), t(plant_batch.dq), t(yaw))
    assert_tree_close(jobs, tobs, 2e-5)
    jout, jst = jax.vmap(lambda s, g, o, f, p, v, w, ti: JL.compute_torques(
        s, g, o, f, p, v, w, ti))(leg, jg, jobs, u0, pos_des, vel_des, wz, tt)
    tout, tst = TL.compute_torques(to_port(leg), tg, to_port(jobs), t(u0), t(pos_des),
                                   t(vel_des), t(wz), t(tt))
    assert_tree_close(jout, tout, 1e-5)
    np.testing.assert_array_equal(tst.last_mask.numpy(), np.asarray(jst.last_mask))
    assert_tree_close(jst, tst, 1e-6)


def test_physics_step(dyns, plant_batch):
    jd, td = dyns
    contact = JE.broadcast_batch(JP.default_contact(), B)
    rng = np.random.default_rng(31)
    tau = jnp.asarray(rng.normal(0, 5, (B, 12)), jnp.float32)
    # lower the batch into the ground so every contact branch is exercised
    plant = plant_batch._replace(q=plant_batch.q.at[:, 2].add(
        jnp.asarray(rng.uniform(-0.004, 0.004, B), jnp.float32)))
    jn = jax.vmap(lambda c, p, u: JP.step(jd, c, p, u, 1e-3))(contact, plant, tau)
    tn = TP.step(td, to_port(contact), to_port(plant), t(tau), 1e-3)
    assert_tree_close(jn, tn, 1e-5)
    from convex_mpc_tpu.models import kinematics as JK
    fp, fv = jax.vmap(lambda q, dq: JK.foot_state(jd.kin, q, dq))(plant.q, plant.dq)
    jf = jax.vmap(JP.contact_forces)(contact, fp, fv)
    tf = TP.contact_forces(to_port(contact), t(fp), t(fv))
    assert_close_scaled(tf.numpy(), jf, 1e-5, "contact_forces")
    ji = JP.init_plant(jd, x=0.1, y=-0.2)
    assert_tree_close(ji, TP.init_plant(td, x=0.1, y=-0.2), 1e-6)
