"""The port's host-side modules, its time dashboard and its two demos on the CPU.

- ``models/mjcf.go2_mjcf`` returns the JAX package's string.
- The port's kinematics and dynamics against MuJoCo on that model, at the
  tolerances of ``tests/test_dynamics_vs_mujoco.py`` (one case a quantity):
  the port's first check against an independent physics engine.
- ``sim/mujoco_bridge.py`` as in ``tests/test_mujoco_bridge.py``, against the
  port's plant: the q round trip, free fall, standing contact.
- ``utils/plots.py``: ``flatten_ticks`` of the port's logs equals JAX's
  ``flatten_ticks`` of the same logs crossed through ``utils/interop``, and
  each of the eight dashboards renders a PNG.
- ``tools/torch_time_dashboard.py``, ``examples/torch_trot_demo.py`` and
  ``examples/torch_mujoco_loop.py`` exit 0 with ``--cpu`` (the loop walks
  upright in MuJoCo, as ``tests/test_mujoco_closed_loop.py`` asserts for
  JAX); each refuses without CUDA.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import mujoco as mj
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT / "examples"))
sys.path.insert(0, str(ROOT))

import torch_mujoco_loop  # noqa: E402
import torch_time_dashboard  # noqa: E402
import torch_trot_demo  # noqa: E402
from convex_mpc_tpu_torch.control import gait as G  # noqa: E402
from convex_mpc_tpu_torch.models import dynamics as D  # noqa: E402
from convex_mpc_tpu_torch.models import kinematics as K  # noqa: E402
from convex_mpc_tpu_torch.models.go2_params import DEFAULT_PARAMS, LEG_NAMES  # noqa: E402
from convex_mpc_tpu_torch.models.mjcf import go2_mjcf  # noqa: E402
from convex_mpc_tpu_torch.sim import engine as E  # noqa: E402
from convex_mpc_tpu_torch.sim import physics as P  # noqa: E402
from convex_mpc_tpu_torch.sim.mujoco_bridge import MujocoGo2  # noqa: E402
from convex_mpc_tpu_torch.utils import interop  # noqa: E402
from convex_mpc_tpu_torch.utils import plots as PL  # noqa: E402

CPU = torch.device("cpu")
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
JAX_DASHBOARD_KEYS = ["batch", "cycles", "update_ms_mean", "solve_ms_mean", "apply_ms_mean",
                      "total_ms_p99", "iters_mean", "healthy", "note"]


@pytest.mark.parametrize("kw", [{}, dict(ground=False, mu=0.6, armature=0.01,
                                         joint_damping=0.1)], ids=["default", "custom"])
def test_go2_mjcf_equals_jax(kw):
    from convex_mpc_tpu.models import go2_params as JGP
    from convex_mpc_tpu.models import mjcf as JM

    assert go2_mjcf(**kw) == JM.go2_mjcf(JGP.DEFAULT_PARAMS, **kw)


# --- the port's model against MuJoCo (tolerances of test_dynamics_vs_mujoco) ---

@pytest.fixture(scope="module")
def mj_model():
    return mj.MjModel.from_xml_string(go2_mjcf(DEFAULT_PARAMS, ground=False))


@pytest.fixture(scope="module")
def dyn():
    return D.build_dyn(DEFAULT_PARAMS, device=CPU)


def random_state(seed):
    rng = np.random.default_rng(seed)
    q = np.zeros(19)
    q[0:3] = rng.normal(size=3)
    quat = rng.normal(size=4)
    q[3:7] = quat / np.linalg.norm(quat)  # xyzw
    q[7:] = rng.uniform(-1.0, 1.0, size=12) + np.tile([0.0, 0.9, -1.8], 4)
    dq = rng.normal(size=18)
    return q, dq


def _quat_xyzw_to_R(qv):
    x, y, z, w = qv
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def set_mj_state(model, data, q, dq):
    R = _quat_xyzw_to_R(q[3:7])
    data.qpos[:] = np.concatenate([q[0:3], [q[6], q[3], q[4], q[5]], q[7:]])
    data.qvel[:] = np.concatenate([R @ dq[0:3], dq[3:6], dq[6:]])
    mj.mj_forward(model, data)
    T = np.eye(18)
    T[0:3, 0:3] = R
    return T


def _t(a):
    return torch.as_tensor(a, dtype=torch.float32)[None]


def _site(model, leg):
    return mj.mj_name2id(model, mj.mjtObj.mjOBJ_SITE, f"{leg}_foot_site")


def check_total_mass(model, data, dyn):
    np.testing.assert_allclose(float(dyn.total_mass), model.body_mass.sum(), rtol=1e-6)


def check_foot_positions(model, data, dyn):
    for seed in range(5):
        q, dq = random_state(seed)
        set_mj_state(model, data, q, dq)
        foot_w = K.fk(dyn.kin, _t(q)).foot_w[0].numpy()
        for li, leg in enumerate(LEG_NAMES):
            np.testing.assert_allclose(foot_w[li], data.site_xpos[_site(model, leg)], atol=2e-5)


def check_foot_velocities(model, data, dyn):
    for seed in range(3):
        q, dq = random_state(seed)
        set_mj_state(model, data, q, dq)
        vel = K.foot_state(dyn.kin, _t(q), _t(dq))[1][0].numpy()
        for li, leg in enumerate(LEG_NAMES):
            res = np.zeros(6)
            mj.mj_objectVelocity(model, data, mj.mjtObj.mjOBJ_SITE, _site(model, leg), res, 0)
            np.testing.assert_allclose(vel[li], res[3:6], atol=1e-4)  # res = [ang; lin] world


def check_foot_jacobians(model, data, dyn):
    for seed in range(3):
        q, dq = random_state(seed)
        T = set_mj_state(model, data, q, dq)
        J = K.foot_jacobians(dyn.kin, _t(q))[0].numpy()
        for li, leg in enumerate(LEG_NAMES):
            jacp = np.zeros((3, 18))
            mj.mj_jacSite(model, data, jacp, None, _site(model, leg))
            np.testing.assert_allclose(J[li], jacp @ T, atol=2e-5)


def check_mass_matrix(model, data, dyn):
    for seed in range(3):
        q, dq = random_state(seed)
        T = set_mj_state(model, data, q, dq)
        M_mj = np.zeros((18, 18))
        mj.mj_fullM(model, data, M_mj)
        np.testing.assert_allclose(D.mass_matrix(dyn, _t(q))[0].numpy(), T.T @ M_mj @ T,
                                   atol=5e-5)


def check_bias_forces(model, data, dyn):
    for seed in range(3):
        q, dq = random_state(seed)
        T = set_mj_state(model, data, q, dq)
        M_mj = np.zeros((18, 18))
        mj.mj_fullM(model, data, M_mj)
        # Tdot dq: d/dt(R) v_body = R hat(w_body) v_body in the first block
        tdot_dq = np.zeros(18)
        tdot_dq[0:3] = T[0:3, 0:3] @ np.cross(dq[3:6], dq[0:3])
        b_ref = T.T @ (M_mj @ tdot_dq + data.qfrc_bias)
        np.testing.assert_allclose(D.bias_forces(dyn, _t(q), _t(dq))[0].numpy(), b_ref,
                                   atol=2e-3)


def check_com_and_vcom(model, data, dyn):
    base_id = mj.mj_name2id(model, mj.mjtObj.mjOBJ_BODY, "base_link")
    for seed in range(3):
        q, dq = random_state(seed)
        set_mj_state(model, data, q, dq)
        com, vcom = D.com_state(dyn, _t(q), _t(dq))
        np.testing.assert_allclose(com[0].numpy(), data.subtree_com[base_id], atol=2e-5)
        mj.mj_subtreeVel(model, data)
        np.testing.assert_allclose(vcom[0].numpy(), data.subtree_linvel[base_id], atol=1e-4)


def check_centroidal_inertia(model, data, dyn):
    base_id = mj.mj_name2id(model, mj.mjtObj.mjOBJ_BODY, "base_link")
    for seed in range(3):
        q, dq = random_state(seed)
        set_mj_state(model, data, q, dq)
        com = data.subtree_com[base_id]
        Ig_ref = np.zeros((3, 3))  # per-body inertia in world about the robot COM
        for b in range(1, model.nbody):
            ximat = data.ximat[b].reshape(3, 3)
            I_w = ximat @ np.diag(model.body_inertia[b]) @ ximat.T
            d = data.xipos[b] - com
            Ig_ref += I_w + model.body_mass[b] * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
        np.testing.assert_allclose(D.centroidal_inertia(dyn, _t(q))[0].numpy(), Ig_ref,
                                   atol=2e-5)


QUANTITIES = {
    "total_mass": check_total_mass, "foot_positions": check_foot_positions,
    "foot_velocities": check_foot_velocities, "foot_jacobians": check_foot_jacobians,
    "mass_matrix": check_mass_matrix, "bias_forces": check_bias_forces,
    "com_and_vcom": check_com_and_vcom, "centroidal_inertia": check_centroidal_inertia,
}


@pytest.mark.parametrize("quantity", list(QUANTITIES))
def test_dynamics_match_mujoco(quantity, mj_model, dyn):
    QUANTITIES[quantity](mj_model, mj.MjData(mj_model), dyn)


# --- the bridge against the port's plant (as tests/test_mujoco_bridge.py) ---

def test_bridge_q_roundtrip():
    bridge = MujocoGo2(ground=False)
    rng = np.random.default_rng(0)
    q = np.zeros(19)
    q[0:3] = rng.normal(size=3)
    quat = rng.normal(size=4)
    q[3:7] = quat / np.linalg.norm(quat)
    q[7:] = rng.normal(size=12)
    bridge.set_q_pin(q)
    q2, dq2 = bridge.get_q_dq_pin()
    np.testing.assert_allclose(q2, q, atol=1e-12)
    np.testing.assert_allclose(dq2, 0.0, atol=1e-12)


def _b1(tree):
    return interop.tree_map(lambda a: a[None], tree)


def test_bridge_free_fall_matches(dyn):
    """No ground: the port's plant vs MuJoCo under identical torques for 100 ms."""
    contact = _b1(P.default_contact(ground_z=-100.0, armature=0.0, joint_damping=0.0,
                                    device=CPU))
    bridge = MujocoGo2(ground=False)
    state = _b1(P.init_plant(dyn, z=1.0))
    bridge.set_q_pin(state.q[0].numpy())
    tau_seq = np.random.default_rng(1).uniform(-3, 3, size=(100, 12))
    for k in range(100):
        state = P.step(dyn, contact, state, _t(tau_seq[k]), 1e-3)
        bridge.step(tau_seq[k])
    q_mj, dq_mj = bridge.get_q_dq_pin()
    q_t, dq_t = state.q[0].double().numpy(), state.dq[0].double().numpy()
    # different integrators and f32 vs f64: millimeter/millirad after 100 ms
    np.testing.assert_allclose(q_t[0:3], q_mj[0:3], atol=5e-3)
    np.testing.assert_allclose(q_t[3:7], q_mj[3:7], atol=5e-3)
    np.testing.assert_allclose(q_t[7:], q_mj[7:], atol=2e-2)
    np.testing.assert_allclose(dq_t, dq_mj, atol=0.15)


def test_bridge_standing_contact_similar(dyn):
    """With ground: both plants stay near the standing height after 0.3 s
    under zero torque."""
    c = P.default_contact(device=CPU)
    bridge = MujocoGo2(ground=True)
    state = _b1(P.init_plant(dyn, contact=c))
    bridge.set_q_pin(state.q[0].numpy())
    zero = torch.zeros((1, 12))
    for _ in range(300):
        state = P.step(dyn, _b1(c), state, zero, 1e-3)
        bridge.step(np.zeros(12))
    q_mj, _ = bridge.get_q_dq_pin()
    assert abs(float(state.q[0, 2]) - q_mj[2]) < 0.1


# --- plots ---

@pytest.fixture(scope="module")
def run_logs(dyn):
    """Two cycles of one scenario through the port's ``simulate`` (B = 1)."""
    torch.set_num_threads(2)
    contact = P.default_contact(kn=30000, dn=1000, device=CPU)
    state = E.init_state(dyn, n=16)._replace(plant=P.init_plant(dyn, contact=contact))
    _, logs = E.simulate(dyn, G.make_gait_params(3.0, 0.6, device=CPU), contact,
                         E.constant_schedule(vx=0.5, device=CPU), state, n_cycles=2,
                         solver_iters=400)
    return logs


def test_flatten_ticks_equals_jax(run_logs):
    import jax.numpy as jnp
    from convex_mpc_tpu.sim import engine as JE
    from convex_mpc_tpu.utils import plots as JPL

    np_logs = interop.to_numpy(run_logs)
    jlogs = JE.CycleLog(ticks=JE.TickLog(*(jnp.asarray(v) for v in np_logs.ticks)),
                        solver_iters=jnp.asarray(np_logs.solver_iters),
                        prim_res=jnp.asarray(np_logs.prim_res),
                        dual_res=jnp.asarray(np_logs.dual_res))
    ours, theirs = PL.flatten_ticks(run_logs), JPL.flatten_ticks(jlogs)
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        assert ours[key].shape == theirs[key].shape, key
        assert np.array_equal(ours[key], theirs[key]), key
    assert ours["x_vec"].shape == (40, 12)


DASHBOARDS = {
    "contact_forces": lambda lg, x, p: PL.plot_contact_forces(lg, p),
    "mpc_result": lambda lg, x, p: PL.plot_mpc_result(lg, p),
    "swing_foot_traj": lambda lg, x, p: PL.plot_swing_foot_traj(lg, p),
    "solver_stats": lambda lg, x, p: PL.plot_solver_stats(lg, path=p),
    "traj_tracking": lambda lg, x, p: PL.plot_traj_tracking(x, x + 0.01, path=p),
    "full_traj": lambda lg, x, p: PL.plot_full_traj(x[:16], x[16:32], path=p),
    "open_loop_validation": lambda lg, x, p: PL.plot_open_loop_validation(
        x[1:17], x[:17], x[20:36], path=p),
    "cycle_time": lambda lg, x, p: PL.plot_cycle_time(
        torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0]), torch.tensor([5.0, 6.0]),
        budget_ms=20.833, batch=1, path=p),
}


@pytest.mark.parametrize("name", list(DASHBOARDS))
def test_dashboard_renders(name, run_logs, tmp_path):
    pytest.importorskip("matplotlib")
    path = tmp_path / f"{name}.png"
    x = run_logs.ticks.x_vec.reshape(-1, 12)
    assert DASHBOARDS[name](run_logs, x, path) == path
    assert path.stat().st_size > 0


# --- the dashboard tool and the demos, by subprocess ---

def _run(script: str, *argv: str, timeout: float = 300) -> str:
    res = subprocess.run([sys.executable, str(ROOT / script), *argv], capture_output=True,
                         text=True, timeout=timeout, env=ONE_THREAD)
    assert res.returncode == 0, f"stdout:\n{res.stdout}\nstderr:\n{res.stderr[-3000:]}"
    return res.stdout


def test_time_dashboard_cpu(tmp_path):
    path = tmp_path / "td.json"
    out = _run("tools/torch_time_dashboard.py", "--cpu", "--batch", "2", "--seconds", "0.1",
               "--json", str(path))
    doc = json.loads(path.read_text())
    assert json.loads(out.strip().splitlines()[-1]) == doc
    assert set(JAX_DASHBOARD_KEYS) <= set(doc), sorted(set(JAX_DASHBOARD_KEYS) - set(doc))
    assert doc["batch"] == 2 and doc["cycles"] == 4 and doc["healthy"] is True
    assert min(doc["update_ms_mean"], doc["solve_ms_mean"], doc["apply_ms_mean"]) > 0


def test_trot_demo_cpu():
    out = _run("examples/torch_trot_demo.py", "--cpu", "--schedule", "const", "--vx", "0.5",
               "--seconds", "0.5")
    lines = out.splitlines()
    assert "[demo] device=cpu  simulating 0.5s (25 MPC cycles) ..." in lines
    assert any(l.startswith("[demo] solver: mean ") for l in lines)
    # the summary's window starts at 0.5 s, as in the JAX demo: no row yet
    assert "[demo] phases: []" in lines


def test_mujoco_loop_walks_upright():
    out = _run("examples/torch_mujoco_loop.py", "--cpu", "--seconds", "1.0", "--vx", "0.4")
    assert "upright: True" in out


@pytest.mark.parametrize("tool", [torch_time_dashboard, torch_trot_demo, torch_mujoco_loop],
                         ids=lambda m: m.__name__)
def test_host_tools_refuse_without_cuda(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main([])
