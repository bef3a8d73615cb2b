"""Host-side MuJoCo bridge: cross-validation plant and interactive replay.

The port's copy of ``convex_mpc_tpu/sim/mujoco_bridge.py`` (itself a
capability port of the reference's MuJoCo_GO2_Model, mujoco_model.py):
convention conversions between the port's pinocchio style (q: xyzw quat,
dq: body-frame base linear velocity) and MuJoCo (qpos: wxyz quat, qvel:
world-frame base linear velocity), torque application by actuator name, and
the real-time-paced tracking-camera replay viewer (mujoco_model.py:70-124).

The MJCF comes from the port's ``models/mjcf.py`` (generated from the same
Go2Params as the port's model), so this bridge doubles as a physics
cross-validation target for the port's plant. Host-side only: ``mujoco`` is
imported on first use, and nothing on the card imports this module.
"""

from __future__ import annotations

import time

import numpy as np

from convex_mpc_tpu_torch.models.go2_params import DEFAULT_PARAMS, LEG_NAMES, Go2Params
from convex_mpc_tpu_torch.models.mjcf import go2_mjcf


def _mj():
    import mujoco

    return mujoco


class MujocoGo2:
    """Host MuJoCo instance of the generated Go2 model."""

    def __init__(
        self,
        params: Go2Params = DEFAULT_PARAMS,
        ground: bool = True,
        mu: float = 0.8,
        armature: float = 0.0,
        joint_damping: float = 0.0,
    ):
        mj = _mj()
        self.mj = mj
        self.model = mj.MjModel.from_xml_string(
            go2_mjcf(params, ground=ground, mu=mu, armature=armature, joint_damping=joint_damping)
        )
        self.data = mj.MjData(self.model)
        self.base_bid = mj.mj_name2id(self.model, mj.mjtObj.mjOBJ_BODY, "base_link")

    # ---- convention conversions (reference mujoco_model.py:25-68) ----
    def set_q_pin(self, q_pin: np.ndarray) -> None:
        """Set qpos from pinocchio-layout q (xyzw -> wxyz) and run forward."""
        q = np.asarray(q_pin, float)
        self.data.qpos[:] = np.concatenate([q[0:3], [q[6], q[3], q[4], q[5]], q[7:]])
        self.mj.mj_forward(self.model, self.data)

    def get_q_dq_pin(self) -> tuple[np.ndarray, np.ndarray]:
        """Read (q_pin, dq_pin): wxyz->xyzw; world linear vel -> body frame."""
        qpos = np.asarray(self.data.qpos, float)
        qvel = np.asarray(self.data.qvel, float)
        w, x, y, z = qpos[3:7]
        R = _quat_wxyz_to_R(w, x, y, z)
        q_pin = np.concatenate([qpos[0:3], [x, y, z, w], qpos[7:]])
        dq_pin = np.concatenate([R.T @ qvel[0:3], qvel[3:6], qvel[6:]])
        return q_pin, dq_pin

    def set_joint_torque(self, tau12: np.ndarray) -> None:
        """Apply 12 joint torques by actuator name (mujoco_model.py:30-46)."""
        mj = self.mj
        tau12 = np.asarray(tau12, float).reshape(12)
        for li, leg in enumerate(LEG_NAMES):
            for ji, joint in enumerate(("hip", "thigh", "calf")):
                aid = mj.mj_name2id(self.model, mj.mjtObj.mjOBJ_ACTUATOR, f"{leg}_{joint}")
                self.data.ctrl[aid] = tau12[3 * li + ji]

    def step(self, tau12: np.ndarray) -> None:
        """mj_step1 -> apply torques -> mj_step2 (reference test_MPC.py:230-232)."""
        self.mj.mj_step1(self.model, self.data)
        self.set_joint_torque(tau12)
        self.mj.mj_step2(self.model, self.data)

    # ---- replay (reference mujoco_model.py:70-124) ----
    def replay(self, time_log_s, q_pin_log, tau_log=None, render_dt=1 / 120.0, realtime_factor=1.0):
        """Real-time-paced replay with a tracking camera (interactive)."""
        mj = self.mj
        import mujoco.viewer as mjv

        data = mj.MjData(self.model)
        with mjv.launch_passive(self.model, data) as viewer:
            viewer.cam.type = mj.mjtCamera.mjCAMERA_TRACKING
            viewer.cam.trackbodyid = self.base_bid
            viewer.cam.fixedcamid = -1
            viewer.cam.distance = 2.0
            viewer.cam.elevation = -20
            viewer.cam.azimuth = 90
            while viewer.is_running():
                start_wall = time.perf_counter()
                t0 = time_log_s[0]
                next_render = t0
                for k, t in enumerate(time_log_s):
                    if not viewer.is_running():
                        break
                    if t >= next_render:
                        q = np.asarray(q_pin_log[k], float)
                        data.qpos[:] = np.concatenate(
                            [q[0:3], [q[6], q[3], q[4], q[5]], q[7:]]
                        )
                        if tau_log is not None:
                            data.ctrl[:] = tau_log[k]
                        mj.mj_forward(self.model, data)
                        viewer.sync()
                        target = start_wall + (t - t0) / realtime_factor
                        sleep = target - time.perf_counter()
                        if sleep > 0:
                            time.sleep(sleep)
                        next_render += render_dt
                time.sleep(1)


def _quat_wxyz_to_R(w, x, y, z):
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
