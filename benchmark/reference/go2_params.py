"""Unitree Go2 model parameters — the in-repo source of truth.

The reference loads these from the vendored `go2_description` URDF via
Pinocchio (reference go2_robot_data.py:11-13,113-117) and the Unitree MuJoCo
scene XML (reference mujoco_model.py:14-15); neither asset ships with the
reference repo. Here the kinematic layout, link masses, and link inertias are
stated directly (values follow the publicly documented Unitree Go2
`go2_description` spec; total mass ~15.1 kg) and everything else — the
generated MJCF used by the host-side MuJoCo oracle, the analytic kinematics,
and the JAX rigid-body dynamics — derives from this module, so all backends
agree by construction.

Conventions:
- Leg order [FL, FR, RL, RR]; joint order per leg [hip(abduction, x-axis),
  thigh(y-axis), calf(y-axis)].
- q (19,): [base_pos(3), base_quat xyzw(4), 12 joint angles]
- dq (18,): [v_base BODY frame(3), omega_base BODY frame(3), 12 joint vels]
  (Pinocchio free-flyer convention, reference go2_robot_data.py:35-47)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

LEG_NAMES: Tuple[str, ...] = ("FL", "FR", "RL", "RR")
NQ = 19
NV = 18
NUM_LEGS = 4
NUM_BODIES = 13  # trunk + 4 * (hip, thigh, calf)


@dataclasses.dataclass(frozen=True)
class LinkInertia:
    """Mass, COM (link frame), and rotational inertia about the COM (link frame)."""

    mass: float
    com: Tuple[float, float, float]
    # (ixx, iyy, izz, ixy, ixz, iyz)
    inertia: Tuple[float, float, float, float, float, float]

    def inertia_matrix(self) -> np.ndarray:
        ixx, iyy, izz, ixy, ixz, iyz = self.inertia
        return np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])


def _mirror(link: LinkInertia, flip_x: bool, flip_y: bool) -> LinkInertia:
    """Mirror a link's COM/inertia across the x=0 and/or y=0 plane.

    A reflection flips the corresponding COM coordinate and negates the
    inertia products that involve the reflected axis exactly once.
    """
    cx, cy, cz = link.com
    ixx, iyy, izz, ixy, ixz, iyz = link.inertia
    if flip_x:
        cx = -cx
        ixy, ixz = -ixy, -ixz
    if flip_y:
        cy = -cy
        ixy, iyz = -ixy, -iyz
    return LinkInertia(link.mass, (cx, cy, cz), (ixx, iyy, izz, ixy, ixz, iyz))


@dataclasses.dataclass(frozen=True)
class Go2Params:
    """Full parameter set. Defaults follow the public go2_description values."""

    # ---- kinematic layout (meters) ----
    hip_offset_x: float = 0.1934  # trunk -> hip joint, |x|
    hip_offset_y: float = 0.0465  # trunk -> hip joint, |y|
    thigh_offset_y: float = 0.0955  # hip -> thigh joint, |y|
    thigh_length: float = 0.213  # thigh joint -> calf joint, -z
    calf_length: float = 0.213  # calf joint -> foot center, -z
    foot_radius: float = 0.022

    # ---- link inertias (FL-side link frames; others mirrored) ----
    trunk: LinkInertia = LinkInertia(
        mass=6.921,
        com=(0.021112, 0.0, -0.005366),
        inertia=(0.02448, 0.098077, 0.107, 0.00012166, 0.0014849, -0.0000312),
    )
    hip_fl: LinkInertia = LinkInertia(
        mass=0.678,
        com=(-0.0054, 0.00194, -0.000105),
        inertia=(0.00048, 0.000884, 0.000596, -0.00000301, 0.00000111, -0.00000142),
    )
    thigh_fl: LinkInertia = LinkInertia(
        mass=1.152,
        com=(-0.00374, -0.0223, -0.0327),
        inertia=(0.00584, 0.0058, 0.00103, 0.0000872, -0.000289, 0.000808),
    )
    # calf + foot lumped into one link (foot modeled as 0.06 kg sphere at the tip)
    calf_fl: LinkInertia = LinkInertia(
        mass=0.154,
        com=(0.00548, -0.000975, -0.115),
        inertia=(0.001088, 0.001100, 0.0000298, 0.0000000482, -0.000000343, 0.0000000801),
    )
    foot_mass: float = 0.06

    # ---- joint limits (rad, Nm) — go2_description actuator spec ----
    hip_torque_max: float = 23.7
    thigh_torque_max: float = 23.7
    calf_torque_max: float = 45.43

    # ---- default configuration (reference go2_robot_data.py:20-25) ----
    stand_height: float = 0.27
    default_joint_angles: Tuple[float, float, float] = (0.0, 0.9, -1.8)

    # ------------------------------------------------------------------
    def leg_sign(self, leg: int) -> Tuple[float, float]:
        """(sx, sy) mirror signs for leg index [FL, FR, RL, RR]."""
        sx = 1.0 if leg < 2 else -1.0  # front +x, rear -x
        sy = 1.0 if leg % 2 == 0 else -1.0  # left +y, right -y
        return sx, sy

    def hip_joint_pos(self, leg: int) -> np.ndarray:
        """Hip joint origin in trunk frame."""
        sx, sy = self.leg_sign(leg)
        return np.array([sx * self.hip_offset_x, sy * self.hip_offset_y, 0.0])

    def thigh_joint_pos(self, leg: int) -> np.ndarray:
        """Thigh joint origin in hip frame."""
        _, sy = self.leg_sign(leg)
        return np.array([0.0, sy * self.thigh_offset_y, 0.0])

    def calf_joint_pos(self) -> np.ndarray:
        """Calf joint origin in thigh frame."""
        return np.array([0.0, 0.0, -self.thigh_length])

    def foot_pos_in_calf(self) -> np.ndarray:
        return np.array([0.0, 0.0, -self.calf_length])

    def hip_offset(self, leg: int) -> np.ndarray:
        """Body-frame offset trunk->thigh joint — the reference's 'hip offset'
        used for Raibert placement (reference go2_robot_data.py:147-161 caches
        the *thigh* frame translation as FL_hip_offset etc.)."""
        sx, sy = self.leg_sign(leg)
        return np.array(
            [sx * self.hip_offset_x, sy * (self.hip_offset_y + self.thigh_offset_y), 0.0]
        )

    def link_inertia(self, body: str, leg: int) -> LinkInertia:
        """Mirrored link inertia for `body` in {'hip','thigh','calf'} of `leg`."""
        base = {"hip": self.hip_fl, "thigh": self.thigh_fl, "calf": self.calf_fl}[body]
        sx, sy = self.leg_sign(leg)
        link = _mirror(base, flip_x=(sx < 0), flip_y=(sy < 0))
        if body == "calf":
            link = _lump_point_mass(link, self.foot_mass, self.foot_pos_in_calf())
        return link

    def total_mass(self) -> float:
        return self.trunk.mass + 4 * (
            self.hip_fl.mass + self.thigh_fl.mass + self.calf_fl.mass + self.foot_mass
        )

    def default_q(self) -> np.ndarray:
        """Default configuration (standing), pinocchio layout (19,)."""
        q = np.zeros(NQ)
        q[2] = self.stand_height
        q[6] = 1.0  # quat w (xyzw)
        for leg in range(4):
            q[7 + 3 * leg : 10 + 3 * leg] = self.default_joint_angles
        return q


def _lump_point_mass(link: LinkInertia, m_pt: float, p: np.ndarray) -> LinkInertia:
    """Combine a link with a point mass at position p (link frame)."""
    m0 = link.mass
    c0 = np.asarray(link.com)
    m = m0 + m_pt
    c = (m0 * c0 + m_pt * p) / m
    I0 = link.inertia_matrix()

    def shift(I_com, mass, d):
        # parallel axis: inertia about new point offset by d from the COM
        return I_com + mass * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

    I_new = shift(I0, m0, c0 - c) + shift(np.zeros((3, 3)), m_pt, p - c)
    return LinkInertia(
        mass=float(m),
        com=tuple(float(v) for v in c),
        inertia=(
            float(I_new[0, 0]),
            float(I_new[1, 1]),
            float(I_new[2, 2]),
            float(I_new[0, 1]),
            float(I_new[0, 2]),
            float(I_new[1, 2]),
        ),
    )


DEFAULT_PARAMS = Go2Params()
