"""Generate a MuJoCo MJCF model of the Go2 from `Go2Params`.

The port's copy of ``convex_mpc_tpu/models/mjcf.py``, built on the port's own
``models/go2_params.py``: ``go2_mjcf`` returns the same string as the JAX
package's for the same arguments. The MJCF is generated from the parameter
source of truth that drives the port's kinematics and dynamics, so the
host-side MuJoCo oracle (tests) and the replay viewer agree with the port's
model by construction. MuJoCo stays host-side: nothing on the card imports
this module's consumers.
"""

from __future__ import annotations

from convex_mpc_tpu_torch.models.go2_params import Go2Params, DEFAULT_PARAMS, LEG_NAMES


def _inertial(link) -> str:
    ixx, iyy, izz, ixy, ixz, iyz = link.inertia
    cx, cy, cz = link.com
    return (
        f'<inertial pos="{cx} {cy} {cz}" mass="{link.mass}" '
        f'fullinertia="{ixx} {iyy} {izz} {ixy} {ixz} {iyz}"/>'
    )


def go2_mjcf(
    params: Go2Params = DEFAULT_PARAMS,
    ground: bool = True,
    mu: float = 0.8,
    armature: float = 0.0,
    joint_damping: float = 0.0,
) -> str:
    """Build the MJCF XML string (torque-actuated, foot spheres, flat ground).

    ``armature``/``joint_damping`` default to 0 so the bare model matches the
    analytic dynamics exactly (tests); pass the actuator values (0.01 / 0.1,
    as in the public Unitree model) for realistic closed-loop simulation.
    """
    p = params
    legs = []
    for leg_idx, leg in enumerate(LEG_NAMES):
        hx, hy, hz = p.hip_joint_pos(leg_idx)
        tx, ty, tz = p.thigh_joint_pos(leg_idx)
        cx, cy, cz = p.calf_joint_pos()
        fx, fy, fz = p.foot_pos_in_calf()
        hip = p.link_inertia("hip", leg_idx)
        thigh = p.link_inertia("thigh", leg_idx)
        calf = p.link_inertia("calf", leg_idx)  # includes lumped foot mass
        legs.append(f"""
      <body name="{leg}_hip" pos="{hx} {hy} {hz}">
        {_inertial(hip)}
        <joint name="{leg}_hip_joint" type="hinge" axis="1 0 0" damping="{joint_damping}" armature="{armature}"/>
        <body name="{leg}_thigh" pos="{tx} {ty} {tz}">
          {_inertial(thigh)}
          <joint name="{leg}_thigh_joint" type="hinge" axis="0 1 0" damping="{joint_damping}" armature="{armature}"/>
          <body name="{leg}_calf" pos="{cx} {cy} {cz}">
            {_inertial(calf)}
            <joint name="{leg}_calf_joint" type="hinge" axis="0 1 0" damping="{joint_damping}" armature="{armature}"/>
            <geom name="{leg}_calf_geom" type="capsule" fromto="0 0 0 {fx} {fy} {fz}"
                  size="0.012" mass="0" contype="0" conaffinity="0" rgba="0.3 0.3 0.3 1"/>
            <geom name="{leg}_foot" type="sphere" pos="{fx} {fy} {fz}"
                  size="{p.foot_radius}" mass="0" friction="{mu} 0.02 0.01"
                  rgba="0.1 0.1 0.1 1"/>
            <site name="{leg}_foot_site" pos="{fx} {fy} {fz}" size="0.005"/>
          </body>
        </body>
      </body>""")

    ground_xml = (
        f'<geom name="floor" type="plane" size="40 40 0.1" friction="{mu} 0.02 0.01" '
        'rgba="0.8 0.9 0.8 1"/>'
        if ground
        else ""
    )
    actuators = "\n".join(
        f'    <motor name="{leg}_{j}" joint="{leg}_{j}_joint" gear="1" '
        f'ctrlrange="-{lim} {lim}"/>'
        for leg in LEG_NAMES
        for j, lim in (
            ("hip", p.hip_torque_max),
            ("thigh", p.thigh_torque_max),
            ("calf", p.calf_torque_max),
        )
    )

    return f"""
<mujoco model="go2_generated">
  <compiler angle="radian" inertiafromgeom="false"/>
  <option timestep="0.001" gravity="0 0 -9.81"/>
  <worldbody>
    {ground_xml}
    <body name="base_link" pos="0 0 {p.stand_height}">
      <freejoint name="root"/>
      {_inertial(p.trunk)}
      <geom name="trunk_geom" type="box" size="0.19 0.06 0.06" mass="0"
            contype="0" conaffinity="0" rgba="0.9 0.7 0.2 1"/>
      <site name="base_site" pos="0 0 0" size="0.005"/>
      {''.join(legs)}
    </body>
  </worldbody>
  <actuator>
{actuators}
  </actuator>
</mujoco>
"""
