"""Port parity: the 20-tick 1 kHz window against ``jax.vmap(engine._run_ticks)``.

Same battery as tests/test_tick_fused.py (random mid-gait batch covering
swing/stance edges and contact) and the same bars: 5e-3 over 20 ticks (the
stiff penalty contact amplifies f32 reassociation) and 2e-4 over one tick.
Scales are taken per channel (max over batch and time, keeping the trailing
component axis), so small-magnitude channels are held to their own size.
"""

from __future__ import annotations

import sys
from collections import namedtuple
from pathlib import Path

import jax
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parity import assert_close_scaled, t, to_port  # noqa: E402
from test_tick_fused import _battery  # noqa: E402

from convex_mpc_tpu.sim import engine as JE
from convex_mpc_tpu_torch.sim import engine as TE

_Traj = namedtuple("_Traj", ["pos_des_world", "vel_des_world"])


def _jax_window(args, steps):
    dyn = args[0]

    def post(gait_i, contact_i, cmd_i, traj_i, u0_i, plant_i, leg_i, yc, yp, vf, t0):
        return JE._run_ticks(dyn, gait_i, contact_i, cmd_i, traj_i, u0_i, plant_i, leg_i,
                             yc, yp, vf, t0, steps, 45.0, 1e-3, 30.0)

    return jax.vmap(post)(*args[1:])


def _port_window(args, steps):
    dyn, gait, contact, cmd, traj, u0, plant, leg, yc, yp, vf, t0 = args
    ptraj = _Traj(t(traj.pos_des_world), t(traj.vel_des_world))
    return TE._run_ticks(
        to_port(dyn), to_port(gait), to_port(contact), to_port(cmd), ptraj, t(u0),
        to_port(plant), to_port(leg), t(yc), t(yp), t(vf), t(t0), steps, 45.0, 1e-3, 30.0,
    )


def _assert_window(ref, port, rel):
    (jp, jl, jyc, jyp, jvf, jt), jticks = ref
    (tp, tl, tyc, typ, tvf, tt), tticks = port
    pairs = [("q", jp.q, tp.q), ("dq", jp.dq, tp.dq), ("yaw_cont", jyc, tyc),
             ("yaw_prev", jyp, typ), ("vel_filt", jvf, tvf), ("t", jt, tt)]
    pairs += [(f"leg.{f}", getattr(jl, f), getattr(tl, f)) for f in jl._fields]
    pairs += [(f"ticks.{f}", getattr(jticks, f), getattr(tticks, f)) for f in jticks._fields]
    for name, d, a in pairs:
        a = a.numpy()
        d = np.asarray(d)
        if d.dtype.kind in "iub":
            np.testing.assert_array_equal(a, d, err_msg=name)
        else:
            assert_close_scaled(a, d, rel, name, per_channel=True)


def test_window_20_ticks_matches_jax():
    args = _battery(B=6, seed=0)
    _assert_window(_jax_window(args, 20), _port_window(args, 20), 5e-3)


def test_window_one_tick_matches_jax():
    args = _battery(B=4, seed=2)
    _assert_window(_jax_window(args, 1), _port_window(args, 1), 2e-4)


def test_window_layout():
    """CycleLog.ticks keeps the vmap-of-scan layout (B, steps, ...)."""
    args = _battery(B=3, seed=1)
    (_, ticks) = _port_window(args, 5)
    assert tuple(ticks.q.shape) == (3, 5, 19)
    assert tuple(ticks.tau.shape) == (3, 5, 4, 3)
    assert tuple(ticks.contact_mask.shape) == (3, 5, 4)
