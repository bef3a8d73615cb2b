"""What decides ``correct``: the timed cycles' answers against the plain reference.

During the window the harness keeps, for the sampled scenarios of the
sampled cycles, the state each cycle started from, the QP data that the
update stage handed to the solve, and the state the cycle returned. Once the
window has closed, the reference (``reference/``, float64) works out from
that start state its own QP, the QP's optimum, and the plant state after
the ticks under the forces the cycle applied. Four gaps are read per judged
scenario-cycle:

- ``qp_gap``: the QP data, the larger of max|dP| / max|P| and
  max|dq| / max|q| (1 where the bounds differ);
- ``u0_gap``: the first step's forces against the QP's optimum, the
  force-parity error of the configuration's 2% budget,
  max|u0 - u0*| / max(max|u0*|, 1 N);
- ``plant_gap``: the plant after the ticks, max|dq_pos| together with
  max|dv| / (1 + max|v|);
- ``carry_gap``: the rest of the carried state (controller, reference,
  clock, filter), the largest absolute difference over 1 + the value's
  magnitude, 1 where the contact masks differ.

A run's numbers (``NUMBERS``) are the largest ``qp_gap`` over its judged
scenario-cycles and, for the other gaps, the share in % of judged
scenario-cycles whose gap passes its tolerance (``TOLERANCE``): for the
forces the configuration's 2% budget (the parity tools' own count), for
the plant and the carried state a level between the system's readings and
the control's. A share sees forces or states gone wrong in part of the
batch as well as in all of it, and passes the rare scenario-cycle in which
a foot sits on the plant's contact-damping switch at a tick, so that the
system's trajectory and the reference's, 1e-6 apart, take opposite sides
of it (PERF.md).

The stage checks follow the system's own state from cycle to cycle (the
schedule is chaos-marginal, so long trajectories are not compared). The
start is checked by the first cycle of every run, which the reference runs
from its own start state made from the same generated inputs; the hand-over
between cycles by starting each judged cycle from the state its
predecessor returned.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import condensed as RCo
from benchmark.reference import cycle as RC
from benchmark.reference import qp as RQ

GAPS = ("qp_gap", "u0_gap", "plant_gap", "carry_gap")
NUMBERS = ("qp_gap", "u0_over_2pct", "plant_over_tol", "carry_over_tol")
# a scenario-cycle's tolerance of each gap read as a share: the forces', the
# configuration's parity budget (BASELINE.md: contact forces within 2%)
TOLERANCE = {"u0_gap": 0.02, "plant_gap": 1e-4, "carry_gap": 5e-5}
CARRY = ("takeoff_time", "swing_p0", "swing_td", "pos_des_world", "vel_cmd", "yaw_cont",
         "yaw_prev", "t", "vel_filt")
QP_FIELDS = ("p_dense", "q", "l", "u")


def state_rows(state, rows) -> dict:
    """The system's ``EngineState`` of the scenarios ``rows`` as a dict of
    copies, keyed as ``reference.cycle.STATE_KEYS``."""
    p, leg, rg = state.plant, state.leg, state.refgen
    src = dict(q=p.q, dq=p.dq, last_mask=leg.last_mask, takeoff_time=leg.takeoff_time,
               swing_p0=leg.swing_p0, swing_td=leg.swing_td, pos_des_world=rg.pos_des_world,
               vel_cmd=rg.vel_cmd, yaw_cont=state.yaw_cont, yaw_prev=state.yaw_prev,
               u0=state.u0, t=state.t, vel_filt=state.vel_filt)
    return {k: v.index_select(0, rows) for k, v in src.items()}


class Capture:
    """Keeps the sampled rows of the QP that the solve is handed while armed."""

    def __init__(self, rows: torch.Tensor):
        self.rows = rows
        self.armed = False
        self.qp = None

    def wrap(self, solve):
        def solve_and_keep(qp, *args, **kwargs):
            if self.armed:
                self.qp = {f: getattr(qp, f).index_select(0, self.rows) for f in QP_FIELDS}
            return solve(qp, *args, **kwargs)
        return solve_and_keep


def _rowmax(x) -> torch.Tensor:
    """max |x| over every axis but the first."""
    return torch.abs(x).reshape(x.shape[0], -1).amax(1)


def stage_gaps(setting: RC.Setting, s_in: dict, qp_prog: dict, s_out: dict) -> dict:
    """The four gaps of each scenario (a (S,) tensor each) of one judged
    cycle, in the reference's dtype. ``qp_prog`` is None when no QP was seen."""
    dt = setting.dyn.mass.dtype
    s_in = {k: v.to(dt) if v.is_floating_point() else v for k, v in s_in.items()}
    qp, traj, rg, yc, yp = RC.update(setting, s_in)
    S = qp.q.shape[0]
    out = {}
    if qp_prog is None:
        out["qp_gap"] = torch.full((S,), math.inf, dtype=dt, device=qp.q.device)
    else:
        P, q = qp_prog["p_dense"].to(dt), qp_prog["q"].to(dt)
        rel = torch.maximum(_rowmax(P - qp.P) / _rowmax(qp.P),
                            _rowmax(q - qp.q) / _rowmax(qp.q).clamp(min=1e-30))
        same = ((qp_prog["l"].to(dt) == qp.l) & (qp_prog["u"].to(dt) == qp.u)).all(1)
        out["qp_gap"] = torch.where(same, rel, 1.0)
    x_opt = RQ.solve(qp.P, qp.q, RCo.constraint_matrix(qp), qp.l, qp.u)
    u0 = s_out["u0"].to(dt)
    out["u0_gap"] = (_rowmax(u0.reshape(-1, 12) - x_opt[:, :12])
                     / _rowmax(x_opt[:, :12]).clamp(min=1.0))
    nxt = RC.apply(setting, s_in, traj, rg, yc, yp, u0)
    out["plant_gap"] = torch.maximum(
        _rowmax(s_out["q"].to(dt) - nxt["q"]),
        _rowmax(s_out["dq"].to(dt) - nxt["dq"]) / (1.0 + _rowmax(nxt["dq"])))
    carry = torch.where((s_out["last_mask"] == nxt["last_mask"].to(s_out["last_mask"].dtype))
                        .all(1), 0.0, 1.0).to(dt)
    for k in CARRY:
        ref = nxt[k].reshape(S, -1)
        carry = torch.maximum(carry, _rowmax(s_out[k].to(dt).reshape(S, -1) - ref)
                              / (1.0 + _rowmax(ref)))
    out["carry_gap"] = carry
    return out


def per_row(setting: RC.Setting, start_ref: dict, samples: list) -> dict:
    """Each gap's readings over every judged scenario-cycle (numpy
    arrays). ``samples``: (rows, s_in, qp or None, s_out) per judged cycle;
    an ``s_in`` of None is the first cycle, which the reference starts from
    its own start state ``start_ref``."""
    out = {k: [] for k in GAPS}
    for rows, s_in, qp_prog, s_out in samples:
        gaps = stage_gaps(setting.rows(rows), start_ref if s_in is None else s_in, qp_prog,
                          s_out)
        for k, v in gaps.items():
            out[k].append(v.cpu().numpy())
    return {k: np.concatenate(v) if v else np.array([]) for k, v in out.items()}


def _share_over(gap: str):
    return gap, lambda v: 100.0 * float(np.mean(v > TOLERANCE[gap]))


# each number from the gaps of a run's judged scenario-cycles: the largest
# QP gap; for the rest the share over the tolerance: the solver meets its
# own tolerance, not the optimum, and on a few of its hardest scenarios
# passes the budget's 2% as the reference package's own solver does; the
# plant's penalty contact switches its damping on a threshold
STAT = {"qp_gap": ("qp_gap", np.max), "u0_over_2pct": _share_over("u0_gap"),
        "plant_over_tol": _share_over("plant_gap"), "carry_over_tol": _share_over("carry_gap")}


def numbers(rows: dict) -> dict:
    """Each number of a run from its gaps ``rows`` (inf where none was read)."""
    return {k: float(f(rows[g])) if rows[g].size else math.inf for k, (g, f) in STAT.items()}


def verdict(nums: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): every number at or under its
    limit, every number read, and no solve with non-finite forces."""
    checks = {k: {"value": nums.get(k, math.inf), "limit": limits[k]} for k in NUMBERS}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok and failed == 0, checks
