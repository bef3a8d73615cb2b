"""Each scenario's gait and MPC step from the configuration and the traffic.

The accepted cells build what they built before a configuration could state
its gaits, bit for bit; bound, pace and a mix of gaits follow the reference
on the CPU; a reference handed the wrong gait is caught; and where the
gaits' periods differ, each scenario gets its own MPC step, on both sides.
"""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import cycle as RC
from benchmark.reference import gait as RG
from benchmark.reference import physics as RP

from conftest import ROOT, follow, scenarios, small_cell

CPU = torch.device("cpu")
CELLS = ("h32_trot1280.fused", "h16_sweep1k.fused", "h10_sweep10k.fused")
# BASELINE config 5's phase offsets, legs [FL, FR, RL, RR]
# (tools/torch_multi_config_bench.py)
TROT, BOUND, PACE = [0.5, 0.0, 0.0, 0.5], [0.0, 0.0, 0.5, 0.5], [0.5, 0.0, 0.5, 0.0]
# config 5's traffic for its bound and pace: vx 0.3, starts over +-2 cm
CONFIG5 = dict(vx=0.3, vy=0.0, wz=0.0, x_offset={"linspace": [-0.02, 0.02]})


def named_gait(name, offsets, hz=3.0, duty=0.6, horizon=16) -> dict:
    period = 1.0 / hz
    return {"name": name, "phase_offset": offsets, "frequency_hz": hz, "duty": duty,
            "swing_height": 0.1, "touchdown_z": 0.02, "gait_period": period,
            "mpc_dt": period / horizon}


def h16_config(**change) -> dict:
    cfg = json.loads((ROOT / "benchmark/configs/go2_trot_h16.json").read_text())
    return {**cfg, **change}


def one_gait(name, offsets) -> dict:
    """``go2_trot_h16.json`` with one gait of another pattern of phase
    offsets."""
    (g,) = h16_config()["gaits"]
    return h16_config(gaits=[{**g, "name": name, "phase_offset": offsets}])


def gait_mix(*gaits) -> dict:
    """``go2_trot_h16.json`` stating ``gaits`` in place of its one gait."""
    return h16_config(gaits=list(gaits))


def leaves(tree) -> list:
    if torch.is_tensor(tree):
        return [tree]
    return [x for t in tree if t is not None for x in leaves(t)]


def same(a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
               for x, y in zip(leaves(a), leaves(b), strict=True))


def parent_scenarios(tr: dict, seed: int) -> dict:
    """The traffic generator as it was before gaits: seven parameters."""
    batch = int(tr["batch"])
    set_rng = np.random.default_rng(int(tr["set_seed"]))
    order = np.random.default_rng(np.random.SeedSequence([int(seed) & (2**64 - 1), 1]))
    out = {}
    for name in ("vx", "vy", "wz", "x_offset", "kn", "dn", "mu"):
        spec = tr[name]
        if isinstance(spec, (int, float)):
            vals = np.full(batch, float(spec))
        elif "uniform" in spec:
            vals = set_rng.uniform(*spec["uniform"], size=batch)
        else:
            vals = np.linspace(*spec["linspace"], batch)
        out[name] = vals[order.permutation(batch)]
    return out


@pytest.mark.parametrize("seed", [1, 2**31 + 12345])
@pytest.mark.parametrize("name", CELLS)
def test_accepted_cells_build_as_before(name, seed):
    """The scenarios, the program's batch and keyword arguments and the
    reference's setting, against their construction before gaits could be
    stated: ``make_batch``'s trot, ``MpcConfig(horizon)``'s defaults, the
    reference's gait from frequency and duty and one step from the
    configuration's period."""
    from convex_mpc_tpu_torch.models import dynamics as D
    from convex_mpc_tpu_torch.sim import scenarios as S
    from convex_mpc_tpu_torch.utils.config import EngineConfig, MpcConfig, engine_kwargs_batched

    cell = harness.load_cell(name)
    cfg, tr = cell.config, cell.traffic
    sc, old = scenarios(cell, seed), parent_scenarios(tr, seed)
    assert list(sc) == [*old, "gait"]
    for k, v in old.items():
        assert sc[k].dtype == v.dtype and np.array_equal(sc[k], v), k
    assert sc["gait"].shape == (tr["batch"],) and (sc["gait"] == "trot").all()

    prog = harness.Program(cfg, tr, sc, CPU)
    (g,) = cfg["gaits"]
    f32 = lambda k: old[k].astype(np.float32)  # noqa: E731
    b = S.make_batch(D.build_dyn(device=CPU), np.stack([f32("vx"), f32("vy"), f32("wz")], 1),
                     z_des=cfg["z_des"], gait_hz=g["frequency_hz"], gait_duty=g["duty"],
                     mu=f32("mu"), kn=f32("kn"), dn=f32("dn"), n_horizon=cfg["horizon"])
    q = b.state.plant.q.clone()
    q[:, 0] += torch.as_tensor(f32("x_offset"))
    state = b.state._replace(plant=b.state.plant._replace(q=q))
    for part, want, got in (("gait", b.gait, prog.batch.gait),
                            ("contact", b.contact, prog.batch.contact),
                            ("sched", b.sched, prog.batch.sched), ("state", state, prog.state)):
        assert same(want, got), part
    kw = engine_kwargs_batched(EngineConfig(mpc=MpcConfig(horizon=cfg["horizon"])))
    assert prog.kw == kw and type(prog.kw["mpc_dt"]) is float

    st = harness.reference_setting(cfg, sc, CPU)
    B, f64 = tr["batch"], torch.float64
    r = lambda k: old[k].astype(np.float32).astype(np.float64)  # noqa: E731
    t = lambda v: torch.as_tensor(v, dtype=f64)  # noqa: E731
    vec = lambda v: t(v).expand(B).clone()  # noqa: E731
    gait = RG.GaitParams(*(v.expand((B,) + tuple(v.shape)).clone()
                           for v in RG.make_gait_params(g["frequency_hz"], g["duty"], dtype=f64)))
    base = RP.default_contact(dtype=f64)
    contact = RP.ContactParams(
        kn=vec(r("kn")), dn=vec(r("dn")), mu=vec(r("mu")), vtol=vec(base.vtol),
        ground_z=vec(0.0), foot_radius=vec(base.foot_radius), armature=vec(base.armature),
        joint_damping=vec(base.joint_damping))
    c = t(np.stack([r("vx"), r("vy"), r("wz")], 1))
    cmd = (c[:, 0], c[:, 1], vec(cfg["z_des"]), c[:, 2])
    assert same(gait, st.gait) and same(contact, st.contact) and same(cmd, st.cmd)
    assert type(st.mpc_dt) is float and st.mpc_dt == g["gait_period"] / cfg["horizon"]


@pytest.mark.parametrize("pattern,offsets", [("bound", BOUND), ("pace", PACE)])
def test_other_gaits_follow_the_reference(pattern, offsets):
    """Config 5's bound and pace at horizon 16: three scenarios, three cycles,
    the bars of ``test_reference_follows_the_system``."""
    cell = small_cell("h16_sweep1k.fused", batch=3, **CONFIG5)
    cell.config = one_gait(pattern, offsets)
    follow(cell)


def mix_cell(*gaits, batch=6, **traffic):
    cell = small_cell("h16_sweep1k.fused", batch=batch, check_rows=batch, **CONFIG5,
                      gait={"shares": {g["name"]: 1 / len(gaits) for g in gaits}}, **traffic)
    cell.config = gait_mix(*gaits)
    return cell


def test_same_period_mix_is_correct():
    """Trot, bound and pace at 3 Hz in one batch of six: one MPC step for
    all, and every scenario judged."""
    cell = mix_cell(named_gait("trot", TROT), named_gait("bound", BOUND),
                    named_gait("pace", PACE))
    kept = {}
    res = harness.run_cell(cell, 2**31 + 101, 1.0, False, CPU, time.perf_counter(), keep=kept)
    assert sorted(kept["scenarios"]["gait"].tolist()) == ["bound"] * 2 + ["pace"] * 2 + ["trot"] * 2
    assert type(kept["setting"].mpc_dt) is float
    assert res["correct"] is True, res["checks"]


def test_trot_reference_for_bound_program_is_not_correct(monkeypatch):
    """The program runs bound; the reference is handed trot under bound's
    name: the QPs' contact rows differ."""
    cell = small_cell("h16_sweep1k.fused", batch=3, check_rows=3, **CONFIG5)
    cell.config = one_gait("bound", BOUND)
    trot = one_gait("bound", TROT)
    real = harness.reference_setting
    monkeypatch.setattr(harness, "reference_setting", lambda cfg, sc, dev: real(trot, sc, dev))
    res = harness.run_cell(cell, 2**31 + 102, 1.0, False, CPU, time.perf_counter())
    assert res["correct"] is False
    c = res["checks"]["qp_gap"]
    assert c["value"] > c["limit"]


STEPS = (named_gait("trot", TROT), named_gait("trot_fast", TROT, 3.5, 0.5),
         named_gait("trot_slow", TROT, 2.5, 0.7))


def test_reference_mixed_steps_equal_scalar_runs():
    """The float64 reference's update with each scenario's own step equals,
    in each gait's rows, its update with that gait's step as a float."""
    cfg = gait_mix(*STEPS)
    names = np.array(["trot", "trot_fast", "trot_slow", "trot_slow", "trot", "trot_fast"])
    B = len(names)
    rng = np.random.default_rng(5)
    cmds = np.stack([rng.uniform(-0.3, 0.8, B), rng.uniform(-0.2, 0.2, B),
                     rng.uniform(-1.5, 1.5, B)], 1)
    st = RC.Setting(cfg, harness.gait_rows(cfg, names), cmds, 30000.0, 1000.0, 0.8, CPU,
                    torch.float64)
    want = np.array([1.0 / {"trot": 3.0, "trot_fast": 3.5, "trot_slow": 2.5}[n] / 16
                     for n in names])
    assert st.mpc_dt.dtype == torch.float64 and np.array_equal(st.mpc_dt.numpy(), want)
    assert torch.equal(st.rows(torch.tensor([4, 1])).mpc_dt, st.mpc_dt[[4, 1]])
    s = RC.init_state(st, rng.uniform(-0.02, 0.02, B))
    # mid-gait clocks, on the float32 grid the deployment's clock keeps
    s["t"] = torch.as_tensor(rng.uniform(0.0, 0.6, B).astype(np.float32), dtype=torch.float64)
    mixed = RC.update(st, s)
    for name in ("trot", "trot_fast", "trot_slow"):
        rows = torch.as_tensor(np.flatnonzero(names == name))
        one = st.rows(torch.arange(B))
        one.mpc_dt = float(want[rows[0]])
        alone = RC.update(one, s)
        for a, b in zip(leaves(mixed), leaves(alone), strict=True):
            assert torch.equal(a.index_select(0, rows), b.index_select(0, rows)), name
        others = torch.as_tensor(np.flatnonzero(names != name))
        assert not torch.equal(mixed[0].P.index_select(0, others),
                               alone[0].P.index_select(0, others))


def test_program_gets_each_scenarios_step():
    """Gaits of three periods: the harness hands ``mpc_cycle_batch`` a (B,)
    float32 step, each scenario's period over 16 in scenario order, and
    each scenario's gait."""
    cell = mix_cell(*STEPS)
    sc = scenarios(cell, 2**31 + 7)
    prog = harness.Program(cell.config, cell.traffic, sc, CPU)
    seen = {}

    def entry(dyn, gait, contact, sched, state, **kw):
        seen.update(kw, gait=gait)
        return state, None

    prog.E = SimpleNamespace(mpc_cycle_batch=entry)
    prog.cycle()
    hz = np.array([{"trot": 3.0, "trot_fast": 3.5, "trot_slow": 2.5}[n] for n in sc["gait"]])
    assert seen["mpc_dt"].dtype == torch.float32 and seen["mpc_dt"].shape == (6,)
    assert torch.equal(seen["mpc_dt"], torch.as_tensor(1.0 / hz / 16, dtype=torch.float32))
    assert torch.equal(seen["gait"].period, torch.as_tensor(1.0 / hz, dtype=torch.float32))
    assert {k: v for k, v in seen.items() if k not in ("mpc_dt", "gait")} == {
        k: v for k, v in harness.engine_kwargs(cell.config).items() if k != "mpc_dt"} | {
        "use_fused_ticks": True, "profile": None}
    # one gait at 3.5 Hz is a configuration of its own, with its own step
    assert harness.engine_kwargs(gait_mix(STEPS[1]))["mpc_dt"] == pytest.approx(
        1 / 3.5 / 16, rel=1e-15)


def test_stated_step_is_held_to_the_period():
    cfg = gait_mix(dict(STEPS[1], mpc_dt=1 / 3.0 / 16))
    with pytest.raises(RuntimeError, match="mpc_dt"):
        harness.config_gaits(cfg)
