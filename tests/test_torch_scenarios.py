"""Port parity: ``sim/scenarios.py`` against the JAX package, and the ensemble tool.

The sweep functions' per-scenario leaves (gait, contact, schedule) equal
JAX's exactly and the start state within 1e-6 of scale (each package runs
its own forward kinematics for the standing height). ``simulate_batch`` on
both paths at B = 4 for 3 cycles against JAX's: applied forces u0 within
2.0 N (the JAX suite's batched-vs-single bar), final ``height`` within
5e-3 m and ``upright`` equal; the logs in JAX's layout. The adaptive path
with the fused tick window (which JAX's jitted cycle cannot trace,
ROADMAP.md section 3) is held against the port's own eager ticks at the
same bars. ``tools/torch_ensemble_cert.py`` runs 1 s at B = 2 on the CPU.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parity import assert_tree_close, to_port  # noqa: E402
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import launches  # noqa: E402

from convex_mpc_tpu.models import dynamics as JD
from convex_mpc_tpu.sim import scenarios as JS
from convex_mpc_tpu_torch.sim import scenarios as TS

ROOT = Path(__file__).resolve().parents[1]

MAKERS = {
    "velocity": lambda S, dyn: S.velocity_sweep(dyn, 4, vx_range=(0.0, 0.5),
                                                vy_range=(-0.1, 0.1), wz_range=(-1, 1)),
    "friction": lambda S, dyn: S.friction_randomization(dyn, 4, mu_range=(0.5, 1.0), seed=1),
    "gait": lambda S, dyn: S.gait_sweep(dyn, freqs=(2.5, 3.5), duties=(0.55, 0.65)),
    # ground friction at half the MPC's mu = 0.8: the feet slip
    "friction-low-mu": lambda S, dyn: S.friction_randomization(dyn, 4, mu_range=(0.4, 0.41)),
}


@pytest.fixture(scope="module")
def dyns():
    jdyn = JD.build_dyn()
    return jdyn, to_port(jdyn)


@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_sweep_batches_match_jax(dyns, kind):
    jdyn, tdyn = dyns
    ref, out = MAKERS[kind](JS, jdyn), MAKERS[kind](TS, tdyn)
    assert out.size == ref.size == 4 and type(out).__name__ == "ScenarioBatch"
    for part in ("gait", "contact", "sched"):
        for f in getattr(ref, part)._fields:
            np.testing.assert_array_equal(getattr(getattr(out, part), f).numpy(),
                                          np.asarray(getattr(getattr(ref, part), f)),
                                          err_msg=f"{part}.{f}")
    assert_tree_close(ref.state, out.state, 1e-6)


def _compare(jres, tres, what):
    (jb, jm, _), (tb, tm, _) = jres, tres
    du0 = np.abs(tb.state.u0.numpy() - np.asarray(jb.state.u0)).max()
    dh = np.abs(tm["height"].numpy() - np.asarray(jm["height"])).max()
    print(f"{what}: |du0| {du0:.4f} N, |dheight| {dh:.2e} m, upright "
          f"{tm['upright'].numpy()} vs {np.asarray(jm['upright'])}")
    assert du0 < 2.0, du0
    assert dh < 5e-3, dh
    np.testing.assert_array_equal(tm["upright"].numpy(), np.asarray(jm["upright"]))
    for k in ("vx_err", "wz_err"):
        assert tuple(tm[k].shape) == np.asarray(jm[k]).shape
        assert torch.isfinite(tm[k]).all()


@pytest.mark.parametrize("kind, adaptive, n_cycles", [
    ("velocity", False, 3), ("gait", True, 3), ("friction-low-mu", True, 12)],
    ids=["fixed-velocity-sweep", "adaptive-gait-sweep", "adaptive-low-friction"])
def test_simulate_batch_matches_jax(dyns, kind, adaptive, n_cycles):
    """On low friction (mu 0.40-0.41, the MPC assumes 0.8) the feet slip and
    a joint passes 30 rad/s within 12 cycles: ``upright`` is False in both
    packages (as in chip_smoke.py's friction_randomization batch)."""
    jdyn, tdyn = dyns
    jb, tb = MAKERS[kind](JS, jdyn), MAKERS[kind](TS, tdyn)
    kw = dict(n_cycles=n_cycles, solver_iters=300, adaptive=adaptive, collect_logs=True)
    before = launches()
    jres = JS.simulate_batch(jdyn, jb, **kw)
    tres = TS.simulate_batch(tdyn, tb, **kw)
    assert not any(launches(before).values())  # CPU tensors: the plain versions
    _compare(jres, tres, f"{kind} adaptive={adaptive}")
    if kind == "friction-low-mu":
        assert not tres[1]["upright"].any()
    jlogs, tlogs = jres[2], tres[2]
    for f in jlogs.ticks._fields:  # (B, n_cycles, 20, ...) fixed, (n_cycles, B, ...) adaptive
        assert tuple(getattr(tlogs.ticks, f).shape) == np.asarray(getattr(jlogs.ticks, f)).shape
    assert tuple(tlogs.solver_iters.shape) == np.asarray(jlogs.solver_iters).shape


def test_simulate_batch_fused_ticks_matches_eager(dyns):
    """Per-scenario contact (mu, kn) through the fused tick window: the
    adaptive path with ``use_fused_ticks=True`` against the same path with
    the eager tick loop, at the JAX bars."""
    _, tdyn = dyns
    kw = dict(n_cycles=3, solver_iters=300, adaptive=True)
    eager = TS.simulate_batch(tdyn, MAKERS["friction"](TS, tdyn), **kw)
    fused = TS.simulate_batch(tdyn, MAKERS["friction"](TS, tdyn), use_fused_ticks=True, **kw)
    _compare(eager, fused, "friction fused vs eager")
    assert eager[2] is None and fused[2] is None


def test_ensemble_tool_smoke_cpu():
    """The ensemble tool's entry function, 1 s of the tuned schedule at B = 2
    on the CPU: both scenarios stay inside the gates (a 1 s run cannot pass
    the stop test, so pass = 0 and CP95 = 0)."""
    spec = importlib.util.spec_from_file_location("torch_ensemble_cert",
                                                  ROOT / "tools" / "torch_ensemble_cert.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    args = tool.parser().parse_args(["--cpu", "--batch", "2", "--seconds", "1", "--tuned",
                                     "--brake-yaw", "10"])
    report = tool.run(args)
    assert report["batch"] == 2 and report["seconds"] == 1 and report["profile"] == "tuned"
    assert report["pass"] == 0 and report["cp95_lower"] == 0.0
    assert report["fail_time_s"] == {0: -1.0, 1: -1.0}  # never left the gates
    assert tool.clopper_pearson_low(54, 64) == pytest.approx(0.7494, abs=1e-4)
    with pytest.raises(SystemExit):
        tool.run(tool.parser().parse_args(["--cpu", "--xla"]))
