"""One run of one cell: set-up, the measured window, the traced window, the
comparison with the reference, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the deployment's MPC, gait and plant settings) and a traffic mix
(``traffic/<name>.json``, read by ``traffic.py``); its limits are in
``limits/<cell>.json`` and each metric's reader in ``metrics/<metric>.py``
(see ``load_metric``). Each cycle of the window is one call of the system's
``mpc_cycle_batch`` with the production settings, every scenario starting
from the state its last cycle returned.

A configuration states its gaits (``gaits``: a list, each named and
stating its own ``gait_period`` and ``mpc_dt``); the traffic says which
scenario runs which (``traffic.py``). The program and the reference are
handed exactly each scenario's gait, and an MPC step of its period over
the horizon.
"""

from __future__ import annotations

import argparse
import ast
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import check, traffic
from benchmark.reference import cycle as RC
from benchmark.trace import profile_cycles

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "convex_mpc_tpu")
# the configuration's keys that the system's production settings must equal
ENGINE_KEYS = {"n": "horizon", "steps_per_mpc": "steps_per_mpc", "solver_iters": "solver_max_iter",
               "tau_max": "tau_max", "mpc_dt": "mpc_dt", "sim_dt": "sim_dt", "q_diag": "q_diag",
               "r_value": "r_value", "mu_mpc": "mu_mpc", "fz_min": "fz_min",
               "vel_filter_hz": "vel_filter_hz", "check_every": "check_every",
               "stall_tol": "stall_tol", "polish": "polish", "brake_accel": "brake_accel",
               "brake_alpha": "brake_alpha"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    traffic, limits and the metrics it reports (end-to-end and per-layer)."""
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    bench = root / "benchmark"

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return SimpleNamespace(
        name=name, chips=cell["chips"], config=load_json(root / conf["file"]),
        traffic=load_json(bench / "traffic" / f"{cell['traffic']}.json"),
        limits=load_json(bench / "limits" / f"{name}.json"),
        end_to_end=mine(manifest["end_to_end"]), per_layer=mine(manifest["per_layer"]),
        run_seconds=manifest["run_seconds"], metrics_dir=bench / "metrics")


def load_metric(metrics_dir: Path, name: str):
    """The reader module ``metrics/<name>.py``, or, where there is none, that
    of the name without its last dotted suffix (``solve_ms.h32`` is read by
    ``solve_ms.py``): one reader serves a quantity in every cell."""
    path = metrics_dir / f"{name}.py"
    if not path.exists() and "." in name:
        path = metrics_dir / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_identity(device) -> dict:
    """``device`` of the result line: the card's name, count, and its power
    limit as ``nvidia-smi`` reads it (None where it cannot)."""
    limit = None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
        limit = float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "power_limit_w": limit}


GAIT_KEYS = ("phase_offset", "frequency_hz", "duty", "swing_height", "touchdown_z",
             "gait_period", "mpc_dt")


def config_gaits(cfg: dict) -> dict[str, dict]:
    """The configuration's ``gaits`` by name, each with the keys
    ``GAIT_KEYS``. Each stated period is held to 1 / frequency and each MPC
    step to period / horizon."""
    named = {g["name"]: g for g in cfg["gaits"]}
    if len(named) != len(cfg["gaits"]):
        raise RuntimeError("the configuration names a gait twice")
    for name, g in named.items():
        for key, want in (("gait_period", 1.0 / g["frequency_hz"]),
                          ("mpc_dt", g["gait_period"] / cfg["horizon"])):
            if not math.isclose(g[key], want, rel_tol=1e-12):
                raise RuntimeError(f"gait {name!r} states {key} {g[key]!r}, its gait gives "
                                   f"{want!r}")
    return {name: {k: g[k] for k in GAIT_KEYS} for name, g in named.items()}


def gait_rows(cfg: dict, names) -> dict[str, np.ndarray]:
    """Each scenario's gait from its name (``names``, (B,)): float64 arrays
    (B,) of each of ``GAIT_KEYS``, (B, 4) for ``phase_offset``."""
    gaits = config_gaits(cfg)
    kinds, which = np.unique(np.asarray(names), return_inverse=True)
    return {k: np.array([gaits[n][k] for n in kinds], dtype=np.float64)[which.reshape(-1)]
            for k in GAIT_KEYS}


def engine_kwargs(cfg: dict, gait: str | None = None) -> dict:
    """The system's production settings at the configuration's horizon and
    its gait ``gait`` (by default its first), held to what the configuration
    states."""
    from convex_mpc_tpu_torch.utils.config import (EngineConfig, GaitConfig, MpcConfig,
                                                   engine_kwargs_batched)

    gaits = config_gaits(cfg)
    g = gaits[next(iter(gaits)) if gait is None else gait]
    kw = engine_kwargs_batched(EngineConfig(
        gait=GaitConfig(frequency_hz=g["frequency_hz"], duty=g["duty"],
                        phase_offset=tuple(g["phase_offset"]), swing_height=g["swing_height"],
                        touchdown_z=g["touchdown_z"]),
        mpc=MpcConfig(horizon=cfg["horizon"])))
    stated = {**cfg, "mpc_dt": g["mpc_dt"]}
    for key, ckey in ENGINE_KEYS.items():
        want, got = stated[ckey], kw[key]
        same = (list(map(float, want)) == list(map(float, got)) if isinstance(want, list)
                else math.isclose(float(want), float(got), rel_tol=1e-12))
        if not same:
            raise RuntimeError(f"the system's {key} is {got!r}, the configuration states {want!r}")
    return kw


class Program:
    """The system under test: the scenario batch and its closed loop."""

    def __init__(self, cfg: dict, tr: dict, sc: dict, device):
        from convex_mpc_tpu_torch.control import gait as G
        from convex_mpc_tpu_torch.models import dynamics as D
        from convex_mpc_tpu_torch.mpc import admm
        from convex_mpc_tpu_torch.sim import engine as E
        from convex_mpc_tpu_torch.sim import scenarios as S

        self.E, self.admm = E, admm
        self.fused = bool(tr["fused_ticks"])
        self.dyn = D.build_dyn(device=device)
        # each named gait once, from the port's public constructor, then
        # gathered by each scenario's gait
        gaits = config_gaits(cfg)
        kinds, which = np.unique(sc["gait"], return_inverse=True)
        table = [G.make_gait_params(g["frequency_hz"], g["duty"], g["phase_offset"],
                                    g["swing_height"], g["touchdown_z"], device=device)
                 for g in (gaits[n] for n in kinds)]
        rows = torch.as_tensor(which.reshape(-1), device=device)
        gait = G.GaitParams(*(torch.stack(f).index_select(0, rows) for f in zip(*table)))
        # one MPC step where every scenario's period is the same, else each
        # scenario's own
        self.kw = engine_kwargs(cfg, sc["gait"][0])
        steps = gait_rows(cfg, sc["gait"])["mpc_dt"]
        if (steps != steps[0]).any():
            self.kw = {**self.kw, "mpc_dt": torch.as_tensor(steps, dtype=torch.float32,
                                                            device=device)}
        cmds = np.stack([sc["vx"], sc["vy"], sc["wz"]], 1).astype(np.float32)
        b = S.make_batch(self.dyn, cmds, z_des=cfg["z_des"], mu=sc["mu"].astype(np.float32),
                         kn=sc["kn"].astype(np.float32), dn=sc["dn"].astype(np.float32),
                         n_horizon=cfg["horizon"])
        q = b.state.plant.q.clone()
        q[:, 0] += torch.as_tensor(sc["x_offset"].astype(np.float32), device=device)
        self.batch = b._replace(gait=gait)
        self.state = b.state._replace(plant=b.state.plant._replace(q=q))

    def cycle(self, profile=None):
        b = self.batch
        self.state, log = self.E.mpc_cycle_batch(
            self.dyn, b.gait, b.contact, b.sched, self.state, use_fused_ticks=self.fused,
            profile=profile, **self.kw)
        return log


def reference_setting(cfg: dict, sc: dict, device) -> RC.Setting:
    """The reference's deployment in float64, from the same generated inputs
    as the system's (rounded to the float32 the system is handed)."""
    f32 = lambda k: sc[k].astype(np.float32).astype(np.float64)  # noqa: E731
    return RC.Setting(cfg, gait_rows(cfg, sc["gait"]),
                      np.stack([f32("vx"), f32("vy"), f32("wz")], 1), f32("kn"), f32("dn"),
                      f32("mu"), device, torch.float64)


def banned_imports() -> list[str]:
    """Modules loaded in this process whose top-level name is banned, and
    imports in the benchmark's files of a banned top-level name (or, in the
    reference, of the system's package)."""
    found = sorted({m for m in sys.modules if m.split(".")[0] in BANNED})
    for path in sorted(HERE.rglob("*.py")):
        bad = set(BANNED) | ({"convex_mpc_tpu_torch"} if "reference" in path.relative_to(HERE).parts
                                 else set())
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) and node.module
                     and node.level == 0 else [])
            found += [f"{path.relative_to(ROOT)}: {n}" for n in names if n.split(".")[0] in bad]
    return found


def run_cell(cell: SimpleNamespace, seed: int, seconds: float, traced: bool, device,
             t_start: float, faults=None, keep: dict | None = None) -> dict:
    """One run; returns the result line's object. ``faults`` (tests only)
    breaks the program after set-up: a callable given the Program. ``keep``,
    when a dict, receives what was judged (for the control's readings)."""
    cfg, tr = cell.config, cell.traffic
    sc = traffic.scenarios(tr, seed, list(config_gaits(cfg)))
    rows_l, check_cycles = traffic.check_plan(tr, seed)
    rows = torch.as_tensor(rows_l, device=device)
    on_cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_cuda else (lambda: None)

    ident = card_identity(device) if on_cuda else {"platform": "cpu", "kind": "cpu", "count": 1}
    prog = Program(cfg, tr, sc, device)
    cap = check.Capture(rows)
    patched = []

    def patch(module, attr, new):
        """Replace ``module.attr`` until the run's program is done with."""
        patched.append((module, attr, getattr(module, attr)))
        setattr(module, attr, new)

    patch(prog.admm, "solve_adaptive", cap.wrap(prog.admm.solve_adaptive))
    try:
        t_batch = time.perf_counter()
        warm, samples = [], []
        for i in range(int(tr["warmup_cycles"])):
            cap.armed, cap.qp = i == 0, None
            prog.cycle()
            if i == 0:  # the first cycle is judged from the reference's own start
                cap.armed = False
                samples.append((rows, None, cap.qp, check.state_rows(prog.state, rows)))
            sync()
            warm.append(time.perf_counter() - t_batch - sum(warm))
        if faults is not None:
            faults(prog)
        sync()
        # what set-up made lives on: the collector need not walk it again
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t_start
        print(f"setup: {t_batch - t_start:.3f} s to the batch, warm-up cycles "
              f"{', '.join(f'{w:.3f}' for w in warm)} s, {setup_s:.3f} s in all",
              file=sys.stderr)

        B = int(tr["batch"])
        due = set(check_cycles)
        iters = []
        stage = {} if traced else None
        bad = torch.zeros((), dtype=torch.int64, device=device)

        def judged_cycle(i, profile=None):
            """Cycle ``i``, keeping its sampled rows when it is due."""
            armed = i in due
            if armed:
                s_in = check.state_rows(prog.state, rows)
                cap.armed, cap.qp = True, None
            log = prog.cycle(profile=profile)
            bad.add_((~torch.isfinite(prog.state.u0.reshape(B, 12)).all(1)).sum())
            if armed:
                cap.armed = False
                samples.append((rows, s_in, cap.qp, check.state_rows(prog.state, rows)))
            return log

        n = 0
        t0 = time.perf_counter()
        while True:
            log = judged_cycle(n, stage)
            if traced:
                iters.append(log.solver_iters)
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        window_s = time.perf_counter() - t0
        attempted = B * n
        # a judged cycle that the window did not reach runs after it, untimed:
        # its answer is late, not missing
        for i in range(n, max(due, default=-1) + 1):
            judged_cycle(i)

        layer = {}
        if traced:
            ctx = SimpleNamespace(
                batch=B, horizon=cfg["horizon"], nz=12 * cfg["horizon"],
                steps=cfg["steps_per_mpc"], fused=prog.fused, stage_s=stage, stage_cycles=n,
                iters=torch.stack(iters).cpu().numpy(), counters={}, prog=prog,
                contact=prog.batch.contact, gaits=sc["gait"],
                power_limit_w=ident.get("power_limit_w"),
                trace=None, prof_logs=[], patch=patch)
            readers = {m["name"]: load_metric(cell.metrics_dir, m["name"])
                       for m in cell.per_layer}
            for r in readers.values():
                if hasattr(r, "install"):
                    r.install(ctx)

            def profiled_cycle():
                leg0 = prog.state.leg.last_mask
                log = prog.cycle()
                ctx.prof_logs.append(SimpleNamespace(log=log, last_mask0=leg0))

            ctx.trace = profile_cycles(profiled_cycle, int(tr["profiled_cycles"]), device)
            attempted += B * int(tr["profiled_cycles"])
            bad += sum((~torch.isfinite(p.log.ticks.force.reshape(B, -1)).all(1)).sum()
                       for p in ctx.prof_logs)
            layer = {"readers": readers, "ctx": ctx}
        failed = int(bad)
    finally:
        gc.unfreeze()
        for module, attr, old in reversed(patched):
            setattr(module, attr, old)

    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    result_metrics = {}
    if traced:
        ctx = layer["ctx"]
        ctx.prog = None
        for m in cell.per_layer:
            v = layer["readers"][m["name"]].read(ctx)
            if v is None:
                continue
            extra = v if isinstance(v, dict) else {"value": v}
            result_metrics[m["name"]] = {"value": float(extra.pop("value")), "unit": m["unit"],
                                         **extra}
    else:
        ctx = SimpleNamespace(setup_s=setup_s, attempted=attempted, window_s=window_s, cycles=n)
        for m in cell.end_to_end:
            v = load_metric(cell.metrics_dir, m["name"]).read(ctx)
            if v is not None:
                result_metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the program's state goes before the reference runs
    del prog, log
    if on_cuda:
        torch.cuda.empty_cache()
    setting = reference_setting(cfg, sc, device)
    start_ref = {k: v.index_select(0, rows) for k, v in
                 RC.init_state(setting, sc["x_offset"].astype(np.float32).astype(np.float64))
                 .items()}
    readings = check.per_row(setting, start_ref, samples)
    nums = check.numbers(readings)
    for k, v in readings.items():
        if v.size:
            print(f"readings {k}: median {np.median(v)!r} p90 {np.percentile(v, 90)!r} "
                  f"max {v.max()!r} of {v.size}", file=sys.stderr)
    if keep is not None:
        keep.update(setting=setting, start_ref=start_ref, samples=samples, scenarios=sc,
                    rows=rows, readings=readings)
    correct, checks = check.verdict(nums, cell.limits, failed)

    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": result_metrics,
           "device": {**ident, "memory_peak_bytes": int(peak), "cycles_in_window": n,
                      "judged_cycles": len(samples) - 1, "judged_rows": len(rows_l)}}
    if traced:
        t = layer["ctx"].trace
        out["device"].update(busy_s=t.busy_s, window_s=t.window_s, profiled_cycles=t.cycles,
                             host_launches=t.host_launches,
                             device_work_without_a_launch=t.unmatched_device)
        out["breakdown"] = {"device_ops": t.device_ops(), "idle_gaps": t.idle_gaps()}
    out["checks"] = checks
    return out


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on one H100.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()} with "
              f"{torch.cuda.device_count()} device(s)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.set_num_threads(2)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    bad = banned_imports()
    if bad:
        print(f"benchmark: banned modules or imports: {bad}", file=sys.stderr)
        return 3
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0
