"""The control of ``correct``: the reference itself, computed one precision
below what the configuration states (float32 with TF32 matmuls, where the
configuration states float32 with TF32 off), put in the system's place.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 --seconds 5

runs the system's cell once a seed (a short window at the cell's own size),
then reads the numbers of ``check.py`` for the system and for the
control on the same judged cycles, and prints both beside the cell's
limits. The limits are set between the system's readings over a dozen
seeds and the control's (PERF.md). The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check, harness  # noqa: E402
from benchmark.reference import condensed as RCo  # noqa: E402
from benchmark.reference import cycle as RC  # noqa: E402
from benchmark.reference import qp as RQ  # noqa: E402


def control_readings(cfg: dict, kept: dict) -> dict:
    """The readings of the reference in float32 with TF32 on, put in the
    system's place on the judged cycles ``kept`` (from ``run_cell``): each
    gap's reading per judged scenario-cycle."""
    setting, sc = kept["setting"], kept["scenarios"]
    device = setting.dyn.mass.device
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        f32 = lambda k: sc[k].astype(np.float32)  # noqa: E731
        low = RC.Setting(cfg, harness.gait_rows(cfg, sc["gait"]),
                         np.stack([f32("vx"), f32("vy"), f32("wz")], 1), f32("kn"), f32("dn"),
                         f32("mu"), device, torch.float32)
        start = {k: v.index_select(0, kept["rows"]) for k, v in
                 RC.init_state(low, f32("x_offset")).items()}
        out = {k: [] for k in check.GAPS}
        for rows, s_in, _, _ in kept["samples"]:
            lo = low.rows(rows)
            s32 = start if s_in is None else {
                k: v.float() if v.is_floating_point() else v for k, v in s_in.items()}
            qp, traj, rg, yc, yp = RC.update(lo, s32)
            x = RQ.solve(qp.P, qp.q, RCo.constraint_matrix(qp), qp.l, qp.u)
            s_out = RC.apply(lo, s32, traj, rg, yc, yp, x[:, :12].reshape(-1, 4, 3))
            qp_d = {"p_dense": qp.P, "q": qp.q, "l": qp.l, "u": qp.u}
            judge_in = kept["start_ref"] if s_in is None else s_in
            for k, v in check.stage_gaps(setting.rows(rows), judge_in, qp_d, s_out).items():
                out[k].append(v.cpu().numpy())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    return {k: np.concatenate(v) for k, v in out.items()}


def quantiles(rows: dict) -> dict:
    """Each gap's readings over the judged scenario-cycles: median, 90th
    percentile and largest."""
    return {k: [float(np.median(v)), float(np.percentile(v, 90)), float(v.max())]
            for k, v in rows.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="read the control on the first this many seeds")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--span", type=int, default=None,
                    help="judge cycles among the window's first this many (default: the "
                         "first check_cycles)")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    # a short window: judge cycles among its first
    cell.traffic = dict(cell.traffic, check_span=args.span or cell.traffic["check_cycles"])
    for i, seed in enumerate(args.seeds):
        kept = {}
        res = harness.run_cell(cell, seed, args.seconds, False, device, time.perf_counter(),
                               keep=kept)
        line = {"workload": cell.name, "seed": seed, "correct": res["correct"],
                "program": {k: c["value"] for k, c in res["checks"].items()},
                "limits": {k: c["limit"] for k, c in res["checks"].items()},
                "program_rows": quantiles(kept["readings"]),
                "judged_cycles": res["device"]["judged_cycles"],
                "card": res["device"]["kind"], "power_limit_w": res["device"]["power_limit_w"]}
        if i < args.control_seeds:
            rows = control_readings(cell.config, kept)
            nums = check.numbers(rows)
            line["control"] = nums
            line["control_rows"] = quantiles(rows)
            line["control_fails"] = [k for k, v in nums.items()
                                     if not (np.isfinite(v) and v <= cell.limits[k])]
        print(json.dumps(line), flush=True)
        del kept
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
