"""The port's counterparts of the JAX measurement tools, on the CPU at a tiny size.

Each tool that times the card runs here with ``--cpu`` (every kernel's plain
version; its times are CPU times and are only checked to be positive) and
must print the JAX tool's report keys with a healthy batch:
``tools/torch_multi_config_bench.py`` (BASELINE config 5's eight configs),
``tools/torch_scaling_bench.py`` (legacy, adaptive and host-chunked
batches, the ``peak_batch`` line), ``tools/torch_run_sched_batch.py``
(its per-second lines, at 3 cycles a second here). Every tool that times
the card refuses to run without CUDA unless it has ``--cpu`` and is given
it: ``torch_cycle_profile.py``, ``torch_kkt_microbench.py`` and
``torch_check_bitexact.py`` have no ``--cpu``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
sys.path.insert(0, str(REPO))

import torch_check_bitexact  # noqa: E402
import torch_cycle_ablation  # noqa: E402
import torch_cycle_profile  # noqa: E402
import torch_kkt_microbench  # noqa: E402
import torch_long_sweep  # noqa: E402
import torch_multi_config_bench  # noqa: E402
import torch_run_sched_batch  # noqa: E402
import torch_scaling_bench  # noqa: E402
import torch_solve_ablation  # noqa: E402
import torch_spd_kernel_bench  # noqa: E402

torch.set_num_threads(2)

# tools/multi_config_bench.py's report and per-config keys
REPORT_KEYS = {"metric", "total_concurrent_scenarios", "aggregate_ms_per_cycle",
               "aggregate_solves_per_s", "all_upright", "configs"}
CONFIG_KEYS = {"horizon", "gait", "scenarios", "ms_per_cycle", "solves_per_s", "upright_rate",
               "iters_mean", "iters_p99"}
# tools/scaling_bench.py's per-batch keys (host-chunked rows add the last two)
SCALING_KEYS = {"batch", "ms_per_cycle", "solves_per_s", "healthy"}
CHUNK_KEYS = {"host_chunk", "n_programs"}


def _json_lines(out: str) -> list:
    return [json.loads(l) for l in out.splitlines() if l.startswith("{")]


def test_multi_config_bench_cpu(tmp_path, capsys):
    report = torch_multi_config_bench.main(
        ["--cpu", "--per-config", "1", "--chunk", "1", "--settle", "1", "--reps", "1",
         "--iters", "50", "--json", str(tmp_path / "mc.json")])
    out = capsys.readouterr().out
    assert json.loads((tmp_path / "mc.json").read_text()) == {
        k: v for k, v in report.items() if k != "launches"}
    assert REPORT_KEYS <= set(report)
    assert report["total_concurrent_scenarios"] == 8 and report["all_upright"] is True
    names = [c[0] for c in torch_multi_config_bench.CONFIGS]
    assert list(report["configs"]) == names
    horizons = {v["horizon"] for v in report["configs"].values()}
    assert horizons == {10, 16, 24, 32}
    for v in report["configs"].values():
        assert CONFIG_KEYS <= set(v) and v["upright_rate"] == 1.0 and v["solves_per_s"] > 0
    assert "launches: " in out and "device: cpu" in out
    # one line per config, then the report
    assert [next(iter(d)) for d in _json_lines(out)[:8]] == names


@pytest.mark.parametrize("argv, chunked", [
    (["--batches", "2,3", "--iters", "30"], False),
    (["--batches", "2,4", "--iters", "50", "--adaptive", "--chunk", "2"], True),
])
def test_scaling_bench_cpu(argv, chunked, capsys):
    rows = torch_scaling_bench.main(["--cpu", "--reps", "1", *argv])
    lines = _json_lines(capsys.readouterr().out)
    assert len(rows) == 2 and lines[:2] == json.loads(json.dumps(rows))
    for r in rows:
        assert SCALING_KEYS <= set(r) and r["healthy"] is True and r["solves_per_s"] > 0
    assert (CHUNK_KEYS <= set(rows[1])) == chunked
    peak = max(rows, key=lambda r: r["solves_per_s"])
    assert lines[2] == {"peak_batch": peak["batch"], "peak_solves_per_s": peak["solves_per_s"]}


def test_run_sched_batch_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch_run_sched_batch, "CYCLES_PER_SECOND", 3)
    out = torch_run_sched_batch.main(["--cpu", "--tuned", "--seconds", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert [l.split()[0] for l in lines if l.startswith("t=")] == ["t=", "t="]
    assert any(l.startswith("final: z=") for l in lines)
    assert out["finite"] and 0.1 < out["z"] < 0.6
    with pytest.raises(SystemExit):  # --tuned and --raw exclude each other
        torch_run_sched_batch.main(["--cpu", "--tuned", "--raw"])


CARD_TOOLS = [
    (torch_multi_config_bench, []), (torch_scaling_bench, []), (torch_run_sched_batch, []),
    (torch_cycle_ablation, []), (torch_solve_ablation, []), (torch_long_sweep, []),
    (torch_spd_kernel_bench, []), (torch_cycle_profile, ["--what", "solve"]),
    (torch_kkt_microbench, []), (torch_check_bitexact, []),
]


@pytest.mark.parametrize("tool, argv", CARD_TOOLS, ids=lambda v: getattr(v, "__name__", ""))
def test_tool_refuses_without_cuda(tool, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main(argv)
