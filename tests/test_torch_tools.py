"""The port's measurement tools on the CPU at a tiny size.

``tools/torch_bench.py`` (the ``bench.py`` analog) prints one JSON line
whose keys include every key ``bench.py`` prints, with a healthy batch;
``tools/torch_realtime_latency.py`` writes its JSON with the JAX tool's
B = 1 keys and sweep keys. Times from these runs are CPU times and are only
checked to be positive.
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

import torch_bench  # noqa: E402
import torch_realtime_latency  # noqa: E402

torch.set_num_threads(2)

BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "vs_baseline_is_assumed",
              "realtime_robots_per_chip_throughput", "assumes_48hz_reference", "batch", "solver",
              "solver_max_iter", "window", "iters_mean", "iters_p99", "healthy",
              "fixed150_solves_per_s", "fixed400_solves_per_s"]
B1_KEYS = ["cycle_ms_amortized_best_window", "cycle_ms_amortized_median",
           "cycle_ms_amortized_mean_tunnel_noise", "cycle_ms_dispatch_mean",
           "cycle_ms_dispatch_p99", "iters_mean", "iters_p99", "healthy",
           "meets_budget_best_window"]


def test_bench_json_line(capsys):
    out = torch_bench.main(cpu=True, batch=2, cycles_per_window=2, windows=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(out))
    assert set(BENCH_KEYS) <= set(line), sorted(set(BENCH_KEYS) - set(line))
    assert line["healthy"] is True
    assert line["batch"] == 2 and line["solver_max_iter"] == 1000
    assert line["metric"] == "mpc_solves_per_s_per_chip" and line["device"] == "cpu"
    assert line["value"] > 0 and line["fixed150_solves_per_s"] > 0
    assert line["vs_baseline"] == line["value"] / 48.0
    assert 0 < line["iters_mean"] <= line["iters_p99"] <= 1000
    # the CPU run launches no CUDA kernel
    assert all(v == 0.0 for run in line["launches_per_cycle"].values() for v in run.values())


def test_bench_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        torch_bench.main()


def test_realtime_latency_json(tmp_path):
    path = tmp_path / "rt.json"
    out = torch_realtime_latency.main(["--cpu", "--batches", "1", "2", "--windows", "1",
                                       "--cycles", "2", "--out", str(path)])
    doc = json.loads(path.read_text())
    assert doc == json.loads(json.dumps(out))
    assert set(B1_KEYS) <= set(doc["b1"]), sorted(set(B1_KEYS) - set(doc["b1"]))
    assert doc["b1"]["healthy"] is True
    assert doc["backend"] == "cpu" and doc["budget_ms"] == 20.833
    assert set(doc["batch_cycle_ms_best_window"]) == {"1", "2"}
    assert doc["batch_cycle_ms_best_window"]["1"] == doc["b1"]["cycle_ms_amortized_best_window"]
    assert all(v > 0 for v in doc["batch_cycle_ms_best_window"].values())
    assert doc["max_realtime_batch"] == doc["realtime_robots_per_chip_guaranteed"]


def test_realtime_latency_refuses_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        torch_realtime_latency.main(["--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()
