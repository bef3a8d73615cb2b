"""BENCHMARK.json and the files it names: every cell, configuration, traffic
mix, limit and per-layer metric is found by its name, and a new cell needs
only new files and entries."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark import harness, traffic

from conftest import ROOT, scenarios

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in MANIFEST[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_loads_with_every_file(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] == next(w for w in MANIFEST["workloads"]
                                    if w["name"] == cell)["config"]
    assert set(c.limits) == set(harness.check.NUMBERS)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    e2e = {m["name"] for m in c.end_to_end}
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert callable(harness.load_metric(c.metrics_dir, m["name"]).read)
    harness.engine_kwargs(c.config)  # the system's production settings are the config's
    assert set(scenarios(c, 1)) == set(traffic.PARAMS)


@pytest.mark.parametrize("gaits", [False, True])
def test_new_cell_needs_only_new_files(tmp_path, gaits):
    """A dummy configuration, traffic and cell added as new files to a copy
    of the benchmark load through the same loader: with the one gait of the
    accepted configurations, or with two gaits and a traffic of ``shares``."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads(json.dumps(MANIFEST))
    conf = json.loads((ROOT / "benchmark/configs/go2_trot_h16.json").read_text())
    conf.update(name="dummy_h16", horizon=16)
    tr = json.loads((ROOT / "benchmark/traffic/sweep1k_fused.json").read_text())
    tr.update(batch=1, vx=0.3, vy=0.0, wz=0.0, x_offset=0.0)
    if gaits:
        (g,) = conf["gaits"]
        conf["gaits"] = [{**g, "name": name, "phase_offset": po}
                         for name, po in (("trot", [0.5, 0.0, 0.0, 0.5]),
                                          ("bound", [0.0, 0.0, 0.5, 0.5]))]
        tr.update(batch=4, gait={"shares": {"trot": 0.75, "bound": 0.25}})
    (tmp_path / "benchmark/configs/dummy_h16.json").write_text(json.dumps(conf))
    (tmp_path / "benchmark/traffic/dummy_walk.json").write_text(json.dumps(tr))
    (tmp_path / "benchmark/limits/dummy.walk.json").write_text(
        (ROOT / "benchmark/limits/h16_sweep1k.fused.json").read_text())
    m["configs"].append(dict(m["configs"][0], name="dummy_h16",
                             file="benchmark/configs/dummy_h16.json"))
    m["workloads"].append({"name": "dummy.walk", "config": "dummy_h16",
                           "traffic": "dummy_walk", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    c = harness.load_cell("dummy.walk", root=tmp_path)
    assert c.config["name"] == "dummy_h16" and c.traffic["vx"] == 0.3
    assert [x["name"] for x in c.end_to_end] == ["setup_s"]
    sc = scenarios(c, 5)
    assert sc["vx"].tolist() == [0.3] * tr["batch"]
    assert sorted(sc["gait"].tolist()) == (["bound"] + ["trot"] * 3 if gaits else ["trot"])
    assert harness.engine_kwargs(c.config)["n"] == 16
