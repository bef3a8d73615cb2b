"""The port's import rule: no file of ``convex_mpc_tpu_torch/``, not
``chip_smoke.py``, ``kernel_times.py``, ``tools/torch_ensemble_cert.py``,
``tools/torch_bench.py``, ``tools/torch_realtime_latency.py``, the two
parity tools, ``tools/torch_time_dashboard.py`` or the two
``examples/torch_*.py`` demos imports JAX or the JAX package (not even its
modules that use no JAX). An AST scan, so imports inside functions count
too. ``tests/qp_oracle.py`` (numpy and scipy only) is allowed: it is the
independent oracle, kept outside both packages."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "convex_mpc_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "kernel_times.py", ROOT / "tools" / "torch_ensemble_cert.py",
    ROOT / "tools" / "torch_bench.py", ROOT / "tools" / "torch_realtime_latency.py",
    ROOT / "tools" / "torch_parity_sweep.py", ROOT / "tools" / "torch_loop_parity.py",
    ROOT / "tools" / "torch_time_dashboard.py", ROOT / "examples" / "torch_trot_demo.py",
    ROOT / "examples" / "torch_mujoco_loop.py"]
BANNED = ("jax", "jaxlib", "convex_mpc_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _banned(mod: str) -> bool:
    return any(mod == b or mod.startswith(b + ".") for b in BANNED)


def test_file_list_is_complete():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(FILES) > 15


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _banned(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
