"""The port's native f64 oracle and its two force-parity tools on the CPU.

- ``convex_mpc_tpu_torch.utils.native_oracle.solve_qp_native`` against the
  JAX package's on the instance of ``tests/test_native_oracle.py``: the same
  x, y and info, bitwise. JAX's builder writes ``native/build/`` in place,
  where ``tests/test_native_oracle.py`` may build at the same moment, so here
  it builds into this test's own directory (its code, its flags).
- The port's builder: a library named by the hash of source and flags under
  ``build/native/``, never ``native/build/libqp_solver.so``; a failing or
  missing ``g++`` raises with the compiler's output.
- The port's condensed ``admm.solve`` at the parity sweep's settings within
  the 2% force-parity budget of the oracle on seeded instances (the JAX
  solve's error printed beside it).
- ``tools/torch_parity_sweep.py --n 3`` and ``tools/torch_loop_parity.py
  --adaptive --seconds 0.3`` exit 0 with ``--cpu``; both refuse without CUDA.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))

import qp_oracle as oracle  # noqa: E402
import torch_loop_parity  # noqa: E402
import torch_parity_sweep  # noqa: E402
from convex_mpc_tpu_torch.utils import native_oracle as NO  # noqa: E402

Q_DIAG = np.array([1, 1, 50, 10, 20, 1, 2, 2, 1, 1, 1, 1], dtype=float)
# one thread per tool process: the tests run beside each other
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


@pytest.fixture(scope="module")
def instance():
    sc = oracle.trot_scenario(t0=0.123, vx=0.5, wz=0.5, seed=3)
    return oracle.assemble_qp(sc["Ad"], sc["Bd"], sc["gd"], sc["x0"], sc["x_ref"],
                              sc["contact"], Q_DIAG, 1e-5, 0.8, 10.0)


def test_native_oracle_bitwise_equal_to_jax(instance, tmp_path, monkeypatch):
    from convex_mpc_tpu.utils import native_oracle as JNO

    monkeypatch.setattr(JNO, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(JNO, "_SO_PATH", tmp_path / "libqp_solver.so")
    monkeypatch.setattr(JNO, "_lib", None)
    d = instance
    for kw in (dict(max_iter=5000), dict(max_iter=300, rho=0.05, alpha=1.5)):
        xj, yj, ij = JNO.solve_qp_native(d["P"], d["q"], d["A"], d["l"], d["u"], **kw)
        xt, yt, it = NO.solve_qp_native(d["P"], d["q"], d["A"], d["l"], d["u"], **kw)
        assert np.array_equal(xj, xt) and np.array_equal(yj, yt)
        assert ij == it, (ij, it)


def test_native_oracle_builds_by_hash():
    path = NO.build()
    assert path == NO.library_path() and path.exists()
    assert path.parent == ROOT / "build" / "native"
    assert path.name.startswith("libqp_solver-") and path.name != "libqp_solver.so"
    assert "build/" in (ROOT / ".gitignore").read_text().splitlines()
    assert not list(path.parent.glob("*.tmp*")), "a temporary build file was left behind"


def test_native_oracle_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "qp_solver.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(NO, "SRC", bad)
    monkeypatch.setattr(NO, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*error"):
        NO.build()
    assert not list((tmp_path / "build").iterdir())
    monkeypatch.setenv("PATH", str(tmp_path / "nothing"))
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        NO.build()


def _jax_first_forces(sc) -> np.ndarray:
    import jax
    import jax.numpy as jnp
    from convex_mpc_tpu.control.srb import SrbDynamics
    from convex_mpc_tpu.mpc import admm, condensed

    f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    data, _ = condensed.build_condensed(
        SrbDynamics(Ad=f(sc["Ad"]), Bd=f(sc["Bd"]), gd=f(sc["gd"])), f(sc["x0"]),
        f(sc["x_ref"]), jnp.asarray(sc["contact"]), f(Q_DIAG), 1e-5, 0.8, 10.0)
    st = admm.init_state(data)._replace(rho=jnp.asarray(0.1, jnp.float32))
    sol = jax.jit(lambda d, s: admm.solve(d, s, max_iter=150, scaled_termination=True,
                                          eps_abs=1e-4, eps_rel=1e-4, box_tail=192))(data, st)
    return np.asarray(sol.x, float).reshape(16, 12)[0]


@pytest.mark.parametrize("k", range(4))
def test_condensed_solve_within_2pct_of_oracle(k):
    """The sweep's instance k: the port's first-step forces within 2% of the
    oracle's (of their largest entry, at least 1 N), as the sweep measures."""
    torch.set_num_threads(2)
    sc, d = list(torch_parity_sweep.instances(k + 1))[k]
    x64, info = NO.solve_captured(d)
    assert info["kkt"] < 1e-6, info
    u_ref = x64[192:204]
    u = torch_parity_sweep.port_forces(sc, torch.device("cpu"), 150)[0]
    scale = max(np.abs(u_ref).max(), 1.0)
    err = np.abs(u - u_ref).max() / scale * 100
    err_jax = np.abs(_jax_first_forces(sc) - u_ref).max() / scale * 100
    print(f"instance {k}: port {err:.4f}%  JAX {err_jax:.4f}%  (budget 2%)")
    assert err < 2.0


def _run(script: str, *argv: str, timeout: float = 300) -> subprocess.CompletedProcess:
    res = subprocess.run([sys.executable, str(ROOT / script), *argv], capture_output=True,
                         text=True, timeout=timeout, env=ONE_THREAD)
    assert res.returncode == 0, f"stdout:\n{res.stdout}\nstderr:\n{res.stderr[-3000:]}"
    return res


def test_parity_sweep_cpu():
    out = _run("tools/torch_parity_sweep.py", "--cpu", "--n", "3").stdout
    assert "over the 2.0% BASELINE budget: 0/3" in out
    assert "instances: 3" in out


def test_loop_parity_cpu():
    out = _run("tools/torch_loop_parity.py", "--cpu", "--adaptive", "--seconds", "0.3").stdout
    assert "cycles: 15  (vx=0.5 wz=0.0  adaptive solver)" in out
    assert "over 2% budget: 0/15 cycles" in out


@pytest.mark.parametrize("tool", [torch_parity_sweep, torch_loop_parity],
                         ids=lambda m: m.__name__)
def test_parity_tools_refuse_without_cuda(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main([])
