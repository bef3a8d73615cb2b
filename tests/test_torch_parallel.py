"""The port's ``parallel/mesh.py`` on two gloo processes on the CPU.

As tests/test_distributed.py runs JAX's mesh, two OS processes join one
``torch.distributed`` group over a localhost rendezvous. Each takes its
shard of a B = 4 production start (``chip_smoke.start_batch``, bench.py's
state) with ``shard_batch``, runs one ``sharded_rollout_fn`` step of
``mpc_cycle_batch`` (``engine_kwargs_batched(DEFAULT_CONFIG)``) with a
mean-height metric, saves its new state with ``utils.checkpoint`` and then
runs ``dryrun``. Checks: each rank's state equals a one-process port run of
its shard; the all-reduced mean equals the mean over both shards; each
shard is within the JAX suite's bars of JAX's ``mpc_cycle_batch`` on the
same shard (u0 within 2.0 N, q within 5e-3). Each subprocess has a timeout
of its own (120 s), so a hung rendezvous fails the test rather than stalls
the suite. In one process: an uneven split raises, a one-process mesh is
the identity, and no entry point picks the CPU or gloo on its own.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tests"))
sys.path.insert(0, str(REPO))
import torch_parity  # noqa: E402,F401  (thread pool size)
from chip_smoke import start_batch  # noqa: E402

from convex_mpc_tpu.control import gait as JG  # noqa: E402
from convex_mpc_tpu.models import dynamics as JD  # noqa: E402
from convex_mpc_tpu.sim import engine as JE  # noqa: E402
from convex_mpc_tpu.sim import physics as JP  # noqa: E402
from convex_mpc_tpu.utils.config import DEFAULT_CONFIG as J_DEFAULT  # noqa: E402
from convex_mpc_tpu.utils.config import engine_kwargs_batched as j_kwargs  # noqa: E402
from convex_mpc_tpu_torch.parallel import mesh as M  # noqa: E402
from convex_mpc_tpu_torch.sim import engine as TE  # noqa: E402
from convex_mpc_tpu_torch.utils import checkpoint as TC  # noqa: E402
from convex_mpc_tpu_torch.utils import interop  # noqa: E402
from convex_mpc_tpu_torch.utils.config import DEFAULT_CONFIG, engine_kwargs_batched  # noqa: E402

B = 4
WORKER_TIMEOUT_S = 120

WORKER = r"""
import json, sys
import torch
torch.set_num_threads(2)
sys.path.insert(0, {repo!r})
from chip_smoke import start_batch
from convex_mpc_tpu_torch.parallel import mesh as M
from convex_mpc_tpu_torch.sim import engine as E
from convex_mpc_tpu_torch.utils import checkpoint as C
from convex_mpc_tpu_torch.utils.config import DEFAULT_CONFIG, engine_kwargs_batched

rank = int(sys.argv[1])
M.init_distributed(init_method={init!r}, world_size=2, rank=rank, device="cpu")
assert torch.distributed.get_backend() == "gloo"
mesh = M.make_mesh(["cpu", "cpu"])
assert (mesh.rank, mesh.size) == (rank, 2), mesh
dyn, *batch = start_batch({B}, torch.device("cpu"))
local = M.shard_batch(mesh, tuple(batch))
kw = engine_kwargs_batched(DEFAULT_CONFIG)
step = lambda a: (*a[:3], E.mpc_cycle_batch(dyn, *a, **kw)[0])
fn = M.sharded_rollout_fn(mesh, step, lambda a: {{"height": a[3].plant.q[:, 2]}})
out, metrics = fn(local)
C.save_pytree({out!r} + f"/rank{{rank}}", out[3])
with open({out!r} + f"/rank{{rank}}.json", "w") as f:
    json.dump({{"height": float(metrics["height"]), "local_batch": int(out[3].t.shape[0])}}, f)
M.dryrun(mesh)
torch.distributed.destroy_process_group()
print(f"rank {{rank}} done")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Run the two gloo workers; returns (outputs dir, their stdout)."""
    out = tmp_path_factory.mktemp("ranks")
    script = out / "worker.py"
    script.write_text(WORKER.format(repo=str(REPO), B=B, out=str(out),
                                    init=f"tcp://127.0.0.1:{_free_port()}"))
    env = dict(os.environ, PYTHONPATH=str(REPO), GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, str(script), str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    return out, logs


@pytest.fixture(scope="module")
def port_start():
    dyn, *batch = start_batch(B, torch.device("cpu"))
    return dyn, tuple(batch)


def _one_process_step(dyn, batch, lo, hi):
    local = interop.tree_map(lambda x: x[lo:hi].clone(), batch)
    return TE.mpc_cycle_batch(dyn, *local, **engine_kwargs_batched(DEFAULT_CONFIG))[0]


def _rank_state(out, r, like):
    return TC.load_pytree(out / f"rank{r}", like)


def test_each_rank_equals_one_process_run(two_ranks, port_start):
    out, _ = two_ranks
    dyn, batch = port_start
    for r in range(2):
        ref = _one_process_step(dyn, batch, 2 * r, 2 * r + 2)
        got = _rank_state(out, r, ref)
        for a, b in zip(interop.tree_leaves(got), interop.tree_leaves(ref)):
            assert torch.equal(a, b)


def test_all_reduced_mean_height(two_ranks, port_start):
    out, _ = two_ranks
    dyn, batch = port_start
    h = torch.cat([_one_process_step(dyn, batch, 2 * r, 2 * r + 2).plant.q[:, 2]
                   for r in range(2)])
    reported = [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]
    assert [m["local_batch"] for m in reported] == [2, 2]
    assert reported[0]["height"] == reported[1]["height"]
    np.testing.assert_allclose(reported[0]["height"], float(h.mean()), rtol=1e-6)


def test_shards_match_jax(two_ranks, port_start):
    """Each rank's shard against JAX's mpc_cycle_batch on the same shard."""
    out, _ = two_ranks
    dyn = JD.build_dyn()
    contact = JP.default_contact(kn=30000, dn=1000)
    state = JE.init_state(dyn, n=16)._replace(plant=JP.init_plant(dyn, contact=contact))
    state_b = JE.broadcast_batch(state, B)
    q0 = np.asarray(port_start[1][3].plant.q)  # the port's x offsets, f32
    state_b = state_b._replace(plant=state_b.plant._replace(q=jnp.asarray(q0)))
    full = (JE.broadcast_batch(JG.make_gait_params(3.0, 0.6), B), JE.broadcast_batch(contact, B),
            JE.broadcast_batch(JE.constant_schedule(vx=0.5), B), state_b)
    kw = j_kwargs(J_DEFAULT)
    like = _one_process_step(*port_start, 0, 2)
    for r in range(2):
        shard = jax.tree.map(lambda x: x[2 * r:2 * r + 2], full)
        ref, _ = JE.mpc_cycle_batch(dyn, *shard, **kw)
        got = _rank_state(out, r, like)
        du0 = np.abs(got.u0.numpy() - np.asarray(ref.u0)).max()
        dq = np.abs(got.plant.q.numpy() - np.asarray(ref.plant.q)).max()
        assert du0 < 2.0, (r, du0)
        assert dq < 5e-3, (r, dq)


def test_dryrun_on_two_ranks(two_ranks):
    _, logs = two_ranks
    for log in logs:
        assert "dryrun(2 ranks): ok, mean height" in log, log
        h = float(log.split("mean height ")[1].split(" m")[0])
        assert 0.1 < h < 0.5


def test_uneven_split_raises():
    mesh = M.Mesh(group=None, rank=1, size=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="a batch of 3 does not split evenly over 2 ranks"):
        M.shard_batch(mesh, (torch.zeros(3, 2),))
    part = M.shard_batch(mesh, (torch.arange(4.0), [torch.arange(8.0).reshape(4, 2)]))
    assert part[0].tolist() == [2.0, 3.0] and part[1][0].tolist() == [[4.0, 5.0], [6.0, 7.0]]


def test_single_process_mesh_is_identity():
    """No group: the shard is the whole batch, the mean the local mean, and
    ``replicated`` places every leaf whole."""
    M.init_distributed()  # asks for nothing: no group
    assert not torch.distributed.is_initialized()
    mesh = M.make_mesh(["cpu"])
    assert mesh == M.Mesh(group=None, rank=0, size=1, device=torch.device("cpu"))
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(M.shard_batch(mesh, x), x)
    assert torch.equal(M.replicated(mesh)((x,))[0], x)
    fn = M.sharded_rollout_fn(mesh, lambda s: s + 1, lambda s: {"m": s[:, 0]})
    y, metrics = fn(x)
    assert torch.equal(y, x + 1) and float(metrics["m"]) == 3.0
    assert M.sharded_rollout_fn(mesh, lambda s: s)(x)[1] == {}


def test_no_silent_cpu_or_gloo(monkeypatch):
    """Without CUDA, the default device raises instead of picking the CPU,
    so neither the mesh nor the backend falls back on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_distributed(init_method="tcp://127.0.0.1:1", world_size=2, rank=0)
