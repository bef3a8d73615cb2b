"""Scale-out of batched MPC rollouts over devices with ``torch.distributed``.

Port of ``convex_mpc_tpu/parallel/mesh.py`` in torch's idiom of one process
per device. The scale dimension of the engine is the scenario batch (gait x
velocity-command x terrain-friction sweeps); its per-scenario QP solves and
physics steps are embarrassingly parallel, so:

- every process joins one group (:func:`init_distributed`) and holds one
  device; :func:`make_mesh` names that 1-D layout ``"batch"`` as a small
  :class:`Mesh` NamedTuple of (group, rank, world size, device), not a
  ``torch.distributed.device_mesh.DeviceMesh``;
- each rank keeps its equal slice of the batch's leading axis
  (:func:`shard_batch`) and steps it alone: each rank's sub-batch adapts
  rho and exits the solver on its own, as each device's shard does in the
  JAX package;
- the only collectives are metric means (:func:`sharded_rollout_fn`), an
  ``all_reduce`` of the sum and the count.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from convex_mpc_tpu_torch._device import default_device
from convex_mpc_tpu_torch.utils.interop import tree_map

BATCH_AXIS = "batch"


class Mesh(NamedTuple):
    """This process's place on the 1-D mesh, whose one axis is ``BATCH_AXIS``."""

    group: object  # the process group; None for one process without a group
    rank: int
    size: int  # world size: the number of shards of the batch axis
    device: torch.device


def init_distributed(backend: str | None = None, init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     device=None) -> None:
    """Join the process group (``torch.distributed.init_process_group``).

    A no-op for a single process that asks for nothing (no ``init_method``,
    ``world_size`` at most 1), as in the JAX package. The backend defaults
    to ``nccl`` when the process's device (``device``, CUDA unless the
    caller names another) is CUDA and to ``gloo`` on the CPU; it never
    falls back from one to the other.
    """
    if init_method is None and (world_size is None or world_size <= 1):
        return
    if backend is None:
        backend = "nccl" if default_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def make_mesh(devices=None) -> Mesh:
    """The 1-D ``"batch"`` mesh over the group's ranks.

    ``devices``: one device per rank (rank r computes on ``devices[r]``);
    ``None`` gives rank r the CUDA device ``r % device_count``, and raises
    without one. Without a process group the mesh is this process alone.
    """
    grouped = dist.is_available() and dist.is_initialized()
    rank, size = (dist.get_rank(), dist.get_world_size()) if grouped else (0, 1)
    if devices is None:
        default_device(None)  # raises without CUDA
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        devices = list(devices)
        if len(devices) != size:
            raise ValueError(f"{len(devices)} devices for {size} ranks")
        dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(group=dist.group.WORLD if grouped else None, rank=rank, size=size, device=dev)


def shard_batch(mesh: Mesh, tree):
    """This rank's equal slice of every leaf's leading (scenario) axis, on
    the mesh's device (a copy). Raises when the batch does not split evenly."""

    def part(x):
        B = x.shape[0]
        if B % mesh.size:
            raise ValueError(f"a batch of {B} does not split evenly over {mesh.size} ranks")
        k = B // mesh.size
        return x[mesh.rank * k:(mesh.rank + 1) * k].to(mesh.device, copy=True)

    return tree_map(part, tree)


def replicated(mesh: Mesh) -> Callable:
    """The placement that gives every rank the whole of each leaf (JAX's
    ``P()``): a function ``tree -> tree`` on this rank's device."""
    return lambda tree: tree_map(lambda x: x.to(mesh.device), tree)


def sharded_rollout_fn(mesh: Mesh, step_fn: Callable, metric_fn: Callable | None = None):
    """Wrap a batched ``state -> state`` step into a step of this rank's shard.

    ``step_fn`` already works on a leading scenario axis. Returns
    ``fn(local_state) -> (local_state, metrics)``: ``metric_fn(state) -> dict
    of (local_batch,)`` tensors, each reduced to its mean over the whole
    batch by an ``all_reduce`` of its sum and its count (None gives an empty
    dict).
    """

    def reduce_mean(v):
        s = torch.stack([v.sum(), torch.tensor(v.shape[0], dtype=v.dtype, device=v.device)])
        if mesh.group is not None:
            dist.all_reduce(s, group=mesh.group)
        return s[0] / s[1]

    def fn(state):
        new_state = step_fn(state)
        if metric_fn is None:
            return new_state, {}
        return new_state, {k: reduce_mean(v) for k, v in metric_fn(new_state).items()}

    return fn


def dryrun(mesh: Mesh) -> float:
    """One production step on the mesh: two scenarios per rank through
    ``mpc_cycle_batch`` (``solver_iters=200``), the batch-global adaptive
    solver per shard, and the mean body height all-reduced; raises unless
    it lies in 0.1-0.5 m. Returns that height."""
    from convex_mpc_tpu_torch.control import gait as G
    from convex_mpc_tpu_torch.models import dynamics as D
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.sim import physics as P

    dev = mesh.device
    batch = 2 * mesh.size
    dyn = D.build_dyn(device=dev)
    contact = P.default_contact(kn=30000, dn=1000, device=dev)
    state = E.init_state(dyn, n=16)._replace(plant=P.init_plant(dyn, contact=contact))
    args = shard_batch(mesh, tuple(E.broadcast_batch(t, batch) for t in (
        G.make_gait_params(3.0, 0.6, device=dev), contact,
        E.constant_schedule(vx=0.5, device=dev), state)))

    def step(a):
        return (*a[:3], E.mpc_cycle_batch(dyn, *a, solver_iters=200)[0])

    fn = sharded_rollout_fn(mesh, step, lambda a: {"height": a[3].plant.q[:, 2]})
    _, metrics = fn(args)
    h = float(metrics["height"])
    if not 0.1 < h < 0.5:
        raise RuntimeError(f"dry run produced implausible height {h}")
    print(f"dryrun({mesh.size} ranks): ok, mean height {h:.3f} m "
          f"(adaptive batch path, {batch} scenarios)")
    return h
