"""Carry state and constants across: numpy trees <-> the port's NamedTuples.

``from_numpy`` rebuilds any of the port's NamedTuples from an object with
``_fields`` (a NamedTuple of another package, e.g. a JAX ``EngineState``
passed through ``jax.tree.map(np.asarray, ...)``) whose leaves are numpy
arrays, matching classes by name. Float leaves become f32 tensors, int32 and
bool leaves keep their type. ``to_numpy`` is its inverse. Imports no JAX.
"""

from __future__ import annotations

import functools
import importlib

import numpy as np
import torch

_MODULES = (
    "ops.linalg", "models.kinematics", "models.dynamics", "control.gait",
    "control.srb", "control.reference", "control.leg", "sim.physics",
    "mpc.qp", "mpc.condensed", "mpc.admm", "sim.tick_fused", "sim.engine", "sim.scenarios",
)


@functools.lru_cache(maxsize=None)
def _registry() -> dict:
    reg = {}
    for name in _MODULES:
        mod = importlib.import_module(f"convex_mpc_tpu_torch.{name}")
        for attr in vars(mod).values():
            if (isinstance(attr, type) and issubclass(attr, tuple)
                    and hasattr(attr, "_fields") and attr.__module__ == mod.__name__):
                reg[attr.__name__] = attr
    return reg


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor/array leaf of nested NamedTuples, plain
    tuples and lists (``None`` stays ``None``)."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    if tree is None:
        return []
    if hasattr(tree, "_fields"):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """Rebuild ``like``'s structure from its leaves in ``tree_leaves`` order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if hasattr(node, "_fields"):
            return type(node)(*(build(v) for v in node))
        return next(it)

    return build(like)


def _leaf_from_numpy(a, device):
    a = np.array(a)  # a writable copy
    if a.dtype.kind == "f":
        return torch.as_tensor(a, dtype=torch.float32, device=device)
    return torch.as_tensor(a, device=device)


def from_numpy(tree, device):
    """The port's NamedTuple of the same name, leaves as tensors on ``device``."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        cls = _registry()[type(tree).__name__]
        return cls(**{f: from_numpy(getattr(tree, f), device) for f in cls._fields})
    return _leaf_from_numpy(tree, device)


def to_numpy(tree):
    """Inverse of :func:`from_numpy`: the same NamedTuple with numpy leaves."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
