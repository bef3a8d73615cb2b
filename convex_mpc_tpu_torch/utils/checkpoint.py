"""Checkpoint/resume of engine and scenario-batch state.

Port of ``convex_mpc_tpu/utils/checkpoint.py``: any tree of tensors (the
port's NamedTuples such as ``EngineState`` or ``ScenarioBatch``, plain
tuples, lists and dicts, ``None`` leaves) is saved to one ``.npz`` and
restored into the structure of a template. The keys are the JAX package's
``jax.tree_util.keystr`` strings (``.plant.q``, ``.solver.rho``, ``[0]``,
``['name']``; a ``None`` holds no leaf), so a file saved by either package
loads into the other. For sharded state (``parallel.mesh``), gather the
batch on one rank before saving; a restored batch can be split again with
``shard_batch``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _npz_path(path) -> Path:
    # np.savez appends ".npz" when absent; normalize so save/load agree on
    # the on-disk name regardless of the suffix the caller passed.
    p = Path(path)
    return p if p.suffix == ".npz" else p.with_suffix(p.suffix + ".npz")


def _leaves_with_keys(tree, prefix: str = ""):
    """(keystr, leaf) pairs in the JAX package's flattening order."""
    if tree is None:
        return
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves_with_keys(getattr(tree, f), f"{prefix}.{f}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_keys(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves_with_keys(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken in order from ``leaves``."""
    if like is None:
        return None
    if hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, leaves) for v in like))
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path, tree) -> None:
    """Save a tree of tensors to an .npz (leaf paths as keys)."""
    arrays = {key: _to_numpy(leaf) for key, leaf in _leaves_with_keys(tree)}
    np.savez_compressed(_npz_path(path), **arrays)


def load_pytree(path, like):
    """Load an .npz saved by :func:`save_pytree` into the structure of ``like``.

    ``like`` provides the structure (e.g. a freshly initialized EngineState).
    Each loaded leaf takes the dtype and device of ``like``'s leaf, so a
    float64 leaf saved from host numpy comes back in ``like``'s float32 (the
    JAX package gives the same with x64 off, and keeps float64 with it on;
    here ``like``'s dtype decides). The engine state is float32 throughout,
    so round trips are exact.
    """
    with np.load(_npz_path(path)) as data:
        new_leaves = []
        for key, leaf in _leaves_with_keys(like):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            saved = data[key]
            shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)
            if np.shape(saved) != shape:
                raise ValueError(
                    f"checkpoint leaf {key!r} shape {saved.shape} != expected {shape}"
                )
            if isinstance(leaf, torch.Tensor):
                new_leaves.append(torch.as_tensor(saved, dtype=leaf.dtype, device=leaf.device))
            else:
                new_leaves.append(torch.as_tensor(saved))
    return _rebuild(like, iter(new_leaves))
