"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The same numpy inputs go through the JAX package and the port; states and
constants cross with ``convex_mpc_tpu_torch.utils.interop.from_numpy``.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from convex_mpc_tpu_torch.utils import interop

# six xdist workers share the machine: keep each one's intra-op pool small
torch.set_num_threads(2)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def to_port(tree):
    """A JAX NamedTuple -> the port's NamedTuple of the same name on the CPU."""
    return interop.from_numpy(to_np(tree), "cpu")


def t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def assert_close_scaled(actual, desired, rel, name="", per_channel=False, floor=1e-6):
    """|actual - desired| <= rel * scale, scale = max|desired| over the whole
    array, or per trailing-axis channel (max over batch/time axes only)."""
    a = np.asarray(actual, np.float64)
    d = np.asarray(desired, np.float64)
    assert a.shape == d.shape, (name, a.shape, d.shape)
    if per_channel and d.ndim > 1:
        scale = np.abs(d).reshape(-1, d.shape[-1]).max(axis=0) + floor
    else:
        scale = np.abs(d).max() + floor
    err = np.abs(a - d)
    bad = err > rel * scale
    assert not bad.any(), (
        f"{name}: max err {err.max():.3e}, rel bar {rel} x scale, "
        f"{int(bad.sum())} of {bad.size} entries out"
    )


def assert_tree_close(jax_tree, port_tree, rel, per_channel=False, floor=1e-6):
    """Leafwise :func:`assert_close_scaled` over two NamedTuples of one layout."""
    for f in port_tree._fields:
        a = getattr(port_tree, f)
        d = getattr(jax_tree, f)
        if a is None:
            assert d is None, f
            continue
        if hasattr(a, "_fields"):
            assert_tree_close(d, a, rel, per_channel, floor)
            continue
        assert_close_scaled(a.numpy(), np.asarray(d), rel, name=f,
                            per_channel=per_channel, floor=floor)
