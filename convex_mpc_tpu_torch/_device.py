"""Device selection and the f32 precision pins of the port.

Every contraction of the control stack runs in full f32: TF32 would keep
about three decimal digits, which exceeds the 2% force-parity budget and
corrupts foot positions by ~0.5 mm (the same reason the JAX package pins
``Precision.HIGHEST`` in its ``ops/linalg.py``). The pins are set once,
when the package is imported.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

F32 = torch.float32


def default_device(device=None) -> torch.device:
    """The device the port computes on: CUDA unless the caller names another.

    ``None`` means ``cuda`` and raises when no CUDA device exists — no entry
    point falls back to the CPU on its own. Tests pass ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "convex_mpc_tpu_torch computes on CUDA and no CUDA device is "
                "available; pass device='cpu' to run the plain CPU path"
            )
        return torch.device("cuda")
    return torch.device(device)


_CONSTS: dict = {}


def const(key, device, make) -> torch.Tensor:
    """A small constant table built once per (key, device) by ``make(device)``.

    Building it on every call would copy host memory to the card each time,
    and a copy from pageable host memory waits for the device's queue to
    drain — one such copy inside the 1 kHz tick stalls the host every tick.
    """
    k = (key, torch.device(device))
    t = _CONSTS.get(k)
    if t is None:
        t = _CONSTS[k] = make(device)
    return t


def as_f32(x, device) -> torch.Tensor:
    """Float input (numpy float64, Python scalar, tensor) -> f32 tensor on
    ``device``, as JAX casts float64 inputs with x64 disabled."""
    return torch.as_tensor(x, dtype=F32, device=device)
