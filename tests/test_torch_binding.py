"""The one binding of the port's kernel entry points (``utils/cuda_build.py``).

For each of the six entry points: its wrapper on CPU tensors runs the plain
version and counts no ``launches.*``, and its kernel's launch
(``cuda_build.launch``) refuses CPU tensors with a ValueError that names
CUDA, counting nothing: no silent fallback below the wrappers, which pick
the plain version by device. CPU, small shapes, no JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (  # noqa: E402
    ADAPT_SETTINGS, KERNELS, adapt_problem, adapt_rho_kwargs, adapt_rho_problem, launches,
    random_dense_problem, spd_batch, structured_problem, tick_battery)

from convex_mpc_tpu_torch.mpc import kernels as K  # noqa: E402
from convex_mpc_tpu_torch.ops import chol_kernel as TCK  # noqa: E402
from convex_mpc_tpu_torch.sim import engine as E  # noqa: E402
from convex_mpc_tpu_torch.sim import tick_fused as TTF  # noqa: E402
from convex_mpc_tpu_torch.utils import cuda_build  # noqa: E402

CPU = torch.device("cpu")
SIGMA_ALPHA = (1e-6, 1.6, -0.6)


def spd_inverse():
    A = spd_batch(2, 20, 0, CPU)
    out = TCK.spd_inverse(A)
    return TCK._KERNEL, [A, out, None], (2, 20), ()


def admm_iterations_structured():
    args = structured_problem(2, 4, 0, CPU)
    out = K.admm_iterations_structured(*args, iters=2)
    return K._STRUCTURED, [*args, *out], (2, 4, 2), SIGMA_ALPHA


def admm_iterations():
    args = random_dense_problem(2, 14, 8, 0, CPU)
    out = K.admm_iterations(*args, iters=2)
    return K._DENSE, [*args, *out], (2, 14, 8, 2), SIGMA_ALPHA


def adapt_check():
    p = adapt_problem(2, 4, 0, CPU)
    out = K.adapt_check(*p.values(), iters_done=25, eps_abs=1e-4, eps_rel=1e-4, **ADAPT_SETTINGS)
    ws = torch.zeros(8, dtype=torch.int32)
    return K._CHECK, [*p.values(), *out[:5], ws, out[5]], (2, 4, 25), (1e-4, 1e-4, 5e-4, 0.02, 2.5)


def adapt_rho():
    p = adapt_rho_problem(2, 0, CPU)
    kw = adapt_rho_kwargs("plain chunk")
    rho_new, d_count, changed, conv, conv_iter, flags = K.adapt_rho(*p.values(), **kw)
    ops = [p[k] for k in ("pr", "dr", "step", "rho", "x", "d", "converged", "pol_ok",
                          "conv_iter", "d_count")]
    ws = torch.zeros(4, dtype=torch.int32)
    return (K._RHO, [*ops, rho_new, d_count, conv_iter, conv, changed, ws, flags],
            (2, 24, 12, 1, 0, 0, 0, 3), (0.02, 50.0, 1.6, 5e-4))


def run_ticks_fused():
    args = tick_battery(2, 0, CPU)
    TTF.run_ticks_fused(*args, 2, 45.0, 1e-3, 30.0)
    carry, batch = TTF._inputs(*args[1:])
    consts = torch.zeros(220)
    logs = [torch.zeros(2, 2, 12)] * 6
    return (TTF._KERNEL, [*carry, *batch, consts, *carry, *logs], (2, 2),
            (1e-3, E._filter_alpha(30.0, 1e-3), 0.0, 0.0, 0.0, 0.0, 0.0))


CASES = {f.__name__: f for f in (spd_inverse, admm_iterations_structured, admm_iterations,
                                  adapt_check, adapt_rho, run_ticks_fused)}


@pytest.mark.parametrize("entry", list(CASES))
def test_launch_refuses_cpu_tensors(entry):
    """The CPU route counts no launch; the kernel's launch on CPU tensors
    raises, naming CUDA, and counts none either. Every entry point the
    ``launches`` lines print has its case."""
    assert set(CASES) == set(KERNELS)
    before = launches()
    kernel, tensors, ints, floats = CASES[entry]()
    assert kernel.name == entry
    assert not any(launches(before).values())
    assert (len(tensors), len(ints), len(floats)) == (kernel.pointers, kernel.ints,
                                                       kernel.floats)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_build.launch(kernel, tensors, ints, floats)
    assert not any(launches(before).values())


@pytest.mark.parametrize("nb", [4, 96, 128])
def test_structured_cpu_route_counts_no_slotted(nb):
    """The structured chunk on CPU tensors runs the plain version and counts
    no ``admm_slotted``, at sizes the card runs in one slot (nb = 4, 96) and
    at the one it runs in three (nb = 128, nz = 384)."""
    from convex_mpc_tpu_torch.utils import profiling

    before = profiling.counts().get("admm_slotted", 0)
    args = structured_problem(1, nb, 0, CPU)
    out = K.admm_iterations_structured(*args, iters=1)
    ref = K.admm_iterations_structured_plain(*args, iters=1)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert profiling.counts().get("admm_slotted", 0) == before
