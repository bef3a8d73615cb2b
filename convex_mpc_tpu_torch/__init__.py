"""convex_mpc_tpu_torch — the PyTorch/CUDA port of convex_mpc_tpu.

The production MPC cycle (``sim.engine.mpc_cycle_batch``) in PyTorch, with
hand-written CUDA kernels for Hopper in place of the JAX package's Pallas
kernels on that path:

- ``ops.chol_kernel.spd_inverse``            — batched SPD inverse
  (``csrc/spd_inverse.cu``);
- ``mpc.kernels.admm_iterations_structured`` — the structured ADMM chunk
  (``csrc/admm_structured.cu``).

Functions take tensors with an explicit leading batch axis where the JAX
package is written per scenario and ``vmap``-ed. The state NamedTuples keep
the JAX package's fields and layouts. Entry points compute on CUDA unless
the caller passes ``device="cpu"``; on CPU tensors each kernel wrapper runs
its plain PyTorch version.
"""

from convex_mpc_tpu_torch import _device  # noqa: F401  (sets the f32 pins)
from convex_mpc_tpu_torch._device import default_device  # noqa: F401

__version__ = "0.1.0"
