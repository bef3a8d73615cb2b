"""Build and load the port's CUDA kernels (nvcc + ctypes, no PyTorch headers).

Each ``csrc/<name>.cu`` exposes a plain C launcher. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``) under a name that carries the hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source is rebuilt, and loaded with ``ctypes``. Nothing here runs at import
time: the CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# per-kernel extra flags: the structured ADMM chunk pins its arithmetic order,
# so no multiply-add contraction anywhere in that file. No file takes
# --use_fast_math: division and sqrtf stay IEEE.
KERNEL_FLAGS = {
    "spd_inverse": [],
    "admm_structured": ["-fmad=false"],
    "tick_window": [],
    "admm_dense": [],
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def _target(name: str) -> tuple[Path, list[str]]:
    src = CSRC / f"{name}.cu"
    flags = ARCH + BASE_FLAGS + KERNEL_FLAGS[name]
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so", flags


def _start_build(name: str):
    out, flags = _target(name)
    if out.exists() and out.with_suffix(".log").exists():  # built, with its compiler output
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> str:
    if job is None:  # built before: its compiler output is kept beside it
        return _target(name)[0].with_suffix(".log").read_text()
    proc, tmp, out = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, str]:
    """Compile every kernel in parallel (one nvcc each); returns the compiler
    output of each (``-Xptxas -v``: registers, stack frame, spills)."""
    jobs = {n: _start_build(n) for n in KERNEL_FLAGS}
    return {n: _finish_build(n, j) for n, j in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish_build(name, _start_build(name))
            lib = ctypes.CDLL(str(_target(name)[0]))
            _libs[name] = lib
        return lib


def require_cuda(what: str, *tensors, ints=()) -> None:
    """Raise unless every operand is a contiguous tensor on a CUDA device:
    f32 for ``tensors``, int32 for ``ints`` (the masks a kernel takes)."""
    for x, dtype in [(x, torch.float32) for x in tensors] + [(x, torch.int32) for x in ints]:
        if x.device.type != "cuda":
            raise ValueError(f"{what}: the kernel takes CUDA tensors, got one on {x.device}")
        if x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{what}: the kernel takes contiguous {dtype} tensors, got "
                             f"{x.dtype}{'' if x.is_contiguous() else ' (not contiguous)'}")


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
