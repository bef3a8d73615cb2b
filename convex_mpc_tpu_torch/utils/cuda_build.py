"""Build and load the port's CUDA kernels (nvcc + ctypes, no PyTorch headers).

Each ``csrc/<name>.cu`` exposes a plain C launcher. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``) under a name that carries the hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source is rebuilt, and loaded with ``ctypes``. Nothing here runs at import
time: the CPU tests import every module on machines without ``nvcc``.

Every kernel wrapper binds its launcher through the same three calls:
:func:`operands` checks the wrapper's inputs on either route (the plain
version for CPU tensors, the kernel for CUDA tensors), :func:`launch` calls
a :class:`Kernel`'s C launcher on the current stream, checks the error it
returns and counts the launch (``launches.<name>`` in ``utils.profiling``),
and :func:`query` asks a launcher's C side which launch it makes.

The variant tools (``tools/torch_*_variants.py``) build edited copies of a
kernel's source beside it: :func:`variant_source` edits, :func:`build_variants`
compiles and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from convex_mpc_tpu_torch.utils.profiling import count

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# per-kernel extra flags: the structured ADMM chunk and the adapt step pin
# their arithmetic order, so no multiply-add contraction anywhere in those
# files. No file takes --use_fast_math: division and sqrtf stay IEEE.
KERNEL_FLAGS = {
    "spd_inverse": [],
    "admm_structured": ["-fmad=false"],
    "admm_adapt": ["-fmad=false"],
    "tick_window": [],
    "admm_dense": [],
}

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
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


_INVALID_CONFIGURATION = 9  # cudaErrorInvalidConfiguration: no launch fits the card


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C launcher."""
    if err == _INVALID_CONFIGURATION:
        raise RuntimeError(f"{what}: no launch of the kernel fits this card (cudaError {err})")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def _fn(lib: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """``csrc/<lib>.cu``'s C function ``symbol`` returning an int, typed once."""
    fn = _fns.get((lib, symbol))
    if fn is None:
        fn = getattr(load(lib), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(lib, symbol)] = fn
    return fn


class Kernel(NamedTuple):
    """A C launcher ``symbol`` of ``csrc/<lib>.cu``: ``symbol(pointers...,
    ints..., floats..., stream)`` returning a cudaError_t, the pointers one
    array of ``void*`` where ``packed``. ``name`` is the wrapper's: it names
    the launch in errors and in its counter ``launches.<name>``."""

    name: str
    lib: str
    symbol: str
    pointers: int
    ints: int
    floats: int
    packed: bool = False


def operands(what: str, **specs) -> torch.device:
    """Check a wrapper's operands, each given as ``name=(tensor, shape)`` (f32)
    or ``name=(tensor, shape, dtype)``: ValueError unless each has its shape
    and all lie on one CPU or CUDA device, TypeError unless each has its
    dtype. Returns the device."""
    dev = None
    for name, (t, shape, *dtype) in specs.items():
        dtype = dtype[0] if dtype else torch.float32
        dev = t.device if dev is None else dev
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{what}: all operands on one device, {name} is on {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CPU or CUDA tensors, got {dev}")
    return dev


def launch(k: Kernel, tensors, ints=(), floats=(), what: str | None = None) -> None:
    """Launch ``k`` on ``tensors`` (contiguous CUDA tensors, or None for a
    null pointer), ``ints`` and ``floats`` (each rounded to f32) on the
    current stream of the tensors' device; raise, naming ``what`` (default
    ``k.name``), on a CPU tensor or on the error it returns; count the
    launch. It never falls back to the plain version: the wrappers route."""
    what = what or k.name
    live = [t for t in tensors if t is not None]
    for t in live:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: the kernel takes CUDA tensors, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: the kernel takes contiguous tensors")
    if (len(tensors), len(ints), len(floats)) != (k.pointers, k.ints, k.floats):
        raise ValueError(f"{what}: {k.symbol} takes {k[3:6]} pointers, ints and floats, got "
                         f"{(len(tensors), len(ints), len(floats))}")
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    if k.packed:
        array = (ctypes.c_void_p * len(ptrs))(*ptrs)  # alive until the call returns
        ptrs = [ctypes.cast(array, ctypes.c_void_p)]
    fn = _fn(k.lib, k.symbol, [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * k.ints
             + [ctypes.c_float] * k.floats + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(live[0].device).cuda_stream
    check(fn(*ptrs, *(int(v) for v in ints), *(float(np.float32(v)) for v in floats), stream),
          what)
    count(f"launches.{k.name}")


def query(lib: str, symbol: str, sizes, outputs) -> tuple:
    """What ``csrc/<lib>.cu``'s C function ``symbol(sizes..., outputs...)``
    reports: ``sizes`` ints in, one value of each ctypes type in ``outputs``
    out (the launch its launcher makes for those sizes on the current card)."""
    fn = _fn(lib, symbol, [ctypes.c_int] * len(sizes) + [ctypes.POINTER(t) for t in outputs])
    out = [t(0) for t in outputs]
    check(fn(*sizes, *map(ctypes.byref, out)), f"{symbol}{tuple(sizes)}")
    return tuple(v.value for v in out)


def variant_source(name: str, subs, csrc: Path = CSRC) -> str:
    """``csrc/<name>.cu`` with the substitutions ``subs`` applied in turn,
    each (old, new): a string replaced wherever it occurs, or a compiled
    regular expression replaced where it matches, which must be exactly
    once. ValueError where one finds nothing to replace (the source changed
    under it)."""
    src = (csrc / f"{name}.cu").read_text()
    for old, new in subs:
        if isinstance(old, re.Pattern):
            src, n = old.subn(new, src)
            if n != 1:
                raise ValueError(f"{name}.cu: {old.pattern!r} matches {n} times in {csrc}, not once")
        elif old in src:
            src = src.replace(old, new)
        else:
            raise ValueError(f"{name}.cu in {csrc} no longer holds {old!r}")
    return src


def build_variants(name: str, sources: dict, out: Path, csrc: Path = CSRC) -> dict:
    """Each of ``sources`` (variant -> text of ``csrc/<name>.cu``) built in
    parallel with the kernel's flags into ``out/<variant>/lib.so``, beside a
    copy of the headers of ``csrc``, and loaded; one JSON line a variant
    printed with ptxas' register, stack and spill lines. Returns variant ->
    ctypes.CDLL."""
    flags = ARCH + BASE_FLAGS + KERNEL_FLAGS[name]
    procs = {}
    for variant, src in sources.items():
        d = out / variant
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{name}.cu").write_text(src)
        for h in csrc.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        procs[variant] = subprocess.Popen(
            [_nvcc(), *flags, "-o", str(d / "lib.so"), str(d / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for variant, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {variant} of {name}.cu:\n{log}")
        lines = [l.split(":", 1)[-1].strip() for l in log.splitlines()
                 if "stack frame" in l or "registers" in l]
        print(json.dumps({"variant": variant, "ptxas": lines}), flush=True)
        libs[variant] = ctypes.CDLL(str(out / variant / "lib.so"))
    return libs
