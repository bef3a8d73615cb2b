"""ctypes bindings for the native C++ float64 QP oracle (``native/qp_solver.cpp``).

The port's copy of ``convex_mpc_tpu/utils/native_oracle.py``: the same
``solve_qp_native``, built from the same source, which stays outside both
packages as the independent oracle. The library is compiled with ``g++`` at
first use into ``build/native/`` at the root of the checkout (listed in
``.gitignore``) under a name that carries the hash of the source and the
flags; the compiler writes a temporary file that is then renamed into place,
so processes that build at the same moment never write the same file, and
an edited source is rebuilt. A missing or failing ``g++`` raises with the
compiler's output. Used by the parity tools and tests; never by the compute
path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SRC = _ROOT / "native" / "qp_solver.cpp"
BUILD_DIR = _ROOT / "build" / "native"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libqp_solver-{h}.so"


def compiler_version() -> str:
    """The first line of ``g++ --version``; raises when there is no ``g++``."""
    out = subprocess.run(["g++", "--version"], capture_output=True, text=True, check=True)
    return out.stdout.splitlines()[0]


def build() -> Path:
    """Compile the oracle unless its library is already built; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}-{threading.get_ident()}.so")
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(SRC)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError(f"the native oracle needs g++: {exc}") from exc
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SRC.name} ({' '.join(cmd)}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            d = ctypes.POINTER(ctypes.c_double)
            lib.qp_solve_f64.argtypes = [
                ctypes.c_int, ctypes.c_int, d, d, d, d, d,
                ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, d, d, d,
            ]
            lib.qp_solve_f64.restype = ctypes.c_int
            _lib = lib
    return _lib


def solve_qp_native(
    P: np.ndarray,
    q: np.ndarray,
    A: np.ndarray,
    l: np.ndarray,
    u: np.ndarray,
    max_iter: int = 20000,
    rho: float = 0.1,
    eq_scale: float = 1e3,
    sigma: float = 1e-6,
    alpha: float = 1.6,
):
    """Solve min 1/2 x'Px + q'x s.t. l <= Ax <= u in f64.

    Returns (x, y, info) with info = dict(kkt, iters, polished).
    """
    lib = _load()
    n = int(q.shape[0])
    m = int(l.shape[0])
    P = np.ascontiguousarray(P, np.float64)
    if P.ndim == 1:
        P = np.ascontiguousarray(np.diag(P))
    q = np.ascontiguousarray(q, np.float64)
    A = np.ascontiguousarray(A, np.float64)
    l = np.ascontiguousarray(l, np.float64)
    u = np.ascontiguousarray(u, np.float64)
    x = np.zeros(n)
    y = np.zeros(m)
    info = np.zeros(3)

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    rc = lib.qp_solve_f64(
        n, m, ptr(P), ptr(q), ptr(A), ptr(l), ptr(u),
        int(max_iter), float(rho), float(eq_scale), float(sigma), float(alpha),
        ptr(x), ptr(y), ptr(info),
    )
    if rc != 0:
        raise RuntimeError(f"native qp_solve_f64 failed with code {rc}")
    return x, y, dict(kkt=float(info[0]), iters=int(info[1]), polished=bool(info[2]))


def solve_captured(d: dict):
    """Oracle solve of one condensed-trot QP (``tests/qp_oracle.assemble_qp``'s
    dict) as the parity tools run it: 8,000 iterations, again with 60,000
    when the KKT residual stays above 1e-6. Returns (x, info)."""
    x64, _, info = solve_qp_native(d["P"], d["q"], d["A"], d["l"], d["u"], max_iter=8000)
    if info["kkt"] > 1e-6:  # a rare hard instance: more iterations
        x64, _, info = solve_qp_native(d["P"], d["q"], d["A"], d["l"], d["u"], max_iter=60000)
    return x64, info


def solve_all(qps: list) -> list:
    """:func:`solve_captured` of every QP dict, in a pool of ``spawn``-ed
    worker processes, one a core (a process that holds a CUDA context must
    not fork; the solves are independent, take seconds each, up to ~7x more
    when one needs the 60,000-iteration retry, and the caller waits for
    them). Returns
    the list of (x, info) in order. The library is built here first, so the
    workers only load it."""
    import multiprocessing as mp

    build()
    if not qps:
        return []
    workers = max(1, min(os.cpu_count() or 1, len(qps)))
    with mp.get_context("spawn").Pool(workers) as pool:
        return pool.map(solve_captured, qps, chunksize=1)
