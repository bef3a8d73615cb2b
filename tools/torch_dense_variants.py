"""Variants of kernel 4's source, timed beside it in one process on one card.

    python3 tools/torch_dense_variants.py [--variants ring c16 nocopy nopass nofence clock]
                                          [--batch 512] [--check-iters 10]

Each variant is ``convex_mpc_tpu_torch/csrc/admm_dense.cu`` with text
substitutions (``VARIANTS``), built with ``nvcc`` and the package's flags
into ``build/dense_variants/<name>/`` and called through its C entry point
on the same tensors, at the shapes whose A streams through the ring
(``chip_smoke.dense_problem_at``: condensed horizon 32, full form horizons 24
and 32, B = ``--batch``). Per shape and variant one JSON line: the launch
its ``admm_dense_shape`` reports, for variants that compute the kernel's
function the entries outside its form's bar after ``--check-iters``
iterations (``chip_smoke.outside_2e4`` for the condensed form, else
``chip_smoke.dense_f64_errors``' verdict) and the scenarios they fall in,
and CUDA-event ms at 25 and 10 iterations. The variants:

- ``ring``: the source as it is;
- ``c16``: clusters of 16 at every ring shape (the 8-CTA ring entries gone);
- ``nocopy``: no TMA copies and no waits for them (results wrong: the
  time of the rest);
- ``nopass``: no ring pass at all (results wrong: the exchange's time);
- ``nofence``: without the two ``fence.proxy.async`` of the ring, whose
  absence let TMA writes overtake queued shared-memory loads at two CTAs
  an SM;
- ``clock``: clock64() stamps in the launch's first CTA; its line adds the
  mean cycles between stamps of a 25-iteration launch (``clock_segments``).

Needs the card (raises ``SystemExit`` without one). Times compare only
within one call.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from convex_mpc_tpu_torch.mpc import kernels as K  # noqa: E402
from convex_mpc_tpu_torch.utils import cuda_build  # noqa: E402

OUT = ROOT / "build" / "dense_variants"
SHAPES = (("condensed", 32), ("full form", 24), ("full form", 32))

_FETCH_FIRST = "    if (kRingA && iters > 0)\n      for (int r = 0; r < kWarps && r < ma; ++r) fetch(r);\n"
_FETCH_PASS = "      for (int r = 0; r < kWarps && r < ma; ++r) fetch(r);\n    }"
_FETCH_NEXT = "      if (lane == 0 && r + kWarps < ma) fetch(r + kWarps);\n"
_WAIT = "      bar_wait(slot_bar, taken++ & 1);\n"
VARIANTS = {
    "ring": [],
    "c16": [("                            {kRing, 8, 384, admm_dense_kernel<kRing, 8, 3>},\n", ""),
            ("                            {kRing, 8, 768, admm_dense_kernel<kRing, 8, 6>},\n", "")],
    "nocopy": [(_FETCH_FIRST, ""), (_WAIT, ""), (_FETCH_NEXT, ""), (_FETCH_PASS, "    }")],
    "nopass": [(_FETCH_FIRST, ""), (_FETCH_NEXT, ""), (_FETCH_PASS, "    }"),
               ("    for (int r = warp; r < ma; r += kWarps) {\n" + _WAIT,
                "    for (int r = warp; r < ma && iters < 0; r += kWarps) {\n")],
    "nofence": [("      fence_async_shared();\n      __syncwarp();", "      __syncwarp();"),
                ("    if (kRingA) fence_async_shared();  // the slots are read, as in the pass\n",
                 "")],
}
# ``clock``: the source with clock64() stamps by thread 0 of the launch's
# first CTA (cluster 0, rank 0): 0 after the setup, 1 when warp 0 is done
# with its rows of a pass, 2 at the pass's end, 3, 4, 5 after the waits of
# steps 2, 3 and 4
_STAMP = ("  auto stamp = [&](int code) {\n"
          "    if (blockIdx.x == 0 && tid == 0 && nstamp < 128) {\n"
          "      g_clk[2 * nstamp] = code;\n      g_clk[2 * nstamp + 1] = clock64();\n"
          "      ++nstamp;\n    }\n  };\n")
VARIANTS["clock"] = [
    ("namespace {\n\nconstexpr int kThreads", "namespace {\n\n__device__ long long g_clk[256];\n\nconstexpr int kThreads"),
    ("  cluster.sync();\n\n", "  cluster.sync();\n  int nstamp = 0;\n" + _STAMP + "  stamp(0);\n\n"),
    ("    if (partial) {\n#pragma unroll\n      for (int i = 0; i < kV; ++i) {\n        const int c4 = lane + 32 * i;\n        if (c4 < nc4) reinterpret_cast",
     "    stamp(1);\n    if (partial) {\n#pragma unroll\n      for (int i = 0; i < kV; ++i) {\n        const int c4 = lane + 32 * i;\n        if (c4 < nc4) reinterpret_cast"),
    ("    __syncthreads();\n  };\n\n  if constexpr (kRingA)", "    __syncthreads();\n    stamp(2);\n  };\n\n  if constexpr (kRingA)"),
    ("    wait(buf, it);\n", "    wait(buf, it);\n    stamp(3);\n"),
    ("    wait(4 + buf, it);\n", "    wait(4 + buf, it);\n    stamp(4);\n"),
    ("    wait(2 + buf, it);\n", "    wait(2 + buf, it);\n    stamp(5);\n"),
    ("extern \"C\" int admm_dense_shape(", "extern \"C\" int admm_dense_clock(long long* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));\n}\n\nextern \"C\" int admm_dense_shape("),
]
EXACT = ("ring", "c16", "nofence", "clock")  # the variants that compute the kernel's function


def clock_segments(lib, iters: int = 25) -> dict:
    """Mean cycles from each stamp to the next, by (code, next code), over the
    launch just made (``clock``)."""
    buf = (ctypes.c_longlong * 256)()
    cuda_build.check(lib.admm_dense_clock(buf), "admm_dense_clock")
    stamps = [(buf[2 * i], buf[2 * i + 1]) for i in range(128) if buf[2 * i + 1]]
    seg: dict = {}
    for (c0, t0), (c1, t1) in zip(stamps, stamps[1:]):
        seg.setdefault(f"{c0}->{c1}", []).append(t1 - t0)
    return {k: [len(v), sum(v) / len(v)] for k, v in seg.items()}


def build(names) -> dict:
    """Each variant's entry points (launcher, shape query, library), built in
    parallel (``cuda_build.build_variants``)."""
    sources = {n: cuda_build.variant_source("admm_dense", VARIANTS[n]) for n in names}
    libs = {}
    for name, lib in cuda_build.build_variants("admm_dense", sources, OUT).items():
        run = lib.admm_dense_f32
        run.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3 + [
            ctypes.c_void_p]
        run.restype = ctypes.c_int
        shape = lib.admm_dense_shape
        shape.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 4
        shape.restype = ctypes.c_int
        libs[name] = (run, shape, lib)
    return libs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="+", choices=list(VARIANTS), default=list(VARIANTS))
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--check-iters", type=int, default=10)
    a = ap.parse_args(argv)
    dev = chip_smoke.tool_device("torch_dense_variants", cpu=False)
    libs = build(a.variants)
    alpha = 1.6
    for form, horizon in SHAPES:
        args = chip_smoke.dense_problem_at(form, horizon, a.batch, dev)
        B, m, n = args[0].shape
        outs = [torch.empty_like(t) for t in args[6:9]]
        ptrs = [t.data_ptr() for t in args + outs]
        stream = torch.cuda.current_stream().cuda_stream
        ref = K.admm_iterations_plain(*args, iters=a.check_iters)
        for name, (run, shape, lib) in libs.items():
            vals = [ctypes.c_int(0) for _ in range(4)]
            cuda_build.check(shape(m, n, *(ctypes.byref(v) for v in vals)), name)

            def launch(iters):
                cuda_build.check(run(*ptrs, B, m, n, iters, 1e-6, alpha, 1.0 - alpha, stream),
                                 name)

            rec = {"variant": name, "form": form, "A": [m, n], "B": B,
                   "launch": [v.value for v in vals]}
            if name in EXACT:
                launch(a.check_iters)
                torch.cuda.synchronize()
                if form == "condensed":
                    rec["outside"] = chip_smoke.outside_2e4(outs, ref)
                    bad = ~torch.isclose(outs[1], ref[1], rtol=2e-4, atol=2e-4)
                else:
                    rec["within_bar"] = chip_smoke.dense_f64_errors(
                        outs, ref, args, a.check_iters)["within_bar"]
                    bad = ~torch.isfinite(outs[1])
                rec["scenarios_off"] = int(bad.any(1).sum())
            for iters in (25, 10):
                rec[f"ms{iters}"] = chip_smoke.cuda_ms(lambda: launch(iters), reps=6)
            if name == "clock":
                launch(25)
                torch.cuda.synchronize()
                rec["cycles"] = clock_segments(lib)
            print(json.dumps(rec), flush=True)
        del args, outs, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
