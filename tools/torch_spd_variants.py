"""Variants of kernel 1's source, timed beside it in one process on one card.

    python3 tools/torch_spd_variants.py [--variants shipped all_cluster t256 noshadow
                                         dsmem3 clock noshadow_clock]
                                        [--n 192 288 384] [--batch 512]

Each variant is ``convex_mpc_tpu_torch/csrc/spd_inverse.cu`` with text
substitutions (``VARIANTS``), built with ``nvcc`` and the package's flags
into ``build/spd_variants/<name>/`` and called through its C entry point on
the same tensors: ``chip_smoke.spd_batch(B, n, 7)`` with one matrix made
non-SPD at its first pivot and one at its last panel (``chip_smoke.
spd_nonspd``). Per n and variant one JSON line: the launch its
``spd_inverse_shape`` reports (shared bytes a CTA, scratch floats, resident,
CTAs a matrix), whether it meets ``chip_smoke.check_spd_random``'s bars
against the plain version (within 5e-5 x max|plain|, |A out - I| < 1e-4,
the two non-SPD matrices all NaN, the others finite), and CUDA-event ms. A
variant is timed only once it meets the bars. The variants:

- ``shipped``: the source as it is;
- ``all_cluster``: every n whose cluster shape fits runs the cluster
  instance (n = 192 and 288 too, which the source keeps in one CTA);
- ``t256``: the cluster instance with 256 threads a CTA instead of 512;
- ``noshadow``: phase 1 updates the later panels from panel q - 1 after the
  panel product, with those from panel q, instead of while warp 0 inverts
  the diagonal block;
- ``dsmem3``: phase 3 reads the peer's rows in place through distributed
  shared memory instead of copying each of its panels into a slot first;
- ``clock``, ``noshadow_clock``: clock64() stamps in the first cluster (its
  line adds each rank's cycles per segment, ``SEGMENTS``, and phase 1's by
  part, ``PHASE1``, at the n that run the cluster instance).

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
from convex_mpc_tpu_torch.ops import chol_kernel as TCK  # noqa: E402
from convex_mpc_tpu_torch.utils import cuda_build  # noqa: E402

OUT = ROOT / "build" / "spd_variants"

_COPY = ("    for (int e = 4 * tid; e < len; e += 4 * NT) st4(stage + e, "
         "ld4(theirs.S + first + e));\n")
# ``clock``: clock64() stamps by thread 0 of the launch's first cluster (rank
# 0 in g_clk[0..7], rank 1 in g_clk[8..15]): 0 at the start, 1 after the
# load's cluster barrier, 2 at phase 1's end, 3 after the barrier on the
# `bad` flag, 4 at phase 2's end, 5 after the barrier before phase 3, 6 after
# the local tiles of phase 3, 7 after the tiles with the peer's panels; and
# phase 1's cycles summed by part (g_clk[16 + 4 rank + k]): k = 0 the wait
# for the peer's panel, 1 up to the block barrier after the diagonal block's
# inversion, 2 the panel product, 3 the later panels from this CTA's panel
_STAMP = ("  auto stamp = [&](int code) {\n"
          "    if (blockIdx.x < 2 && tid == 0) g_clk[8 * blockIdx.x + code] = clock64();\n"
          "  };\n"
          "  auto part = [&](int k, long long& tc) {\n"
          "    const long long now = clock64();\n"
          "    if (blockIdx.x < 2 && tid == 0) g_clk[16 + 4 * blockIdx.x + k] += now - tc;\n"
          "    tc = now;\n  };\n"
          "  if (blockIdx.x < 2 && tid == 0)\n"
          "    for (int k = 0; k < 4; ++k) g_clk[16 + 4 * blockIdx.x + k] = 0;\n"
          "  stamp(0);\n")
_CLOCK = [
    ("constexpr int kThreads = 256;",
     "__device__ long long g_clk[24];\n\nconstexpr int kThreads = 256;"),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n" + _STAMP),
    ("  cluster.sync();  // both halves loaded, both CTAs' barriers exist\n",
     "  cluster.sync();  // both halves loaded, both CTAs' barriers exist\n  stamp(1);\n"),
    ("    Staged prev{stage, c0 - NB, n};  // panel q - 1, pushed by the peer\n",
     "    Staged prev{stage, c0 - NB, n};  // panel q - 1, pushed by the peer\n"
     "    long long tc = clock64();\n"),
    ("      receive(s, 64u * (n - c0));\n",
     "      receive(s, 64u * (n - c0));\n      part(0, tc);\n"),
    ("    __syncthreads();\n    // the panel product,", "    __syncthreads();\n    part(1, tc);\n"
     "    // the panel product,"),
    ("    if (ntp > 0) ++sent;\n    __syncthreads();\n",
     "    if (ntp > 0) ++sent;\n    __syncthreads();\n    part(2, tc);\n"),
    ("    later(mine, c0, tid, NT);  // the later panels from panel q\n    __syncthreads();\n",
     "    later(mine, c0, tid, NT);  // the later panels from panel q\n    __syncthreads();\n"
     "    part(3, tc);\n"),
    ("  // both CTAs learn whether", "  stamp(2);\n  // both CTAs learn whether"),
    ("  // the peer's diagonal blocks W, which",
     "  stamp(3);\n  // the peer's diagonal blocks W, which"),
    ("  cluster.sync();  // the peer's V is complete\n",
     "  stamp(4);\n  cluster.sync();  // the peer's V is complete\n  stamp(5);\n"),
    ("  // the tiles (row group here", "  stamp(6);\n  // the tiles (row group here"),
    ("  cluster.sync();  // the peer has copied what it reads of this CTA\n",
     "  stamp(7);\n  cluster.sync();  // the peer has copied what it reads of this CTA\n"),
    ("extern \"C\" int spd_inverse_shape(",
     "extern \"C\" int spd_inverse_clock(long long* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));\n}\n\n"
     "extern \"C\" int spd_inverse_shape("),
]
SEGMENTS = ("load", "phase 1", "bad barrier", "phase 2", "barrier", "phase 3 local",
            "phase 3 peer panels")
PHASE1 = ("wait", "update and inversion", "panel product", "later panels")
_T256 = [("constexpr int kClusterThreads = 512;", "constexpr int kClusterThreads = 256;")]
_NOSHADOW = [("        later(prev, c0 - NB, tid - 32, NT - 32);\n", ""),
             ("    later(mine, c0, tid, NT);  // the later panels from panel q\n",
              "    if (q > 0) later(prev, c0 - NB, tid, NT);\n"
              "    later(mine, c0, tid, NT);  // the later panels from panel q\n")]
VARIANTS = {
    "shipped": [],
    "all_cluster": [("  if (aligned && bytes <= room) {\n", "  if (false) {\n")],
    "t256": _T256,
    "noshadow": _NOSHADOW,
    "dsmem3": [("#pragma unroll 4\n" + _COPY, ""),
               ("    const Half panel{stage, n, peer, first};\n",
                "    const Half panel = theirs;\n")],
    "clock": _CLOCK,
    "noshadow_clock": _NOSHADOW + _CLOCK,
}


def clock_segments(lib) -> dict:
    """Cycles of each segment (``SEGMENTS``) of the first cluster's matrix,
    per rank, from the launch just made (``clock`` variants)."""
    buf = (ctypes.c_longlong * 24)()
    cuda_build.check(lib.spd_inverse_clock(buf), "spd_inverse_clock")
    return {f"rank {r}": {**{name: buf[8 * r + i + 1] - buf[8 * r + i]
                             for i, name in enumerate(SEGMENTS)},
                          **{f"phase 1: {name}": buf[16 + 4 * r + k]
                             for k, name in enumerate(PHASE1)}} for r in (0, 1)}


def build(names) -> dict:
    """Each variant's library, built in parallel (``cuda_build.build_variants``)."""
    sources = {n: cuda_build.variant_source("spd_inverse", VARIANTS[n]) for n in names}
    libs = cuda_build.build_variants("spd_inverse", sources, OUT)
    for lib in libs.values():
        lib.spd_inverse_f32.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                                        + [ctypes.c_void_p])
        lib.spd_inverse_f32.restype = ctypes.c_int
        lib.spd_inverse_shape.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                          ctypes.POINTER(ctypes.c_longlong),
                                          ctypes.POINTER(ctypes.c_int),
                                          ctypes.POINTER(ctypes.c_int)]
        lib.spd_inverse_shape.restype = ctypes.c_int
    return libs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="+", choices=list(VARIANTS), default=list(VARIANTS))
    ap.add_argument("--n", type=int, nargs="+", default=[192, 288, 384])
    ap.add_argument("--batch", type=int, default=512)
    a = ap.parse_args(argv)
    dev = chip_smoke.tool_device("torch_spd_variants", cpu=False)
    libs = build(a.variants)
    B, bad = a.batch, (5, a.batch - 3)
    stream = torch.cuda.current_stream().cuda_stream
    for n in a.n:
        A = chip_smoke.spd_batch(B, n, 7, dev)
        chip_smoke.spd_nonspd(A, *bad)
        ref = TCK.spd_inverse_plain(A)
        keep = torch.ones(B, dtype=torch.bool, device=dev)
        keep[list(bad)] = False
        eye = torch.eye(n, device=dev)
        for name, lib in libs.items():
            vals = [ctypes.c_int(0), ctypes.c_longlong(0), ctypes.c_int(0), ctypes.c_int(0)]
            cuda_build.check(lib.spd_inverse_shape(n, *map(ctypes.byref, vals)), name)
            launch = [v.value for v in vals]
            scratch = (torch.empty((B, launch[1]), device=dev) if launch[1] else None)
            out = torch.empty_like(A)

            def run():
                cuda_build.check(lib.spd_inverse_f32(
                    A.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
                    B, n, stream), f"{name} (n={n})")

            run()
            torch.cuda.synchronize()
            o, r = out[keep], ref[keep]
            err = (o - r).abs().max().item()
            resid = (A[keep] @ o - eye).abs().max().item()
            ok = bool(err <= 5e-5 * r.abs().max().item() and resid < 1e-4
                      and torch.isnan(out[~keep]).all() and torch.isfinite(o).all())
            rec = {"variant": name, "n": n, "B": B, "launch": launch, "max_abs_err": err,
                   "resid": resid, "within_bars": ok}
            if ok:
                rec["ms"] = chip_smoke.cuda_ms(run)
                if "clock" in name and launch[3] == 2:
                    run()
                    torch.cuda.synchronize()
                    rec["cycles"] = clock_segments(lib)
            print(json.dumps(rec), flush=True)
            del out, scratch
        del A, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
