"""Variants of kernel 2's source, timed beside it in one process on one card.

    python3 tools/torch_structured_variants.py [--variants shipped clock nozero+clock ...]
                                               [--nb 96 128] [--batch 512 1280]
                                               [--iters 25] [--root DIR]

Each variant is ``csrc/admm_structured.cu`` of the checkout at DIR (default:
this one) with text substitutions (``VARIANTS``; several joined by ``+``
apply in turn), built with ``nvcc`` and the package's flags into
``build/structured_variants/<tag>/<name>/`` (``cuda_build.build_variants``)
and called through its C entry point on the same tensors:
``chip_smoke.structured_problem(B, nb, 11)``.
Per (nb, B, variant) one JSON line: the launch its ``admm_structured_shape``
reports (CTAs a cluster, clusters resident, slots; a source whose entry
point reports no slots reads 1), whether its x, z and y are bit for bit the
plain version's, and CUDA-event ms. A variant is timed only once it is
bitwise. The variants:

- ``shipped``: the source as it is;
- ``clock``: clock64() stamps by thread 0 of the launch's first CTA (rank 0
  of the first cluster, slot 0), summed in registers: cycles of the start
  and of the loads (``clock_segments``) and, per iteration, of the rhs
  wait, the fold, the barrier on xt, the update, the send of the next rhs
  and the two divisions y / rho (``SEGMENTS``);
- ``nozero``: the division y / rho without its zero-dividend guard.

``shipped`` and ``clock`` also apply to an older checkout (``--root``).
Needs the card (raises ``SystemExit`` without one). Times compare only
within one call.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from convex_mpc_tpu_torch.mpc import kernels as K  # noqa: E402
from convex_mpc_tpu_torch.utils import cuda_build  # noqa: E402

OUT = ROOT / "build" / "structured_variants"

SEGMENTS = ("rhs wait", "fold", "xt barrier", "update", "send", "divisions")
# segment sums are kept in registers and stored once at the end: a global
# read-modify-write at each stamp would stall the next segment on its load
_PRELUDE = (
    "  const bool clk_on = blockIdx.x == 0 && threadIdx.x == 0;\n"
    "  long long clk_sum[7] = {0, 0, 0, 0, 0, 0, 0}, clk_n = 0;\n"
    "  auto stamp = [&](int k) {\n    if (clk_on) g_clk[k] = clock64();\n  };\n"
    "  auto part = [&](int k, long long& tc) {\n"
    "    const long long now = clock64();\n"
    "    clk_sum[k] += now - tc;\n    tc = now;\n  };\n"
    "  stamp(0);\n")
# (regular expression, replacement): each must match exactly once, in this
# source and in one without slots. g_clk[0, 1, 3]: the start, after the
# cluster barrier, the end; g_clk[4 + k]: cycles of segment k summed over
# the iterations (k = 6: from the top of the loop to its first iteration);
# g_clk[11]: the iterations
_CLOCK = [(re.compile(pat), new) for pat, new in [
    (r"(// VPL: lanes of the KKT fold / 32;)", r"__device__ long long g_clk[12];\n\n\1"),
    (r"(  float\* sM = smem)", _PRELUDE + r"\1"),
    (r"(\n  cluster\.sync\(\);\n)", r"\1  stamp(1);\n"),
    (r"(  const int hi = \(lane >> 4\) & 1, b3 = \(lane >> 3\) & 1;\n)",
     r"\1  long long tc = clock64();\n"),
    (r"(\n( +)const int buf = it & 1;\n)",
     r"\1\2if (it > 0) part(5, tc); else part(6, tc);\n\2++clk_n;\n"),
    (r"\n( +)(// xt = Minv rhs for this CTA's rows)", r"\n\1part(0, tc);\n\1\2"),
    (r"\n( +)(\S[^\n]*;  // this CTA's xt complete\n)", r"\n\1part(1, tc);\n\1\2\1part(2, tc);\n"),
    (r"\n( +)(if \(it \+ 1 < iters\) \{\n +send_rhs\(\(it \+ 1\) & 1\);\n)",
     r"\n\1part(3, tc);\n\1\2\1  part(4, tc);\n"),
    (r"(  // Every rhs sent to this CTA was waited for above)",
     r"  stamp(3);\n  if (clk_on) {\n    for (int k = 0; k < 7; ++k) g_clk[4 + k] = clk_sum[k];\n"
     r"    g_clk[11] = clk_n;\n  }\n\1"),
    (r'(extern "C" int admm_structured_shape\()',
     'extern "C" int admm_structured_clock(long long* out) {\n'
     '  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));\n}\n\n\\1'),
]]
VARIANTS = {
    "shipped": [],
    "clock": _CLOCK,
    "nozero": [("const bool z = y == 0.0f && rho > 0.0f;", "const bool z = false;")],
}


def build(names, csrc: Path, tag: str) -> dict:
    """Each variant's library (``cuda_build.build_variants``), its launcher
    and shape query typed."""
    sources = {n: cuda_build.variant_source(
        "admm_structured", [sub for part in n.split("+") for sub in VARIANTS[part]], csrc)
        for n in names}
    print(json.dumps({"root": tag}))
    libs = cuda_build.build_variants("admm_structured", sources, OUT / tag, csrc)
    for lib in libs.values():
        lib.admm_structured_f32.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 3
                                            + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        lib.admm_structured_f32.restype = ctypes.c_int
        # a source with no slots takes two pointers; the third is then left at 1
        lib.admm_structured_shape.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
        lib.admm_structured_shape.restype = ctypes.c_int
    return libs


def clock_segments(lib) -> dict:
    """Cycles of the first CTA's thread 0 in the launch just made (``clock``):
    up to the cluster barrier (``start``, the rows of Minv loaded), from
    there to the first iteration (``load``), and each segment
    (``SEGMENTS``) a mean iteration, with their sum (``iteration``)."""
    buf = (ctypes.c_longlong * 12)()
    cuda_build.check(lib.admm_structured_clock(buf), "admm_structured_clock")
    n = max(buf[11], 1)
    out = {"start": buf[1] - buf[0], "load": buf[10], "iterations": buf[11]}
    out.update({name: buf[4 + k] / n for k, name in enumerate(SEGMENTS)})
    out["iteration"] = sum(buf[4:10]) / n
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    help=f"each one of {sorted(VARIANTS)} or several joined by '+'")
    ap.add_argument("--nb", type=int, nargs="+", default=[96, 128])
    ap.add_argument("--batch", type=int, nargs="+", default=[512, 1280])
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--root", type=Path, default=ROOT)
    a = ap.parse_args(argv)
    unknown = {p for v in a.variants for p in v.split("+")} - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    dev = chip_smoke.tool_device("torch_structured_variants", cpu=False)
    print(json.dumps({"clocks": subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()}))
    tag = "here" if a.root.resolve() == ROOT else a.root.resolve().name
    libs = build(a.variants, a.root / "convex_mpc_tpu_torch" / "csrc", tag)
    stream = torch.cuda.current_stream().cuda_stream
    sigma, alpha = 1e-6, 1.6
    for nb in a.nb:
        for B in a.batch:
            args = [t.contiguous() for t in chip_smoke.structured_problem(B, nb, 11, dev)]
            ref = K.admm_iterations_structured_plain(*args, iters=a.iters)
            for name, lib in libs.items():
                shape = [ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(1)]
                cuda_build.check(lib.admm_structured_shape(nb, *map(ctypes.byref, shape)), name)
                out = [torch.empty_like(t) for t in args[-3:]]

                def run():
                    cuda_build.check(lib.admm_structured_f32(
                        *[t.data_ptr() for t in args + out], B, nb, a.iters, sigma, alpha,
                        1.0 - alpha, stream), f"{name} (nb={nb}, B={B})")

                run()
                torch.cuda.synchronize()
                bitwise = all(torch.equal(o, r) for o, r in zip(out, ref))
                rec = {"root": tag, "variant": name, "nb": nb, "B": B, "iters": a.iters,
                       "launch": [v.value for v in shape], "bitwise": bitwise,
                       "max_abs_err": max((o - r).abs().max().item() for o, r in zip(out, ref))}
                if bitwise:
                    rec["ms"] = chip_smoke.cuda_ms(run)
                    if "clock" in name.split("+"):
                        run()
                        torch.cuda.synchronize()
                        rec["cycles"] = clock_segments(lib)
                print(json.dumps(rec), flush=True)
                del out
            del args, ref
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
