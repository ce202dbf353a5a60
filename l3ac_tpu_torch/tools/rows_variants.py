"""The general routes' two row passes (``csrc/general_rows.cu``: the unit's
dw + norm pass, the up path's blend + norm pass) beside their measured
alternatives and ablations, and beside the former passes
(``tools/general_rows_simt.cu``), at ROADMAP C3's shapes: the dw + norm pass
at (2, 1779, 1280), d = 1; the blend + norm pass at 12 -> 200 s 2 (z (2 x
26685, 200), channels-first output) and 1280 -> 600 s 5 (z (2 x 1779, 600),
channels-last output); each in fp32 and bf16.

    python3 -m l3ac_tpu_torch.tools.rows_variants

Card only. Each variant is the kernel's source with named text
substitutions (each must apply exactly once), built with the kernel
library's nvcc flags into its own library, called on the same seeded inputs
through the two C entry points and timed by the card's time without the
host's (``tools.queued_ms``: CUDA events around calls queued behind a
sleeping kernel; a loop of these launches is host-bound), in turns (each
variant, then again in reverse order); variant 0 also by CUDA events
around a loop of launches. Variants that compute the passes are
held against their plain versions (fp32: max abs error <= 1e-4 x max(1,
max |plain|); bf16: 2^-6 x); ablations drop a part of the work, are only
timed, and say where the time goes. Prints ptxas's registers and spills of
each variant's kernels at the timed shapes and its ms per call beside the
bytes bound (each input read once, each output written once, at 3.35 TB/s).
Variant 0 is what the port runs.
"""

from __future__ import annotations

import argparse
import ctypes
from pathlib import Path

import numpy as np
import torch

from . import build_variants, describe, ptxas_usage, queued_ms, time_ms
from ..ops.kernels import _build
from ..ops.kernels import conv_unit as cu
from ..ops.kernels import up_fused as uf
from ..ops.norms import channel_norm
from ..ops.resample import interleave, upsample_phases

SOURCE = _build.CSRC_DIR / "general_rows.cu"
SIMT_SOURCE = Path(__file__).with_name("general_rows_simt.cu")
DW_SHAPE = (2, 1779, 1280)                                  # (B, T, C)
UP_SHAPES = ((2, 26685, 200, 2, "cf"), (2, 1779, 600, 5, "cl"))  # (B, T, Co, s, layout)
TOL, TOL_BF16 = 1e-4, 2.0 ** -6
ITERS = 20
PEAK_BYTES = 3.35e12

# (name, substitutions, computes the passes)
VARIANTS = (
    ("persistent blocks, a tile of R rows staged by cp.async (the next tile's in flight where "
     "the channels are one chunk), a row on a warp (dw + norm: two; tile layouts: half of "
     "one); R for 2 tiles an SM", (), True),
    ("one staging buffer (no copies in flight)",
     (("  p.bufs = 2;\n  if (groups > lanes * max_nj ||",
       "  p.bufs = 1;\n  if (true || groups > lanes * max_nj ||"),), True),
    ("dw + norm: a row on one warp of 8 (blocks of 256 threads)",
     (("kDwThreads = 512, kDwWarps = kDwThreads / 32, kDwRowsAPass = kDwWarps / 2;",
       "kDwThreads = 256, kDwWarps = kDwThreads / 32, kDwRowsAPass = kDwWarps;"),
      ("  const int rs = warp >> 1, h = warp & 1;", "  const int rs = warp, h = 0;"),
      ("return (lane + 32 * (2 * (i / V) + h)) * V + i % V;", "return (lane + 32 * (i / V)) * V + i % V;"),
      ("n_h += max(0, min(32 * V, cn - 32 * (2 * j + h) * V));",
       "n_h += max(0, min(32 * V, cn - 32 * j * V));"),
      ("plan_rows(p, B, T, C, V, 64, kMaxNJ,", "plan_rows(p, B, T, C, V, 32, kMaxNJ,")), True),
    ("dw + norm bf16: the taps in channel order (a lane's 32 bytes: two-way bank conflicts)",
     (("  if constexpr (V == 8) return c / 8 * 4 + c % 8 / 4 * (cw / 2) + c % 4;",
       "  if constexpr (false) return 0;"),
      ("  if constexpr (V == 8) {\n    float lo[4], hi[4];",
       "  if constexpr (false) {\n    float lo[4], hi[4];")), True),
    ("budget 227 KB (one block an SM; the channels-first tile at R = 64)",
     (("kBudget = 113 * 1024", "kBudget = 227 * 1024"),), True),
    ("blend + norm tile layouts: a row a whole warp",
     (("G = kTile ? 16 : 32,", "G = 32,"), ("tile ? 16 : 32, tile ? kMaxTileNJ", "32, tile ? kMaxTileNJ")),
     True),
    ("blend + norm: registers and budget for 3 blocks an SM",
     (("kUpBlocks = 2;", "kUpBlocks = 3;"), ("kBudget = 113 * 1024", "kBudget = 75 * 1024")), True),
    ("IEEE division in place of the Newton quotient",
     (("return fmaf(w, l3ac::quotient(v - n.x, n.y, n.z), b);",
       "return fmaf(w, (v - n.x) / n.y, b);"),), True),
    ("the per-channel vectors one element a load",
     (("  p.vpar = C % 4 == 0 && aligned16(dw_b)", "  p.vpar = false && aligned16(dw_b)"),
      ("  p.vpar = Co % 4 == 0 &&", "  p.vpar = false &&")), True),
    ("ablation: no statistics (each row's moments taken as (0, 1))",
     (("  float s = 0.0f;  // the values past the row are zero",
       "  if (n > 0) return make_float2(0.0f, 1.0f);\n  float s = 0.0f;"),), False),
    ("ablation: no stores (loads, conv or blend, statistics, the tile only)",
     (("  if (vec && n == V) {\n    if (o_bf) {", "  if (true) return;\n  if (vec && n == V) {\n"
       "    if (o_bf) {"),
      ("    static_cast<bf16*>(out)[i] = __float2bfloat16_rn(v);\n  else",
       "    return;\n  else"),
      ("    static_cast<float*>(out)[i] = v;\n}", "    return;\n}"),
      ("  const int lane = threadIdx.x & 31;\n  if (!o_bf) {",
       "  const int lane = threadIdx.x & 31;\n  if (lane < 32) return;\n  if (!o_bf) {")), False),
)


def _t(rng, shape, std=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))


def _dw_case(rng, dev, dtype):
    """(the call on one library, the kernel's output, the plain output, bytes moved) of
    the dw + norm pass."""
    B, T, C = DW_SHAPE
    x = _t(rng, (B, T, C)).to(dev, dtype)
    dw, dw_b = _t(rng, (C, 7), 7 ** -0.5).to(dev), _t(rng, (C,), 0.1).to(dev)
    nw, nb = (1.0 + _t(rng, (C,), 0.1)).to(dev), _t(rng, (C,), 0.1).to(dev)
    out = torch.empty(B * T, C, device=dev, dtype=dtype)
    bf = int(dtype == torch.bfloat16)
    y = cu._depthwise(x.float().transpose(1, 2), dw[:, None, :], dw_b, 1, None, None)
    want = channel_norm(y, nw, nb, dim=1).transpose(1, 2).to(dtype)

    def call(lib):
        fn = lib.l3ac_general_dw_norm
        fn.argtypes, fn.restype = cu._DW_ARGTYPES, ctypes.c_int
        return lambda: fn(x.data_ptr(), *x.stride(), bf, B, T, C, 7, 1, dw.data_ptr(),
                          dw_b.data_ptr(), nw.data_ptr(), nb.data_ptr(), out.data_ptr(), bf,
                          _build.stream_ptr())
    return call, lambda: out.view(B, T, C), want, 2 * x.numel() * x.element_size() + 4 * 10 * C


def _up_case(rng, dev, dtype, B, T, Co, s, layout):
    """The same of the blend + norm pass: z (B T, Co) fp32 into ``layout``."""
    z = _t(rng, (B * T, Co)).to(dev)
    nw, nb = (1.0 + _t(rng, (Co,), 0.2)).to(dev), _t(rng, (Co,), 0.2).to(dev)
    taps = uf.phase_taps(s, dev)
    shape, os_ = {"cl": ((B, T * s, Co), (T * s * Co, 1, s * Co, Co)),
                  "cf": ((B, Co, T * s), (Co * T * s, T * s, s, 1))}[layout]
    out = torch.empty(shape, device=dev, dtype=dtype)
    ph = [channel_norm(p, nw, nb, dim=2) for p in upsample_phases(z.view(B, T, Co), s, 1)]
    want = interleave(ph, 1)
    want = (want if layout == "cl" else want.transpose(1, 2)).to(dtype)

    def call(lib):
        fn = lib.l3ac_general_up
        fn.argtypes, fn.restype = uf._GENERAL_ARGTYPES, ctypes.c_int
        return lambda: fn(z.data_ptr(), taps.data_ptr(), nw.data_ptr(), nb.data_ptr(),
                          out.data_ptr(), *os_, B, T, Co, s, int(dtype == torch.bfloat16),
                          _build.stream_ptr())
    return call, lambda: out, want, 4 * z.numel() + out.numel() * out.element_size() + 4 * 3 * Co


def _err(got: torch.Tensor, want: torch.Tensor, tol: float) -> tuple[float, bool]:
    err = (got.float() - want.float()).abs().max().item()
    return err, bool(torch.isfinite(got.float()).all()) and err <= tol * max(
        1.0, want.float().abs().max().item())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rows_variants: CUDA is not available (card only)")
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    print(describe(dev), flush=True)
    libs = build_variants("rows_variants", SOURCE, [subs for _, subs, _ in VARIANTS],
                          "l3ac_general_dw_norm", cu._DW_ARGTYPES)
    simt = build_variants("rows_variants_simt", SIMT_SOURCE, [()], "l3ac_general_dw_norm",
                          cu._DW_ARGTYPES)[0]
    names = [name for name, _, _ in VARIANTS] + ["the former passes (tools/general_rows_simt.cu)"]
    computes = [c for _, _, c in VARIANTS] + [True]
    libs = libs + [simt]
    for i, (name, (_, log)) in enumerate(zip(names, libs)):
        use = "; ".join(f"{k} {ptxas_usage(log, k)}" for k in (
            "general_dw_norm_kernelILb0ELi10E", "general_dw_norm_kernelILb1ELi6E",
            "general_up_kernelILi2ELb1E", "general_up_kernelILi6ELb0E")) if i < len(VARIANTS) \
            else ""
        print(f"variant {i}: {name}{'; ' + use if use else ''}", flush=True)
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL_BF16 if dtype == torch.bfloat16 else TOL
        cases = [("dw + norm (2, 1779, 1280)", _dw_case(rng, dev, dtype))]
        cases += [(f"blend + norm z (2 x {T}, {Co}) s {s} {layout}",
                   _up_case(rng, dev, dtype, B, T, Co, s, layout))
                  for B, T, Co, s, layout in UP_SHAPES]
        for label, (call, got, want, nbytes) in cases:
            fns = [call(lib) for lib, _ in libs]
            ms = [[] for _ in fns]
            for order in (range(len(fns)), reversed(range(len(fns)))):
                for i in order:
                    ms[i].append(queued_ms(fns[i], ITERS))
            print(f"{describe(dev).split(',')[0]} {dtype} {label}: bytes bound "
                  f"{nbytes / PEAK_BYTES * 1e3:.4f} ms", flush=True)
            for i, fn in enumerate(fns):
                fn()
                torch.cuda.synchronize()
                held = ""
                if computes[i]:
                    err, ok = _err(got(), want, tol)
                    held = f", max abs err {err:.3e}{'' if ok else ' (FAILS its tolerance)'}"
                loop = f", a loop of launches {time_ms(fn, dev, ITERS):.4f}" if i == 0 else ""
                print(f"  variant {i}: device {min(ms[i]):.4f} ms (runs {ms[i][0]:.4f}, "
                      f"{ms[i][1]:.4f}){loop}{held}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
