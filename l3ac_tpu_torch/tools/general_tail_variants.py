"""The general tail (``csrc/general_gemm.cu``: seven launches of the general
product, each snake in the prologue of the product that reads it) beside its
ablations and beside the former design (``tools/general_tail_former.cu``:
seven elementwise snake passes and seven launches of the former product),
at ROADMAP C3's shapes: the tail at (2, 96, 16000) through both entry points
(the interleaved input and the phase pair), and the (B, C, T) up path's
12 -> 200 conv on x (2, 12, 26685) into z (2 x 26685, 200) fp32; each in
fp32 and bf16.

    python3 -m l3ac_tpu_torch.tools.general_tail_variants

Card only. Each variant is ``general_gemm.cu`` with named text
substitutions (each must apply exactly once), built with the kernel
library's nvcc flags into its own library and called on the same seeded
inputs through its C entry point, with the launch plan of
``legacy_tail.general_plan`` (the tail) or ``conv_unit.gemm_args`` (the
conv); the former design runs its own entry points on the weights as they
are. Times are the card's time without the host's (``tools.queued_ms``:
CUDA events around calls queued behind a sleeping kernel), in turns (each
variant, then again in reverse order); variant 0 and the former design also
by CUDA events around a loop of calls. Variants that compute the function
are held against the plain versions (fp32: max abs error <= 1e-4 x max(1,
max |plain|); bf16: 2^-6 x); ablations drop a part of the work, are only
timed, and say where the time goes. ``F.conv1d`` on the same x is the
conv's library yardstick. Prints ptxas's registers and spills of each
variant's kernels, and the bounds: the products as 3 TF32 passes (fp32) or
one bf16 pass at the card's peak, the bytes at 3.35 TB/s. Variant 0 is what
the port runs.
"""

from __future__ import annotations

import argparse
import ctypes
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from . import build_variants, describe, ptxas_usage, queued_ms, time_ms
from ..ops.kernels import _build
from ..ops.kernels import conv_unit as cu
from ..ops.kernels import legacy_tail as lt
from ..ops.kernels.tc_gemm import split_tf32

SOURCE = _build.CSRC_DIR / "general_gemm.cu"
FORMER_SOURCE = Path(__file__).with_name("general_tail_former.cu")
TAIL_SHAPE = (2, 96, 16000)       # (B, C, T): the D override's tail width
UP_SHAPE = (2, 12, 26685, 200)    # (B, Ci, T, Co): the D override's (B, C, T) up path
TOL, TOL_BF16 = 1e-4, 2.0 ** -6
STD24 = {torch.float32: 0.1, torch.bfloat16: 0.05}  # chip_smoke.py's tail weights
ITERS = 20
PEAK_BYTES, PEAK_TF32, PEAK_BF16 = 3.35e12, 495e12, 989e12

# (name, substitutions); the ablations do not compute the function
VARIANTS = (
    ("the port: a window of 16-byte blocks a chunk, the k7 conv as 7 shifted products, the "
     "snake in the prologue, stores in 16-byte pieces", ()),
    ("ablation: no prologue snake", (("  if (g.pro == nullptr) return v;", "  return v;"),)),
    ("ablation: no epilogue stores",
     (("  for (int e = tid; e < other * pieces; e += L::kThreads) {",
       "  for (int e = tid; g.N < 0 && e < other * pieces; e += L::kThreads) {"),)),
    ("per-element staging forced (the window filled by element loads)",
     (("  g.stage = stage;\n", "  g.stage = kStageElement;\n"),)),
    ("ablation: no products (staging, pipeline, epilogue)",
     (("      if (warp_live) compute(s0 + tap, tap % g.stages);",
       "      if (warp_live && g.N < 0) compute(s0 + tap, tap % g.stages);"),)),
    ("ablation: no B staging (the ring's copies skipped)",
     (("  auto issue_b = [&](int s, int k) {\n",
       "  auto issue_b = [&](int s, int k) {\n    if (g.N > 0) return;\n"),)),
    ("chunks of 32 channels (a step a tap and 32 channels: 3x the steps at C = 96)",
     (("  if (cw > 256) cw = 256;", "  if (cw > 32) cw = 32;"),)),
    ("fp32 in blocks of 8 warps (64 rows, two blocks an SM)",
     (("static constexpr int kWM = kBf ? 4 : 8, kWN = 2;", "static constexpr int kWM = 4, kWN = 2;"),
      ("__launch_bounds__(Tile<kBf, kNT>::kThreads, kBf ? 2 : 1)",
       "__launch_bounds__(Tile<kBf, kNT>::kThreads, 2)"),
      ("kBudget = kBf ? 113 * 1024 : 227 * 1024", "kBudget = 113 * 1024"))),
)
COMPUTES = (True, False, False, True, False, False, True, True)
KERNELS = ("window_gemm_kernelILb0ELi6E", "window_gemm_kernelILb1ELi6E",
           "window_gemm_kernelILb0ELi1E", "window_gemm_kernelILb1ELi8E")
# the former product's C entry point (l3ac_general_gemm of tools/general_tail_former.cu)
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
FORMER_GEMM_ARGTYPES = ([_P] + [_L] * 3 + [_I] * 2 + [_P] * 2 + [_I] + [_P] * 2 +
                        [_I, _P, _I, _I, _P] + [_L] * 3 + [_I] * 2 + [_L] + [_I] * 2 + [_P])
FORMER_TAIL_ARGTYPES = [_P] * 2 + [_L] * 2 + [_P] * 8 + [_I] * 4 + [_P]


def _t(rng, shape, std=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))


def _tail_weights(rng, C, dtype):
    s = STD24[dtype] * (24 / C) ** 0.5
    pos = lambda shape: 1.0 + _t(rng, shape, 0.3).abs()
    return lt.TailWeights(*(x.to(dtype) for x in (
        pos((3, C)), _t(rng, (3, C, C, 7), s), _t(rng, (3, C), 0.1), pos((3, C)),
        _t(rng, (3, C, C), s), _t(rng, (3, C), 0.1), pos((C,)), _t(rng, (1, C, 7), s),
        _t(rng, (1,), 0.05))))


def _tail_case(rng, dev, dtype, pair):
    """(new tail on a library, former tail on its library, output, plain
    output, bound ms, bound by) at TAIL_SHAPE."""
    B, C, T = TAIL_SHAPE
    w = lt.TailWeights(*(t.to(dev) for t in _tail_weights(rng, C, dtype)))
    x = _t(rng, (B, C, T)).to(dev, dtype)
    x0, x1 = (x[..., 0::2].contiguous(), x[..., 1::2].contiguous()) if pair else (x, None)
    xbuf, hbuf, sbuf = (torch.empty_like(x) for _ in range(3))
    out = torch.empty(B, T, device=dev, dtype=dtype)
    plain = lt.legacy_tail_plain_bf16 if dtype == torch.bfloat16 else lt.legacy_tail_plain
    args = [cu.gemm_args(**p) for p in lt.general_plan(x0, x1, w, T, xbuf, hbuf, out)]

    def new(lib, launch=None):
        fn = lib.l3ac_general_gemm
        fn.argtypes, fn.restype = cu._GEMM_ARGTYPES, ctypes.c_int
        if launch is not None:  # one launch of the plan alone
            return lambda: _build.check(fn(*args[launch]), "general tail variant")
        return lambda: [_build.check(fn(*a), "general tail variant") for a in args]

    w1, w2, wo = (t.contiguous() for t in (w.w1, w.w2, w.wo))
    vec = lt.general_vectors(w)

    def former(lib):
        fn = lib.l3ac_general_tail
        fn.argtypes, fn.restype = FORMER_TAIL_ARGTYPES, ctypes.c_int
        return lambda: _build.check(fn(
            x0.data_ptr(), _build.ptr(x1), x0.stride(0), x0.stride(1), w1.data_ptr(),
            w2.data_ptr(), wo.data_ptr(), vec.data_ptr(), xbuf.data_ptr(), hbuf.data_ptr(),
            sbuf.data_ptr(), out.data_ptr(), B, C, T, int(dtype == torch.bfloat16),
            _build.stream_ptr()), "former tail")

    products = B * T * (3 * (2 * 7 * C * C + 2 * C * C) + 2 * 7 * C)
    nbytes = x.element_size() * B * T * (C + 1) + 4 * sum(t.numel() for t in w)
    rate = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32 / 3
    bound = max(nbytes / PEAK_BYTES, products / rate) * 1e3
    return new, former, out, plain(x, w), bound, "bytes" if nbytes / PEAK_BYTES > products / rate \
        else "operations"


def _up_case(rng, dev, dtype):
    """The same of the 12 -> 200 conv, and F.conv1d on the same x."""
    B, Ci, T, Co = UP_SHAPE
    x = _t(rng, (B, Ci, T)).to(dev, dtype)
    W = _t(rng, (Co, Ci), Ci ** -0.5).to(dev, dtype)
    bias = _t(rng, (Co,), 0.3).to(dev)
    z = torch.empty(B * T, Co, device=dev)
    bf16 = dtype == torch.bfloat16
    b, b_lo = (W, None) if bf16 else split_tf32(W)
    a_map, o_map = (T, x.stride(0), 1, T), (B * T, 0, Co, 1)
    args = cu.gemm_args(x, a_map, Ci, b, z, o_map, B * T, Co, b_lo=b_lo, bias=bias)

    def new(lib):
        fn = lib.l3ac_general_gemm
        fn.argtypes, fn.restype = cu._GEMM_ARGTYPES, ctypes.c_int
        return lambda: _build.check(fn(*args), "general gemm variant")

    def former(lib):
        fn = lib.l3ac_general_gemm
        fn.argtypes, fn.restype = FORMER_GEMM_ARGTYPES, ctypes.c_int
        return lambda: _build.check(fn(
            x.data_ptr(), a_map[1], a_map[2], a_map[3], a_map[0], int(bf16), b.data_ptr(),
            _build.ptr(b_lo), int(bf16), bias.data_ptr(), None, 0, None, 0, 0, z.data_ptr(),
            o_map[1], o_map[2], o_map[3], o_map[0], 0, B * T, Co, Ci, _build.stream_ptr()),
            "former gemm")

    want = (torch.einsum("oc,bct->bto", W.double(), x.double()) + bias.double()).reshape(
        B * T, Co).float()
    wc, bc = W[:, :, None], bias.to(dtype)
    library = lambda: F.conv1d(x, wc, bc)
    nbytes = x.element_size() * x.numel() + 4 * z.numel() + W.element_size() * W.numel()
    return new, former, z, want, nbytes / PEAK_BYTES * 1e3, library


def _err(got, want, tol) -> str:
    err = (got.float() - want.float()).abs().max().item()
    ok = bool(torch.isfinite(got.float()).all()) and err <= tol * max(
        1.0, want.float().abs().max().item())
    return f"max abs err {err:.3e}{'' if ok else ' (FAILS its tolerance)'}"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("general_tail_variants: CUDA is not available (card only)")
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    card = describe(dev)
    print(card, flush=True)
    libs = build_variants("general_tail_variants", SOURCE, [s for _, s in VARIANTS],
                          "l3ac_general_gemm", cu._GEMM_ARGTYPES)
    former_lib = build_variants("general_tail_former", FORMER_SOURCE, [()],
                                "l3ac_general_tail", FORMER_TAIL_ARGTYPES)[0][0]
    for i, ((name, _), (_, log)) in enumerate(zip(VARIANTS, libs)):
        use = "; ".join(f"{k} {ptxas_usage(log, k)}" for k in KERNELS)
        print(f"variant {i}: {name}; {use}", flush=True)
    print(f"former: {FORMER_SOURCE.name} (14 launches a tail)", flush=True)
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL_BF16 if dtype == torch.bfloat16 else TOL
        cases = []
        for pair in (False, True):
            new, former, got, want, bound, by = _tail_case(rng, dev, dtype, pair)
            label = f"tail {TAIL_SHAPE} {'legacy_tail_poly_ct' if pair else 'legacy_tail_ct'}"
            cases.append((label, new, former, got, want, f"bound {bound:.4f} ms ({by})", None))
        new, former, got, want, bound, library = _up_case(rng, dev, dtype)
        cases.append((f"up path conv {UP_SHAPE[1]} -> {UP_SHAPE[3]} on x {UP_SHAPE[:3]}", new,
                      former, got, want, f"bytes bound {bound:.4f} ms", library))
        for label, new, former, got, want, bound, library in cases:
            fns = [new(lib) for lib, _ in libs] + [former(former_lib)]
            ms = [[] for _ in fns]
            # variant 0 first: the ablations then read valid data in the buffers
            fns[0]()
            for order in (range(len(fns)), reversed(range(len(fns)))):
                for i in order:
                    ms[i].append(queued_ms(fns[i], ITERS))
            print(f"{card.split(',')[0]} {dtype} {label}: {bound}", flush=True)
            for i, fn in enumerate(fns):
                fn()
                torch.cuda.synchronize()
                name = f"variant {i}" if i < len(VARIANTS) else "former"
                held = f", {_err(got, want, tol)}" if i >= len(VARIANTS) or COMPUTES[i] else ""
                loop = f", a loop of calls {time_ms(fn, dev, ITERS):.4f}" \
                    if i in (0, len(VARIANTS)) else ""
                print(f"  {name}: device {min(ms[i]):.4f} ms (runs {ms[i][0]:.4f}, "
                      f"{ms[i][1]:.4f}){loop}{held}", flush=True)
            if library is not None:
                print(f"  library F.conv1d: device {queued_ms(library, ITERS):.4f} ms, a loop "
                      f"of calls {time_ms(library, dev, ITERS):.4f}", flush=True)
            else:  # the plan's launches one at a time: k7 d 1, 1x1, k7 d 3, 1x1, k7 d 9, 1x1, out
                for i, (lib, _) in enumerate(libs):
                    each = [queued_ms(new(lib, k), ITERS) for k in range(lt.GENERAL_PRODUCTS)]
                    print(f"  variant {i} by launch: " + ", ".join(f"{t:.4f}" for t in each),
                          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
