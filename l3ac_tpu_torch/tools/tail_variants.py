"""The legacy tail kernel (``csrc/legacy_tail.cu``) beside its measured
alternatives and ablations, at the tail's shape in one 1kbps 8 x 10 s
decode: the phase pair (8, 24, 80055) x 2 of the last up path.

    python3 -m l3ac_tpu_torch.tools.tail_variants [--bf16]

``--bf16`` times the bf16 kernel (``csrc/legacy_tail_bf16.cu``) and its
ablations instead, on bf16 inputs with weights at 2.5x the model's init
scale, held against ``legacy_tail_plain_bf16`` within 2^-6 x max(1, max
|plain|).

Card only. Each variant is the kernel's source with named text
substitutions (each must apply exactly once), built with the kernel
library's nvcc flags into its own library, called on the same seeded inputs
and timed with CUDA events. Variants that compute the tail are held against
the plain version (max abs error <= 1e-4 x max(1, max |plain|)); ablations
drop a part of the work, are only timed, and say where the time goes.
Prints ptxas's registers and spills of each variant at C = 24 and its ms
per call. Variant 0 is what the port runs.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import build_variants, describe, ptxas_usage, time_ms
from ..ops.kernels import _build
from ..ops.kernels import legacy_tail as lt

SOURCE = _build.CSRC_DIR / "legacy_tail.cu"
B, C, T = 8, 24, 160110  # chip_smoke.py: the tail of one 8 x 10 s decode
TOL = 1e-4
TOL_BF16 = 2.0 ** -6
STD_BF16 = 0.05   # chip_smoke.py TAIL_BF16_STD
ITERS = 20

_UNITS = ("for (int u = 0; u < kUnits; ++u) {", "for (int u = 0; u < 0; ++u) {")
# (name, substitutions, computes the tail)
VARIANTS = (
    ("16 warps x 3 slabs (768-row tiles), 4 input loads in flight per thread", (), True),
    ("12 input loads in flight per thread",
     (("constexpr int kBatch = 4;", "constexpr int kBatch = 12;"),), True),
    ("16 warps x 2 slabs (512-row tiles, 428 samples: 20 % halo)",
     (("constexpr int kSlabs = 3;", "constexpr int kSlabs = 2;"),), True),
    ("ablation: no sine in the snakes",
     (("const float s = sinf(a * h);", "const float s = a * h;"),), False),
    ("ablation: one TF32 pass per product step (hi . hi)",
     (("  ptx::mma_tf32(d, al, bh);\n  ptx::mma_tf32(d, ah, bl);\n", ""),), False),
    ("ablation: one k7 tap of seven",
     (("#pragma unroll 1\n        for (int k = 0; k < kTaps; ++k) {",
       "#pragma unroll 1\n        for (int k = 3; k < 4; ++k) {"),), False),
    ("ablation: input and output only (no units)", (_UNITS,), False),
)


# the bf16 kernel (legacy_tail_bf16.cu): variant 0, tilings and the ablations
SOURCE_BF16 = _build.CSRC_DIR / "legacy_tail_bf16.cu"
SYMBOL_BF16 = "l3ac_legacy_tail_bf16"
ENTRY_BF16 = "legacy_tail_bf16_kernelILi3ELb0E"   # the instance at C = 24
_J_LOOP = "#pragma unroll\n        for (int j = 0; j < kJ1; ++j) {"
VARIANTS_BF16 = (
    ("16 warps x 6 slabs (1536-row tiles), taps folded into K, 12 input loads in flight",
     (), True),
    ("the k16 loop of the k7 conv rolled",
     ((_J_LOOP, _J_LOOP.replace("unroll", "unroll 1")),), True),
    ("16 warps x 3 slabs (768-row tiles, 12 % halo)",
     (("static constexpr int kSlabs = kWide ? 2 : 6;",
       "static constexpr int kSlabs = kWide ? 2 : 3;"),), True),
    ("2 blocks of 8 warps x 12 slabs per SM (1536-row tiles)",
     (("static constexpr int kWarps = kWide ? 8 : 16;", "static constexpr int kWarps = 8;"),
      ("static constexpr int kSlabs = kWide ? 2 : 6;",
       "static constexpr int kSlabs = kWide ? 2 : 12;"),
      ("__launch_bounds__(Tiling<kWide>::kThreads, 1)",
       "__launch_bounds__(Tiling<kWide>::kThreads, kWide ? 1 : 2)")), True),
    ("sin_ilp squared (the GEMM core's snake) in place of sin2_ilp",
     (("  l3ac::snake2_ilp(y, al, d, rc);", "  l3ac::snake_ilp(y, al, d, rc);"),), True),
    ("ablation: no sine in the snakes",
     (("  l3ac::snake2_ilp(y, al, d, rc);",
       "  for (int i = 0; i < kN; ++i)\n"
       "    y[i] += l3ac::quotient(al[i] * y[i] * al[i] * y[i], d[i], rc[i]);"),),
     False),
    ("ablation: the k7 conv over one tap's K",
     ((_J_LOOP, _J_LOOP.replace("j < kJ1", "j < (kC8 + 1) / 2")),), False),
    ("ablation: no products (no k7 conv, no 1x1)",
     ((_J_LOOP, _J_LOOP.replace("j < kJ1", "j < 0")),
      ("        for (int j = 0; j < kP; ++j)\n#pragma unroll\n          for (int p = 0; p < kP;",
       "        for (int j = 0; j < 0; ++j)\n#pragma unroll\n          for (int p = 0; p < kP;")),
     False),
    ("ablation: no output conv (tanh of the bias)",
     (("for (int k = 0; k < kTaps; ++k) {\n        const unsigned char* ar",
       "for (int k = 0; k < 0; ++k) {\n        const unsigned char* ar"),), False),
    ("ablation: input and output only (no units)", (_UNITS,), False),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bf16", action="store_true", help="the bf16 kernel and its ablations")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tail_variants: CUDA is not available (it times kernels on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    if args.bf16:
        return main_bf16(dev)
    libs = build_variants("tail_variants", SOURCE, [subs for _, subs, _ in VARIANTS],
                          "l3ac_legacy_tail", lt._ARGTYPES)
    rng = np.random.default_rng(0)

    def t(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(dev)

    pos = lambda *shape: 1.0 + t(*shape, std=0.3).abs()
    w = lt.TailWeights(pos(3, C), t(3, C, C, 7, std=0.1), t(3, C, std=0.1), pos(3, C),
                       t(3, C, C, std=0.1), t(3, C, std=0.1), pos(C), t(1, C, 7, std=0.1),
                       t(1, std=0.05))
    x = t(B, C, T)
    x0, x1 = x[..., 0::2].contiguous(), x[..., 1::2].contiguous()
    packed = lt.pack(w)
    want = lt.legacy_tail_plain(x, w)
    out = torch.empty(B, T, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    print(f"[{describe(dev)}] legacy tail variants at (B, C, T) = ({B}, {C}, {T}), "
          "phase-pair input, ms per call", flush=True)
    for i, ((name, _, exact), (lib, log)) in enumerate(zip(VARIANTS, libs)):
        def call(lib=lib):
            err = lib.l3ac_legacy_tail(x0.data_ptr(), x1.data_ptr(), packed.data_ptr(),
                                       out.data_ptr(), B, C, T, x0.stride(0), x0.stride(1),
                                       stream)
            if err:
                raise RuntimeError(f"tail_variants [{i}]: CUDA error {err}")
        call()
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        if exact and not err <= TOL * max(1.0, want.abs().max().item()):
            raise AssertionError(f"tail_variants [{i}]: max abs error {err}")
        ms = time_ms(call, dev, ITERS)
        print(f"  [{i}] {ms:.4f} ms{f' (max abs error {err:.1e})' if exact else ''}, "
              f"{ptxas_usage(log, 'legacy_tail_kernelILi3E')}: {name}", flush=True)
    return 0


def main_bf16(dev: torch.device) -> int:
    """The bf16 kernel and its ablations at the same shape, bf16 inputs."""
    libs = build_variants("tail_variants_bf16", SOURCE_BF16,
                          [subs for _, subs, _ in VARIANTS_BF16], SYMBOL_BF16, lt._ARGTYPES)
    rng = np.random.default_rng(0)
    bf = torch.bfloat16

    def t(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(dev)

    pos = lambda *shape: 1.0 + t(*shape, std=0.3).abs()
    w = lt.TailWeights(*(v.to(bf) for v in (
        pos(3, C), t(3, C, C, 7, std=STD_BF16), t(3, C, std=0.1), pos(3, C),
        t(3, C, C, std=STD_BF16), t(3, C, std=0.1), pos(C), t(1, C, 7, std=STD_BF16),
        t(1, std=0.05))))
    x = t(B, C, T).to(bf)
    x0, x1 = x[..., 0::2].contiguous(), x[..., 1::2].contiguous()
    packed = lt.pack_bf16(w)
    want = lt.legacy_tail_plain_bf16(x, w).float()
    out = torch.empty(B, T, device=dev, dtype=bf)
    stream = torch.cuda.current_stream().cuda_stream
    print(f"[{describe(dev)}] bf16 legacy tail variants at (B, C, T) = ({B}, {C}, {T}), "
          "phase-pair input, ms per call", flush=True)
    for i, ((name, _, exact), (lib, log)) in enumerate(zip(VARIANTS_BF16, libs)):
        def call(lib=lib):
            err = getattr(lib, SYMBOL_BF16)(x0.data_ptr(), x1.data_ptr(), packed.data_ptr(),
                                            out.data_ptr(), B, C, T, x0.stride(0), x0.stride(1),
                                            stream)
            if err:
                raise RuntimeError(f"tail_variants bf16 [{i}]: CUDA error {err}")
        call()
        torch.cuda.synchronize()
        err = (out.float() - want).abs().max().item()
        if exact and not err <= TOL_BF16 * max(1.0, want.abs().max().item()):
            raise AssertionError(f"tail_variants bf16 [{i}]: max abs error {err}")
        ms = time_ms(call, dev, ITERS)
        print(f"  [{i}] {ms:.4f} ms{f' (max abs error {err:.1e})' if exact else ''}, "
              f"{ptxas_usage(log, ENTRY_BF16)}: {name}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
