"""The narrow ConvUnit kernel (``csrc/conv_unit_narrow.cu``) beside its
measured alternatives and stage ablations, at the ``conv_unit_ct`` shapes of
one 1kbps 8 x 10 s request: the measurement behind the tiling in the
kernel's header comment.

    python3 -m l3ac_tpu_torch.tools.narrow_variants [--bf16]

``--bf16`` times the bf16 kernel (``csrc/conv_unit_narrow_bf16.cu``) and its
ablations instead, on bf16 inputs, held against ``conv_unit_plain_bf16``
within 2^-6 x max(1, max |plain|).

Card only. Each variant is the kernel's source with named text
substitutions (each must apply exactly once), built with the kernel
library's nvcc flags into its own library, called on the same seeded inputs
and timed with CUDA events. Variants that compute the unit are held against
the plain version (max abs error <= 1e-4 x max(1, max |plain|)); ablations
skip a stage, are only timed, and say where the time goes. Prints ptxas's
registers and spills of each variant at C = 24, 48, 96, the time per shape
and the sum per 8 x 10 s request (encode, decode). Variant 0 is what the
port runs.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import build_variants, describe, ptxas_usage, time_ms
from . import variant_source as _variant_source
from ..ops.kernels import _build
from ..ops.kernels import conv_unit as cu

SOURCE = _build.CSRC_DIR / "conv_unit_narrow.cu"
SOURCE_BF16 = _build.CSRC_DIR / "conv_unit_narrow_bf16.cu"
T0 = 160110  # 8 x 10 s at hop 270, as chip_smoke.py
# (C, T, launches per 8 x 10 s request (encode, decode)): chip_smoke.py phase 3
SHAPES = ((24, T0, (1, 0)), (48, T0 // 6, (1, 0)), (96, T0 // 30, (1, 0)),
          (96, T0 // 6, (0, 2)), (48, T0 // 2, (0, 1)))
B = 8
TOL = 1e-4
TOL_BF16 = 2.0 ** -6
ITERS = 20

_FP32_B = (  # B tiles staged once, as fp32, and split into TF32 hi / lo as fragments load
    ("stage = 2 * (w1 + w2);", "stage = w1 + w2;"),
    ("for (int e = tid; e < 2 * kNC * q1; e += kThreads) {\n"
     "      const int hl = e / (kNC * q1), rem = e - hl * kNC * q1;",
     "for (int e = tid; e < kNC * q1; e += kThreads) {\n      const int hl = 0, rem = e;"),
    ("for (int e = tid; e < 2 * rows2 * (kNC / 4); e += kThreads) {\n"
     "      const int hl = e / (rows2 * (kNC / 4)), rem = e - hl * rows2 * (kNC / 4);",
     "for (int e = tid; e < rows2 * (kNC / 4); e += kThreads) {\n      const int hl = 0, rem = e;"),
    ("float* dst = st + 2 * g.w1 + hl * g.w2 + row * kHS + col;",
     "float* dst = st + g.w1 + row * kHS + col;"),
    ("const float* w1l = st + g.w1 + ob1;", ""),
    ("const float* w2h = st + 2 * g.w1 + ob2;", "const float* w2h = st + g.w1 + ob2;"),
    ("const float* w2l = st + 2 * g.w1 + g.w2 + ob2;", ""),
    ("uint32_t bh[4], bl[4];\n"
     "            ptx::ldmatrix_x4(bh, w1h + jp * 16 * g.as + k8 * 8);\n"
     "            ptx::ldmatrix_x4(bl, w1l + jp * 16 * g.as + k8 * 8);",
     "uint32_t braw[4], bh[4], bl[4];\n"
     "            ptx::ldmatrix_x4(braw, w1h + jp * 16 * g.as + k8 * 8);\n"
     "            split(braw, bh, bl);"),
    ("uint32_t bh[4], bl[4];\n"
     "        ptx::ldmatrix_x4(bh, w2h + p * 16 * kHS + k8 * 8);\n"
     "        ptx::ldmatrix_x4(bl, w2l + p * 16 * kHS + k8 * 8);",
     "uint32_t braw[4], bh[4], bl[4];\n"
     "        ptx::ldmatrix_x4(braw, w2h + p * 16 * kHS + k8 * 8);\n"
     "        split(braw, bh, bl);"),
)
_NO_CHUNKS = (("const int chunks = (C4 + kNC - 1) / kNC;", "const int chunks = 0;"),)
# (name, substitutions, computes the unit)
VARIANTS = (
    ("8 warps x 16 rows (128 columns), W1 / W2' TF32 hi + lo, 2-stage ring", (), True),
    ("W1 / W2' as fp32, split at fragment load (half the weight bytes)", _FP32_B, True),
    ("4 warps x 16 rows (64 columns)",
     (("constexpr int kWarps = 8;", "constexpr int kWarps = 4;"),), True),
    ("at most 2 blocks per SM at C <= 24 (128 registers)",
     (("kNT2 <= 3 ? 3 : kNT2 <= 6 ? 2 : 1", "kNT2 <= 6 ? 2 : 1"),), True),
    ("ablation: no activation (b1 only)",
     (("v[h][jj] = !ok ? 0.0f : (a.alpha != nullptr ? l3ac::snake(y, al) : l3ac::gelu(y));",
       "v[h][jj] = ok ? y : 0.0f;"),), False),
    ("ablation: no hidden chunks (x staged, dw + norm, residual out)", _NO_CHUNKS, False),
    ("ablation: x in and out only (no taps, no norm, no chunks)", _NO_CHUNKS + (
        ("for (int k = 0; k < a.K; ++k) acc += xr[k * a.dil] * __ldg(wr + k);", "acc += xr[0];"),
        ("if (a.norm_w != nullptr) {\n        const float u = warp_sum8(s) / C;",
         "if (a.norm_w != nullptr && C < 0) {\n        const float u = warp_sum8(s) / C;")),
     False),
)


_NO_STEPS_BF16 = (("for (int si = 0; si < a.steps; ++si) {", "for (int si = 0; si < 0; ++si) {"),)
_ONE_TAP_BF16 = (("for (int k = 0; k < K; ++k) {", "for (int k = 0; k < 1; ++k) {"),)
_NO_NORM_BF16 = (("if (a.norm) {  // moments", "if (false) {  // moments"),)
# the bf16 kernel (conv_unit_narrow_bf16.cu): variant 0, a tiling and the ablations
VARIANTS_BF16 = (
    ("persistent, weights resident, 8 warps x 16 columns, 2 x stages, 2 blocks/SM at C <= 48",
     (), True),
    ("1 block per SM at every C (no register cap at C <= 48)",
     (("__launch_bounds__(kThreads, kP <= 3 ? 2 : 1)", "__launch_bounds__(kThreads, 1)"),), True),
    ("sin_ilp squared (the GEMM core's snake) in place of sin2_ilp",
     (("l3ac::snake2_ilp(y, al, dd, rc);", "l3ac::snake_ilp(y, al, dd, rc);"),), True),
    ("the depthwise tap loop unrolled by 7",
     (("for (int k = 0; k < K; ++k) {",
       "#pragma unroll 7\n        for (int k = 0; k < K; ++k) {"),),
     True),
    ("ablation: no sine in the snake (y + (a y)^2 / (a + eps))",
     (("l3ac::snake2_ilp(y, al, dd, rc);",
       "for (int i = 0; i < 16; ++i)\n"
       "          y[i] += l3ac::quotient(al[i] * y[i] * al[i] * y[i], dd[i], rc[i]);"),), False),
    ("ablation: no activation (b1 only)", (("l3ac::snake2_ilp(y, al, dd, rc);", ""),), False),
    ("ablation: one depthwise tap", _ONE_TAP_BF16, False),
    ("ablation: no ChannelNorm", _NO_NORM_BF16, False),
    ("ablation: no products (x staged, dw + norm, residual out)", _NO_STEPS_BF16, False),
    ("ablation: x in and out only (one tap, no norm, no products)",
     _NO_STEPS_BF16 + _ONE_TAP_BF16 + _NO_NORM_BF16, False),
)


def variant_source(subs, bf16: bool = False) -> str:
    """The kernel's source with ``subs`` applied; each must match exactly once."""
    return _variant_source(SOURCE_BF16 if bf16 else SOURCE, subs, "narrow_variants")


def registers(log: str, kernel: str = "narrow_kernel", per: int = 8) -> str:
    """The ptxas usage of the instances at C = 24, 48, 96 (template argument
    C / per)."""
    return ", ".join(f"C={C}: {ptxas_usage(log, f'{kernel}ILi{C // per}E')}" for C in (24, 48, 96))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bf16", action="store_true", help="the bf16 kernel and its ablations")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("narrow_variants: CUDA is not available (it times kernels on the card)")
    dev = torch.device("cuda")
    if args.bf16:
        return main_bf16(dev)
    libs = build_variants("narrow_variants", SOURCE, [subs for _, subs, _ in VARIANTS],
                          "l3ac_conv_unit_narrow", cu._NARROW_ARGTYPES)
    print(f"[{describe(dev)}] conv_unit_narrow variants, ms per call (max abs error)", flush=True)
    for i, ((name, _, _), (_, log)) in enumerate(zip(VARIANTS, libs)):
        print(f"  [{i}] {name}: {registers(log)}", flush=True)
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream

    def t(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(dev)

    sums = [[0.0, 0.0] for _ in VARIANTS]
    for C, T, per in SHAPES:
        w = cu.ConvUnitWeights(t(C, 1, 7, std=7 ** -0.5), t(C, std=0.1), 1 + t(C, std=0.1),
                               t(C, std=0.1), t(4 * C, C, std=C ** -0.5), t(4 * C, std=0.1),
                               1 + t(4 * C, std=0.2).abs(), t(4 * C, std=0.1),
                               t(4 * C, std=0.1), t(C, 4 * C, std=(4 * C) ** -0.5), t(C, std=0.1))
        x = t(B, C, T)
        p = cu.prepare_weights(w)
        w2f, _ = cu.fold_grn(w)
        p32 = p._replace(w1_hi=w.pw1_w, w2_hi=w2f.t().contiguous())
        want = cu.conv_unit_plain(x, w, channel_dim=1)
        out = torch.empty_like(x)
        dw = w.dw_w[:, 0, :].contiguous()
        line = f"C={C} T={T}:"
        for i, ((name, subs, exact), (lib, _)) in enumerate(zip(VARIANTS, libs)):
            q = p32 if subs is _FP32_B else p

            def call(lib=lib, q=q):
                err = lib.l3ac_conv_unit_narrow(
                    x.data_ptr(), out.data_ptr(), dw.data_ptr(), w.dw_b.data_ptr(),
                    w.norm_w.data_ptr(), w.norm_b.data_ptr(), q.w1_hi.data_ptr(),
                    q.w1_lo.data_ptr(), w.pw1_b.data_ptr(), w.alpha.data_ptr(),
                    q.w2_hi.data_ptr(), q.w2_lo.data_ptr(), q.b2.data_ptr(), B, C, T, 7, 1,
                    4 * C, 0, stream)
                if err:
                    raise RuntimeError(f"narrow_variants [{i}]: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            if exact and not err <= TOL * max(1.0, want.abs().max().item()):
                raise AssertionError(f"narrow_variants [{i}] C={C}: max abs error {err}")
            ms = time_ms(call, dev, ITERS)
            sums[i][0] += per[0] * ms
            sums[i][1] += per[1] * ms
            line += f" [{i}] {ms:.4f}" + (f" ({err:.1e})" if exact else "")
        print(line, flush=True)
    print("summed per 8 x 10 s request (encode, decode):")
    for i, (name, _, _) in enumerate(VARIANTS):
        print(f"  [{i}] {sums[i][0]:.3f} / {sums[i][1]:.3f} ms  {name}")
    return 0


def main_bf16(dev: torch.device) -> int:
    """The bf16 kernel and its ablations at the same shapes, bf16 inputs."""
    libs = build_variants("narrow_variants_bf16", SOURCE_BF16,
                          [subs for _, subs, _ in VARIANTS_BF16], "l3ac_conv_unit_narrow_bf16",
                          cu._NARROW_BF16_ARGTYPES)
    print(f"[{describe(dev)}] conv_unit_narrow_bf16 variants, ms per call (max abs error)",
          flush=True)
    for i, ((name, _, _), (_, log)) in enumerate(zip(VARIANTS_BF16, libs)):
        print(f"  [{i}] {name}: {registers(log, 'narrow_bf16_kernel', 16)}", flush=True)
    rng = np.random.default_rng(0)
    bf = torch.bfloat16

    def t(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(dev)

    sums = [[0.0, 0.0] for _ in VARIANTS_BF16]
    for C, T, per in SHAPES:
        w = cu.ConvUnitWeights(*(v.to(bf) for v in (
            t(C, 1, 7, std=7 ** -0.5), t(C, std=0.1), 1 + t(C, std=0.1), t(C, std=0.1),
            t(4 * C, C, std=C ** -0.5), t(4 * C, std=0.1), 1 + t(4 * C, std=0.2).abs(),
            t(4 * C, std=0.1), t(4 * C, std=0.1), t(C, 4 * C, std=(4 * C) ** -0.5),
            t(C, std=0.1))))
        x = t(B, C, T).to(bf)
        p = cu.prepare_bf16(w)
        want = cu.conv_unit_plain_bf16(x, w, channel_dim=1).float()
        out = torch.empty_like(x)
        line = f"C={C} T={T}:"
        for i, ((name, subs, exact), (lib, _)) in enumerate(zip(VARIANTS_BF16, libs)):
            def call(lib=lib):
                err = cu.call_narrow_bf16(lib.l3ac_conv_unit_narrow_bf16, x, out, p, 1)
                if err:
                    raise RuntimeError(f"narrow_variants bf16 [{i}]: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            err = (out.float() - want).abs().max().item()
            if exact and not err <= TOL_BF16 * max(1.0, want.abs().max().item()):
                raise AssertionError(f"narrow_variants bf16 [{i}] C={C}: max abs error {err}")
            ms = time_ms(call, dev, ITERS)
            sums[i][0] += per[0] * ms
            sums[i][1] += per[1] * ms
            line += f" [{i}] {ms:.4f}" + (f" ({err:.1e})" if exact else "")
        print(line, flush=True)
    print("summed per 8 x 10 s request (encode, decode):")
    for i, (name, _, _) in enumerate(VARIANTS_BF16):
        print(f"  [{i}] {sums[i][0]:.3f} / {sums[i][1]:.3f} ms  {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
