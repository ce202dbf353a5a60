"""The up-path kernels (``csrc/up_fused_tc.cu``, ``csrc/up_fused.cu``) beside
their measured alternatives and ablations, at the four up paths of one
1kbps 8 x 10 s decode: (8, 1779, 512) -> 256 s5 and (8, 8895, 256) -> 96 s3 on
the tensor-core kernel, (8, 96, 26685) -> 48 s3 and (8, 48, 80055) -> 24 s2
(phase_split) on the streaming one.

    python3 -m l3ac_tpu_torch.tools.up_variants [--bf16 [--channels-last]]

``--bf16`` times the bf16 kernels instead, on bf16 x and weights, held
against ``up_fused_plain_bf16`` within 2^-6 x max(1, max |plain|) with their
bit-equal share: at the two (B, C, T) shapes the streaming kernel the port
runs with its ablations and the former kernel (the bf16 instance of
``csrc/up_fused.cu``) with its own; at the two (B, T, C) shapes the kernel
the port runs (``csrc/up_fused_tc_bf16.cu``) with its alternatives and
ablations, and the former tensor-core kernel (the bf16 instance of
``csrc/up_fused_tc.cu``) with its own; each beside the conv alone in bf16
and the bytes bound.
``--channels-last`` runs the (B, T, C) part alone.

Card only. Each variant is the kernel's source with named text
substitutions (each must apply exactly once), built with the kernel
library's nvcc flags into its own library, called on the same seeded inputs
and timed with CUDA events. Variants that compute the up path are held
against the plain version (max abs error <= 1e-4 x max(1, max |plain|));
ablations drop a part of the work, are only timed, and say where the time
goes. Prints ptxas's registers and spills of each variant's kernel at the
first shape and its ms per call at each shape; the same up path on
wgmma (``tools/up_fused_wgmma.cu``, built only here) beside it; and, as yardsticks the port
never calls, the 1x1 conv alone (``F.linear`` / ``einsum``, cuBLAS fp32,
TF32 off) and the bytes bound. Variant 0 of each kernel is what the port
runs.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from . import build_variants, describe, ptxas_usage, time_ms
from ..ops.kernels import _build
from ..ops.kernels import up_fused as uf
from ..ops.kernels.tc_gemm import split_tf32

TC_SOURCE = _build.CSRC_DIR / "up_fused_tc.cu"
WGMMA_SOURCE = Path(__file__).with_name("up_fused_wgmma.cu")
STREAM_SOURCE = _build.CSRC_DIR / "up_fused.cu"
B = 8
TC_SHAPES = ((1779, 512, 256, 5), (8895, 256, 96, 3))       # (T, Ci, Co, s), (B, T, C)
STREAM_SHAPES = ((26685, 96, 48, 3, False), (80055, 48, 24, 2, True))  # + phase_split
TOL = 1e-4
TOL_BF16 = 2.0 ** -6
ITERS = 20
PEAK_BYTES = 3.35e12

# (name, substitutions, computes the up path)
_STORE = "if (o < Co) st4(op, v);"
_CONV_ONLY = (("  const bool norm = a.norm_w != nullptr;\n  float* stats",
               "  return;\n  const bool norm = a.norm_w != nullptr;\n  float* stats"),)
TC_VARIANTS = (
    ("mma.sync m16n8k8, 32 x 32 warp tiles, 64-row tiles (62 owned), W split into TF32 at "
     "fragment load, 3-stage ring", (), True),
    ("128-row tiles where Co <= 128 (stage 1 only; stage 0 builds variant 0 again)",
     (("constexpr bool kTallTiles = false;", "constexpr bool kTallTiles = true;"),), True),
    ("W pre-split hi / lo, 2-stage ring (3 stages do not fit at Co = 256)",
     (("constexpr bool kPreSplit = false;", "constexpr bool kPreSplit = true;"),
      ("constexpr int kStages = 3;", "constexpr int kStages = 2;")), True),
    ("2-stage ring", (("constexpr int kStages = 3;", "constexpr int kStages = 2;"),), True),
    ("K steps rotated by block (blocks start on different W columns)",
     (("  const int steps = (Ci + kBK - 1) / kBK;",
       "  const int steps = (Ci + kBK - 1) / kBK;\n"
       "  const int rot = (blockIdx.x + 7 * blockIdx.y) % steps;"),
      ("    const int k0 = s * kBK;", "    const int k0 = ((s + rot) % steps) * kBK;")), True),
    ("the three passes of each accumulator back to back (dependent mma in a row)",
     (("#pragma unroll\n      for (int mt = 0; mt < 2; ++mt)\n#pragma unroll\n"
       "        for (int nt = 0; nt < 4; ++nt) ptx::mma_tf32(acc[mt][nt], lo[mt], bh[nt]);\n"
       "#pragma unroll\n      for (int mt = 0; mt < 2; ++mt)\n#pragma unroll\n"
       "        for (int nt = 0; nt < 4; ++nt) ptx::mma_tf32(acc[mt][nt], hi[mt], bl[nt]);\n"
       "#pragma unroll\n      for (int mt = 0; mt < 2; ++mt)\n#pragma unroll\n"
       "        for (int nt = 0; nt < 4; ++nt) ptx::mma_tf32(acc[mt][nt], hi[mt], bh[nt]);",
       "#pragma unroll\n      for (int mt = 0; mt < 2; ++mt)\n#pragma unroll\n"
       "        for (int nt = 0; nt < 4; ++nt) {\n"
       "          ptx::mma_tf32(acc[mt][nt], lo[mt], bh[nt]);\n"
       "          ptx::mma_tf32(acc[mt][nt], hi[mt], bl[nt]);\n"
       "          ptx::mma_tf32(acc[mt][nt], hi[mt], bh[nt]);\n        }"),), True),
    ("ablation: one TF32 pass (hi . hi)",
     (("for (int nt = 0; nt < 4; ++nt) ptx::mma_tf32(acc[mt][nt], lo[mt], bh[nt]);",
       "for (int nt = 0; nt < 0; ++nt) ptx::mma_tf32(acc[mt][nt], lo[mt], bh[nt]);"),
      ("for (int nt = 0; nt < 4; ++nt) ptx::mma_tf32(acc[mt][nt], hi[mt], bl[nt]);",
       "for (int nt = 0; nt < 0; ++nt) ptx::mma_tf32(acc[mt][nt], hi[mt], bl[nt]);")), False),
    ("ablation: no row statistics",
     (("  if (norm) {  // the statistics of every z row", "  if (false) {"),), False),
    ("ablation: the conv and the statistics (no output pass)",
     (("  // one warp per owned row: for each phase the blend, the affine of the",
       "  return;\n  // one warp per owned row: for each phase the blend, the affine of the"),),
     False),
    ("ablation: no store (all computed, nothing written)",
     ((_STORE, _STORE.replace("if (o < Co)", "if (o < Co && v.x == -1234.5f)")),),
     False),
    ("ablation: the conv only (z into shared memory, no epilogue)", _CONV_ONLY, False),
)
# the same up path on wgmma (tools/up_fused_wgmma.cu, built only here)
WGMMA_VARIANTS = (
    ("wgmma m64nNk8, W pre-split hi / lo from shared memory, x hi / lo in registers",
     (), True),
    ("wgmma, K steps rotated by block (blocks start on different W columns)",
     (("  const int steps = (Ci + kBK - 1) / kBK;",
       "  const int steps = (Ci + kBK - 1) / kBK;\n"
       "  const int rot = (blockIdx.x + 7 * blockIdx.y) % steps;"),
      ("    const int k0 = s * kBK;", "    const int k0 = ((s + rot) % steps) * kBK;")), True),
    ("wgmma, ablation: one TF32 pass (hi . hi)",
     (("      ptx::wgmma_tf32<kN>(acc, lo[ks], dh, ks > 0);\n"
       "      ptx::wgmma_tf32<kN>(acc, hi[ks], dl, 1);\n"
       "      ptx::wgmma_tf32<kN>(acc, hi[ks], dh, 1);",
       "      ptx::wgmma_tf32<kN>(acc, hi[ks], dh, ks > 0);"),), False),
    ("wgmma, ablation: the conv only",
     (("  const bool norm = a.norm_w != nullptr;\n  float* stats",
       "  return;\n  const bool norm = a.norm_w != nullptr;\n  float* stats"),), False),
)
STREAM_VARIANTS = (
    ("128-column tiles, the conv on the tensor cores (3xTF32, channels as M), two n8 tiles per warp at once from Co > 32", (), True),
    ("64-column tiles", (("constexpr int kMaxS = 128;", "constexpr int kMaxS = 64;"),), True),
    ("one n8 tile of columns per warp at a time at every Co",
     (("constexpr int kPairFromMT = 3;", "constexpr int kPairFromMT = 5;"),), True),
    ("two n8 tiles of columns per warp at once at every Co",
     (("constexpr int kPairFromMT = 3;", "constexpr int kPairFromMT = 1;"),), True),
    ("ablation: one TF32 pass (hi . hi)",
     (("            for (int mt = 0; mt < kMT; ++mt) ptx::mma_tf32(acc[u][mt], lo[mt], bh[u]);",
       "            for (int mt = 0; mt < 0; ++mt) ptx::mma_tf32(acc[u][mt], lo[mt], bh[u]);"),
      ("            for (int mt = 0; mt < kMT; ++mt) ptx::mma_tf32(acc[u][mt], hi[mt], bl[u]);",
       "            for (int mt = 0; mt < 0; ++mt) ptx::mma_tf32(acc[u][mt], hi[mt], bl[u]);")),
     False),
    ("ablation: no column statistics",
     (("  if (norm) {\n    const int j = 3 + tid;", "  if (false) {\n    const int j = 3 + tid;"),),
     False),
    ("ablation: no store (all computed, nothing written)",
     (("for (int e0 = 4 * lane - mis; e0 < len; e0 += 128) {",
       "for (int e0 = 4 * lane - mis; e0 < len && src[0] == -1234.5f; e0 += 128) {"),), False),
    ("ablation: staging only (W and x into shared memory)",
     (("  // 2. z = W x + b on the tensor cores", "  return;\n  // 2. z = W x + b"),), False),
    ("ablation: the conv only (x in, z into shared memory)",
     (("  __syncthreads();  // W and x are dead", "  return;\n  __syncthreads();  // W"),), False),
)

# the bf16 (B, C, T) kernel the port runs (csrc/up_fused_bf16.cu) and its ablations
SOURCE_BF16 = _build.CSRC_DIR / "up_fused_bf16.cu"
_NO_NORM_BF16 = (("const bool norm = a.norm != 0;", "const bool norm = false;"),)
STREAM_VARIANTS_BF16 = (
    ("a block per SM of <= 16 warps x windows of 2 n8 column tiles, x by rows of 16-byte "
     "pieces a tile ahead, W fragments resident, z in registers, rows out by bulk copy", (), True),
    ("two blocks per SM of up to 8 warps",
     (("constexpr int kMaxWarps = 16;", "constexpr int kMaxWarps = 8;"),
      ("constexpr int kBlocksPerSm = 1;", "constexpr int kBlocksPerSm = 2;")), True),
    ("windows of 4 n8 column tiles (30 owned columns), up to 8 warps",
     (("constexpr int kTiles = 2;", "constexpr int kTiles = 4;"),
      ("constexpr int kMaxWarps = 16;", "constexpr int kMaxWarps = 8;")), True),
    ("a 3-window x ring (two tiles in flight)",
     (("constexpr int kStages = 2;", "constexpr int kStages = 3;"),), True),
    ("IEEE division and square root in the statistics",
     (("m0[u] = sum8(s0) * inv_co;", "m0[u] = sum8(s0) / Co;"),
      ("m1[u] = sum8(s1) * inv_co;", "m1[u] = sum8(s1) / Co;"),
      ("rsd = rsqrtf(fmaf(fmaxf(qs, 0.0f), inv_co, kNormEps));",
       "rsd = 1.0f / sqrtf(fmaxf(qs, 0.0f) / Co + kNormEps);")), True),
    ("ablation: the conv only (x in, z summed, nothing stored)",
     (("    // z[u][mt][e]: channel 16 mt + g + 8 (e >> 1)",
       "    {\n      float sink = 0.0f;\n      for (int u = 0; u < R; ++u)\n"
       "        for (int mt = 0; mt < kMT; ++mt)\n          for (int e = 0; e < 4; ++e) "
       "sink += z[u][mt][e];\n      if (sink == -1234.5f) a.out[lane] = __float2bfloat16_rn(sink);\n"
       "      continue;\n    }\n    // z[u][mt][e]: channel 16 mt + g + 8 (e >> 1)"),), False),
    ("ablation: no norm (no statistics)", _NO_NORM_BF16, False),
    ("ablation: x in and out only (no conv, no blend, no norm)",
     _NO_NORM_BF16 + (("for (int ks = 0; ks < KS; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {"),
                      ("for (int p = 0; p < (kS > 0 ? kS : s); ++p) {",
                       "for (int p = 0; p < 0; ++p) {")), False),
)
_NO_CONV_PR12 = (("  {\n    constexpr int kTilesPerPass", "  if (false) {\n    constexpr int kTilesPerPass"),)
_NO_NORM_PR12 = (("const bool norm = a.norm != 0;", "const bool norm = false;"),)
# the PR 12 bf16 stream kernel (up_fused.cu's bf16 instance) and its ablations
STREAM_VARIANTS_PR12 = (
    ("PR 12 kernel: x staged as fp32, W fp32 rounded per fragment, m16n8k8, 5 phases", (), True),
    ("PR 12, ablation: the conv only (x in, z into shared memory)",
     (("  __syncthreads();  // W and x are dead", "  return;\n  __syncthreads();  // W"),), False),
    ("PR 12, ablation: no norm", _NO_NORM_PR12, False),
    ("PR 12, ablation: x in and out only (no conv, no norm, no blend)",
     _NO_CONV_PR12 + _NO_NORM_PR12 +
     (("    if (jt < cols) {\n      for (int p = 0; p < s; ++p) {",
       "    if (jt < 0) {\n      for (int p = 0; p < s; ++p) {"),), False),
)


# the bf16 (B, T, C) kernel the port runs (csrc/up_fused_tc_bf16.cu, route
# "wgmma"), its alternatives and ablations
SOURCE_WGMMA = _build.CSRC_DIR / "up_fused_tc_bf16.cu"
_NO_NORM_WG = (("  const bool norm = a.norm_w != nullptr;", "  const bool norm = false;"),)
_MMA_LINE = "        mma_half<G::kHalf>(acc, ptx::wgmma_desc_sw128(xt) + 2 * kk, wt + 32 * kk, 1);"
TC_VARIANTS_WGMMA = (
    ("persistent 64-row tiles, x and W by TMA from a producer warp, wgmma in two warpgroups "
     "(Co / 2 each), the row statistics from the accumulators, a warp per output row; three "
     "blocks per SM at Co <= 128, two above", (), True),
    ("two blocks per SM at Co <= 128 (rings of three stages or more)",
     (("constexpr int kSmallBlocks = 3;", "constexpr int kSmallBlocks = 2;"),), True),
    ("a ring of at most 4 stages",
     (("constexpr int kMaxStages = 8;", "constexpr int kMaxStages = 4;"),), True),
    ("ablation: the conv only (z into shared memory, no epilogue)",
     (("    epilogue<kCo>(acc, zs, stats, prm, taps, a, b, t0, ct);", ""),), False),
    ("ablation: no norm (no statistics)", _NO_NORM_WG, False),
    ("ablation: no blend (each phase the row itself, normalized)",
     (("float4 v = make_float4(fmaf(zc[k].x, ca, fmaf(zo.x, cb, cc)),\n"
       "                               fmaf(zc[k].y, ca, fmaf(zo.y, cb, cc)),\n"
       "                               fmaf(zc[k].z, ca, fmaf(zo.z, cb, cc)),\n"
       "                               fmaf(zc[k].w, ca, fmaf(zo.w, cb, cc)));",
       "float4 v = make_float4(fmaf(zc[k].x, ca, cc), fmaf(zc[k].y, ca, cc), "
       "fmaf(zc[k].z, ca, cc), fmaf(zc[k].w, ca, cc));"),), False),
    ("ablation: x in and out only (no conv, no norm, no blend)",
     _NO_NORM_WG + ((_MMA_LINE, ""),), False),
)

# the former bf16 (B, T, C) kernel (up_fused_tc.cu's bf16 instance) and the
# ablations that say where its time goes
_NO_NORM_TC = (("  const bool norm = a.norm_w != nullptr;", "  const bool norm = false;"),)
TC_VARIANTS_PREV = (
    ("former kernel: 64-row tiles (62 owned), one m16n8k16 pass, W streamed through a 3-stage "
     "cp.async ring, z to shared memory, a warp per output row", (), True),
    ("former, ablation: the conv only (z into shared memory, no epilogue)", _CONV_ONLY, False),
    ("former, ablation: no norm (no statistics)", _NO_NORM_TC, False),
    ("former, ablation: no blend (each phase the row itself)",
     (("float4 v = make_float4(fmaf(zc[k].x, wc, zo.x * wo), fmaf(zc[k].y, wc, zo.y * wo),\n"
       "                               fmaf(zc[k].z, wc, zo.z * wo), fmaf(zc[k].w, wc, zo.w * wo));",
       "float4 v = zc[k];"),), False),
    ("former, ablation: x in and out only (no conv, no norm, no blend)",
     _NO_NORM_TC + (("      for (int ks = 0; ks < kBK / 16; ++ks) {",
                     "      for (int ks = 0; ks < 0; ++ks) {"),), False),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bf16", action="store_true", help="the bf16 kernels and their ablations")
    ap.add_argument("--channels-last", action="store_true",
                    help="with --bf16: the (B, T, C) kernels alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("up_variants: CUDA is not available (it times kernels on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version and the yardstick in fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    if args.bf16:
        if not args.channels_last:
            main_bf16(dev)
        return main_bf16_tc(dev)
    tc_libs = build_variants("up_variants_tc", TC_SOURCE, [s for _, s, _ in TC_VARIANTS],
                             "l3ac_up_fused_tc", uf._TC_ARGTYPES)
    wg_libs = build_variants("up_variants_wgmma", WGMMA_SOURCE,
                             [s for _, s, _ in WGMMA_VARIANTS], "l3ac_up_fused_tc", uf._TC_ARGTYPES)
    st_libs = build_variants("up_variants_stream", STREAM_SOURCE,
                             [s for _, s, _ in STREAM_VARIANTS], "l3ac_up_fused", uf._ARGTYPES)
    rng = np.random.default_rng(0)

    def t(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(dev)

    def weights(Ci, Co):
        return uf.UpWeights(t(Co, Ci, std=Ci ** -0.5), t(Co, std=0.3), 1.0 + t(Co, std=0.2),
                            t(Co, std=0.2))

    stream = torch.cuda.current_stream().cuda_stream
    print(f"[{describe(dev)}] up-path variants, ms per call", flush=True)

    def report(tag, names, libs, entry, cases):
        """cases: (label, call(lib, pre_split) -> out, plain out, yardstick ms, bound ms)"""
        totals = [0.0] * len(names)
        for label, call, want, conv_ms, bound in cases:
            print(f"  {tag} {label}: conv alone (cuBLAS fp32) {conv_ms:.4f} ms, bytes bound "
                  f"{bound:.4f} ms", flush=True)
            for i, ((name, subs, exact), (lib, log)) in enumerate(zip(names, libs)):
                pre = any("kPreSplit = true" in new for _, new in subs)
                got = call(lib, pre)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                if exact and not err <= TOL * max(1.0, want.abs().max().item()):
                    raise AssertionError(f"up_variants {tag} [{i}] {label}: max abs error {err}")
                ms = time_ms(lambda: call(lib, pre), dev, ITERS)
                totals[i] += ms
                usage = ptxas_usage(log, entry)
                print(f"    [{i}] {ms:.4f} ms{f' (max abs error {err:.1e})' if exact else ''}, "
                      f"{usage}: {name}", flush=True)
        print(f"  {tag} per decode: " + ", ".join(f"[{i}] {v:.4f}" for i, v in
                                                   enumerate(totals)), flush=True)

    cases, wg_cases = [], []
    for T, Ci, Co, s in TC_SHAPES:
        w, x = weights(Ci, Co), t(B, T, Ci)
        hi, lo = (c.contiguous() for c in split_tf32(w.w))
        out = torch.empty(B, T * s, Co, device=dev)

        def call(lib, pre, x=x, w=w, hi=hi, lo=lo, out=out, T=T, Ci=Ci, Co=Co, s=s):
            err = lib.l3ac_up_fused_tc(x.data_ptr(), (hi if pre else w.w).data_ptr(),
                                       lo.data_ptr() if pre else None, w.b.data_ptr(),
                                       w.norm_w.data_ptr(), w.norm_b.data_ptr(), out.data_ptr(),
                                       B, Ci, Co, T, s, stream)
            if err:
                raise RuntimeError(f"up_variants: CUDA error {err}")
            return out

        want = uf.up_fused_plain(x, w, scale=s, channel_dim=2)
        conv = time_ms(lambda x=x, w=w: F.linear(x, w.w, w.b), dev, ITERS)
        bound = 4 * B * T * (Ci + s * Co) / PEAK_BYTES * 1e3
        label = f"(B, T, Ci) = ({B}, {T}, {Ci}) -> Co {Co}, s {s}"
        cases.append((label, call, want, conv, bound))
        wg_cases.append((label, lambda lib, pre, call=call: call(lib, True), want, conv, bound))
    report("tc", TC_VARIANTS, tc_libs, "up_fused_tc_kernelILi2ELi8E", cases)
    report("wgmma", WGMMA_VARIANTS, wg_libs, "up_fused_tc_kernelILi2ELi128E", wg_cases)

    cases = []
    for T, Ci, Co, s, split in STREAM_SHAPES:
        w, x = weights(Ci, Co), t(B, Ci, T)
        buf = uf.prepare_up(w, "stream")
        out = torch.empty((s, B, Co, T) if split else (B, Co, T * s), device=dev)
        if split:
            os_, order = (Co * T, T, 1, B * Co * T), uf.ORDER_PHASE
        else:
            os_, order = (Co * T * s, T * s, s, 1), uf.ORDER_TIME

        def call(lib, pre, x=x, buf=buf, out=out, T=T, Ci=Ci, Co=Co, s=s, os_=os_, order=order):
            err = lib.l3ac_up_fused(x.data_ptr(), buf.data_ptr(), out.data_ptr(), 1, B, Ci, Co,
                                    T, s, x.stride(0), T, 1, *os_, order, stream)
            if err:
                raise RuntimeError(f"up_variants: CUDA error {err}")
            return out

        want = uf.up_fused_plain(x, w, scale=s, channel_dim=1, phase_split=split)
        want = torch.stack(want) if split else want
        conv = time_ms(lambda x=x, w=w: torch.einsum("oc,bct->bot", w.w, x) + w.b[:, None],
                       dev, ITERS)
        bound = 4 * B * T * (Ci + s * Co) / PEAK_BYTES * 1e3
        cases.append((f"(B, Ci, T) = ({B}, {Ci}, {T}) -> Co {Co}, s {s}"
                      f"{', phase_split' if split else ''}", call, want, conv, bound))
    report("stream", STREAM_VARIANTS, st_libs, "up_fused_stream_kernelILi3E", cases)
    return 0


def main_bf16(dev: torch.device) -> int:
    """The bf16 stream kernels at the two (B, C, T) shapes of a decode."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    # (source, variants, C symbol, its argtypes, prepared buffer, ptxas entry at Co = 48)
    groups = [(SOURCE_BF16, STREAM_VARIANTS_BF16, "l3ac_up_fused_ct_bf16", uf._CT_BF16_ARGTYPES,
               "stream_bf16", "up_bf16_kernelILi3ELi3E"),
              (STREAM_SOURCE, STREAM_VARIANTS_PR12, "l3ac_up_fused_bf16", uf._ARGTYPES, "stream",
               "bfloat16Li3E")]
    names, fns = [], []
    for source, variants, symbol, argtypes, kind, entry in groups:
        built = build_variants(f"up_variants_{source.stem}_bf16", source,
                               [subs for _, subs, _ in variants], symbol, argtypes)
        names += [(name, exact, kind) for name, _, exact in variants]
        fns += [(getattr(lib, symbol), ptxas_usage(log, entry)) for lib, log in built]
    print(f"[{describe(dev)}] bf16 up_fused_ct stream variants, ms per call", flush=True)
    for i, ((name, _, _), (_, usage)) in enumerate(zip(names, fns)):
        print(f"  [{i}] {name}: {usage}", flush=True)
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream

    def t(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(dev).to(bf)

    totals = [0.0] * len(names)
    for T, Ci, Co, s, split in STREAM_SHAPES:
        w = uf.UpWeights(t(Co, Ci, std=Ci ** -0.5), t(Co, std=0.3), 1.0 + t(Co, std=0.2),
                         t(Co, std=0.2))
        x = t(B, Ci, T)
        bufs = {kind: uf.prepare_up(w, kind) for kind in {k for _, _, k in names}}
        out = torch.empty((s, B, Co, T) if split else (B, Co, T * s), device=dev, dtype=bf)
        if split:
            os_, order = (Co * T, T, 1, B * Co * T), uf.ORDER_PHASE
        else:
            os_, order = (Co * T * s, T * s, s, 1), uf.ORDER_TIME
        want16 = uf.up_fused_plain_bf16(x, w, scale=s, channel_dim=1, phase_split=split)
        want16 = torch.stack(want16) if split else want16
        want = want16.float()
        conv = time_ms(lambda: torch.einsum("oc,bct->bot", w.w, x) + w.b[:, None], dev, ITERS)
        bound = 2 * B * T * (Ci + s * Co) / PEAK_BYTES * 1e3
        print(f"  (B, Ci, T) = ({B}, {Ci}, {T}) -> Co {Co}, s {s}{', phase_split' if split else ''}: "
              f"conv alone (einsum bf16) {conv:.4f} ms, bytes bound {bound:.4f} ms", flush=True)
        for i, ((name, exact, kind), (fn, _)) in enumerate(zip(names, fns)):
            def call(fn=fn, kind=kind):
                if kind == "stream_bf16":
                    err = fn(x.data_ptr(), bufs[kind].data_ptr(), out.data_ptr(), 1, B, Ci, Co, T,
                             s, int(split), stream)
                else:
                    err = fn(x.data_ptr(), bufs[kind].data_ptr(), out.data_ptr(), 1, B, Ci, Co, T,
                             s, x.stride(0), T, 1, *os_, order, stream)
                if err:
                    raise RuntimeError(f"up_variants bf16 [{i}]: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            err = (out.float() - want).abs().max().item()
            equal = (out.view(torch.int16) == want16.view(torch.int16)).float().mean().item()
            if exact and not err <= TOL_BF16 * max(1.0, want.abs().max().item()):
                raise AssertionError(f"up_variants bf16 [{i}]: max abs error {err}")
            ms = time_ms(call, dev, ITERS)
            totals[i] += ms
            print(f"    [{i}] {ms:.4f} ms" + (f" (max abs error {err:.1e}, bit-equal {equal:.6f})"
                                              if exact else "") + f": {name}", flush=True)
    print("  per decode: " + ", ".join(f"[{i}] {v:.4f}" for i, v in enumerate(totals)), flush=True)
    return 0


def main_bf16_tc(dev: torch.device) -> int:
    """The bf16 (B, T, C) kernels at the two channels-last shapes of a
    decode: the former kernel's group, then the port's (each built, then timed
    at both shapes)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream

    def t(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(dev).to(bf)

    cases = []
    print(f"[{describe(dev)}] bf16 up_fused (B, T, C) variants, ms per call", flush=True)
    for T, Ci, Co, s in TC_SHAPES:
        w = uf.UpWeights(t(Co, Ci, std=Ci ** -0.5), t(Co, std=0.3), 1.0 + t(Co, std=0.2),
                         t(Co, std=0.2))
        x = t(B, T, Ci)
        buf = uf.prepare_up(w, "tc")
        Cp, es = uf.tc_padded_co(Co), buf.element_size()
        p_b = buf.data_ptr() + es * Cp * uf.tc_row_elems(Ci, bf)
        out = torch.empty(B, T * s, Co, device=dev, dtype=bf)
        want16 = uf.up_fused_plain_bf16(x, w, scale=s, channel_dim=2)
        conv = time_ms(lambda: F.linear(x, w.w, w.b), dev, ITERS)
        bound = 2 * B * T * (Ci + s * Co) / PEAK_BYTES * 1e3
        print(f"  (B, T, Ci) = ({B}, {T}, {Ci}) -> Co {Co}, s {s}: conv alone (F.linear bf16) "
              f"{conv:.4f} ms, bytes bound {bound:.4f} ms", flush=True)
        cases.append((T, Ci, Co, s, x, buf, p_b, Cp, es, out, want16))
    # (source, variants, C symbol, ptxas entry at Co = 256)
    groups = [(TC_SOURCE, TC_VARIANTS_PREV, "l3ac_up_fused_tc_bf16",
               "up_fused_tc_kernelILi2ELi8ELb1ELb1E"),
              (SOURCE_WGMMA, TC_VARIANTS_WGMMA, "l3ac_up_fused_wgmma_bf16",
               "up_fused_tc_bf16_kernelILi256E")]
    i = 0
    for source, variants, symbol, entry in groups:
        built = build_variants(f"up_variants_{source.stem}_bf16", source,
                               [subs for _, subs, _ in variants], symbol, uf._TC_BF16_ARGTYPES)
        for (name, _, exact), (lib, log) in zip(variants, built):
            fn, total, line = getattr(lib, symbol), 0.0, ""
            for T, Ci, Co, s, x, buf, p_b, Cp, es, out, want16 in cases:
                def call(fn=fn, T=T, Ci=Ci, Co=Co, s=s, x=x, buf=buf, p_b=p_b, Cp=Cp, es=es,
                         out=out, i=i):
                    err = fn(x.data_ptr(), buf.data_ptr(), p_b, p_b + es * Cp, p_b + 2 * es * Cp,
                             out.data_ptr(), B, Ci, Co, T, s, stream)
                    if err:
                        raise RuntimeError(f"up_variants bf16 tc [{i}]: CUDA error {err}")
                out.fill_(float("nan"))
                call()
                torch.cuda.synchronize()
                want = want16.float()
                err = (out.float() - want).abs().max().item()
                equal = (out.view(torch.int16) == want16.view(torch.int16)).float().mean().item()
                if exact and not err <= TOL_BF16 * max(1.0, want.abs().max().item()):
                    raise AssertionError(f"up_variants bf16 tc [{i}] Co {Co}: max abs error {err}")
                ms = time_ms(call, dev, ITERS)
                total += ms
                line += f" Co {Co}: {ms:.4f}" + (f" ({err:.1e}, bit-equal {equal:.6f})"
                                                  if exact else "")
            print(f"  [{i}] per decode {total:.4f} ms;{line}; {ptxas_usage(log, entry)}: {name}",
                  flush=True)
            i += 1
    return 0

if __name__ == "__main__":
    raise SystemExit(main())
