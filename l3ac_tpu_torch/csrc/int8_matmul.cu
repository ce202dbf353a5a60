// int8 weight-only dense layer: y = scale * (x @ w_q^T) + b, fp32 in and out.
//
// Replaces l3ac_tpu/ops/pallas/int8_matmul.py:int8_matmul (body _kernel).
// x: (M, K) fp32; w_q: (N, K) int8 (nn.Linear layout); scale, b: (N) fp32.
//
// Bound on the H100: 2 M K N operations against 4 M (K + N) + K N bytes. On
// the tensor cores (tc_gemm.cuh) the product takes three bf16 passes: q is
// exact in bf16, so only x is split, into three bf16 terms (24 bits). Two
// TF32 passes (x_hi q + x_lo q) were measured too and ran slower
// (tools/tc_variants.py, PERF.md). The scale moves to the epilogue, so the
// rounding is s * sum(x q), not the plain version's sum(x (q s)); both agree
// within fp32 rounding. The TPU kernel keeps the whole (K, N) weight in VMEM
// and tiles only M; here a block holds one 128 x 128 output tile and streams
// K in steps of 32. Device memory sees
// only the 1-byte weight; the int8 tile is widened to fp32 in shared memory.
// GEGLU widths (K = 341, N = 682) take 4-byte copies of x and byte loads of
// w_q with zero fill at the edges.
// bf16 x (l3ac_int8_matmul_bf16): the rounding of the TPU kernel (:37-40),
// y = bf16(x . bf16(q s)^T + bf16(b)) with fp32 sums: each int8 tile is
// dequantized to bf16(fp32(q) s) as it goes into shared memory (the scale
// in the tile load, not the epilogue), and one bf16 pass (mma.sync
// m16n8k16) runs on tc_gemm.cuh's bf16 GEMM. Bound: 2 M K N operations
// against 2 M (K + N) + K N bytes.
#include "tc_gemm.cuh"

namespace {

using l3ac::tc::Epi;
using l3ac::tc::launch_gemm;

template <bool kVecA>
cudaError_t launch(const l3ac::tc::Params& p, bool vec_b, cudaStream_t s) {
  return vec_b ? launch_gemm<true, Epi::kBias, kVecA, true>(p, s)
               : launch_gemm<true, Epi::kBias, kVecA, false>(p, s);
}

}  // namespace

// x: (M, K) fp32; w_q: (N, K) int8; scale: (N) fp32; bias: (N) fp32 or null;
// out: (M, N) fp32. All contiguous, out not aliasing x. Returns the CUDA
// error code.
extern "C" int l3ac_int8_matmul(const float* x, const signed char* w_q, const float* scale,
                                const float* bias, float* out, int M, int N, int K,
                                void* stream) {
  l3ac::tc::Params p{};
  p.a = x;
  p.b_q = w_q;
  p.scale = scale;
  p.bias = bias;
  p.out = out;
  p.M = M, p.N = N, p.K = K;
  const bool vec_a = K % 4 == 0 && l3ac::tc::aligned(x, 16);
  const bool vec_b = K % 4 == 0 && l3ac::tc::aligned(w_q, 4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec_a ? launch<true>(p, vec_b, s) : launch<false>(p, vec_b, s);
}

// x: (M, K) bf16; w_q: (N, K) int8; scale: (N) fp32; bias: (N) bf16 or null;
// out: (M, N) bf16. All contiguous, out not aliasing x. Returns the CUDA
// error code.
extern "C" int l3ac_int8_matmul_bf16(const __nv_bfloat16* x, const signed char* w_q,
                                     const float* scale, const __nv_bfloat16* bias,
                                     __nv_bfloat16* out, int M, int N, int K, void* stream) {
  using l3ac::tc::launch_gemm_int8_bf16;
  l3ac::tc::ParamsBf16 p{};
  p.a = x;
  p.b_q = w_q;
  p.scale = scale;
  p.bias16 = bias;
  p.out = out;
  p.M = M, p.N = N, p.K = K;
  const bool vec_a = K % 8 == 0 && l3ac::tc::aligned(x, 16);
  const bool vec_b = K % 4 == 0 && l3ac::tc::aligned(w_q, 4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_a)
    return vec_b ? launch_gemm_int8_bf16<true, true>(p, s) : launch_gemm_int8_bf16<true, false>(p, s);
  return vec_b ? launch_gemm_int8_bf16<false, true>(p, s) : launch_gemm_int8_bf16<false, false>(p, s);
}
