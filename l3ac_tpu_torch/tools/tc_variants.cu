// The tensor-core GEMM core (csrc/tc_gemm.cuh) at the tilings and int8 splits
// it was chosen from, for tools/tc_variants.py; not part of the kernel
// library. Variant 0 of each entry point is what the port runs.
#include "tc_gemm.cuh"

namespace {

using namespace l3ac::tc;

template <class T>
int fp32(const Params& p, int epi, cudaStream_t s) {
  return epi == 0 ? launch_gemm<false, Epi::kSnake, true, true, T>(p, s)
                  : launch_gemm<false, Epi::kResidual, true, true, T>(p, s);
}

template <class T>
int int8(const Params& p, cudaStream_t s) {
  const bool vec = p.K % 4 == 0 && aligned(p.a, 16) && aligned(p.b_q, 4);
  return vec ? launch_gemm<true, Epi::kBias, true, true, T>(p, s)
             : launch_gemm<true, Epi::kBias, false, false, T>(p, s);
}

}  // namespace

// variant: 0 Fp32Tiling (512 threads, 32 x 32), 1 Tiling<256, 64> (32 x 64).
// epi 0: snake(a w^T + b) (pw1), 1: res + a w^T + b (pw2).
extern "C" int l3ac_tcv_fp32(int variant, const float* a, const float* w_hi, const float* w_lo,
                             const float* bias, const float* alpha, const float* res,
                             float* out, int M, int N, int K, int epi, void* stream) {
  Params p{};
  p.a = a, p.b_hi = w_hi, p.b_lo = w_lo, p.bias = bias, p.alpha = alpha, p.res = res;
  p.out = out, p.M = M, p.N = N, p.K = K;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return fp32<Fp32Tiling>(p, epi, s);
    case 1: return fp32<Tiling<256, 64, false>>(p, epi, s);
    default: return cudaErrorInvalidValue;
  }
}

// variant: 0 Int8Tiling (256 threads, 32 x 64, three bf16 passes), 1 the same
// tiling with two TF32 passes, 2 512 threads of 32 x 32 with bf16 passes.
extern "C" int l3ac_tcv_int8(int variant, const float* x, const signed char* w_q,
                             const float* scale, const float* bias, float* out, int M, int N,
                             int K, void* stream) {
  Params p{};
  p.a = x, p.b_q = w_q, p.scale = scale, p.bias = bias, p.out = out, p.M = M, p.N = N, p.K = K;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return int8<Int8Tiling>(p, s);
    case 1: return int8<Tiling<256, 64, false>>(p, s);
    case 2: return int8<Tiling<512, 32, true>>(p, s);
    default: return cudaErrorInvalidValue;
  }
}
