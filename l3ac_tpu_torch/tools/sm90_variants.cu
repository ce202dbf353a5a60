// The wgmma core (csrc/gemm_sm90.cuh) at one configuration, for
// tools/tc_variants.py, which builds this file once per configuration by
// replacing the two Config lines and the grid line below; not part of the
// kernel library. As written it is the port's configuration.
#include "gemm_sm90.cuh"

namespace {

namespace sm90 = l3ac::sm90;
using Bf16 = sm90::Bf16Config;
using Int8 = sm90::Int8Config;
constexpr bool kPersistent = true;

}  // namespace

// bf16 B: epi 1 snake(a w^T + b), 3 res + a w^T + b, on the TMA route.
extern "C" int l3ac_sm90v_bf16(const void* a, const void* w, const float* bias,
                               const float* alpha, const void* res, void* out, int M, int N,
                               int K, int epi, void* stream) {
  sm90::Params p{};
  p.a = static_cast<const sm90::bf16*>(a), p.b = static_cast<const sm90::bf16*>(w), p.bias = bias;
  p.alpha = alpha, p.res = static_cast<const sm90::bf16*>(res);
  p.out = static_cast<sm90::bf16*>(out), p.M = M, p.N = N, p.K = K;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return epi == 1 ? sm90::launch<Bf16, sm90::Epi::kSnake>(p, sm90::Route::kTma, nullptr, kPersistent, s)
                  : sm90::launch<Bf16, sm90::Epi::kResidual>(p, sm90::Route::kTma, nullptr, kPersistent, s);
}

// int8 B: y = x . bf16(q s)^T + bf16 bias; route 0 TMA, 1 cp.async.
extern "C" int l3ac_sm90v_int8(const void* x, const signed char* w_q, const float* scale,
                               const void* bias, void* out, int M, int N, int K, int route,
                               void* stream) {
  sm90::Params p{};
  p.a = static_cast<const sm90::bf16*>(x), p.b_q = w_q, p.scale = scale;
  p.bias16 = static_cast<const sm90::bf16*>(bias), p.out = static_cast<sm90::bf16*>(out);
  p.M = M, p.N = N, p.K = K;
  return sm90::launch<Int8, sm90::Epi::kBias>(p, static_cast<sm90::Route>(route), nullptr,
                                              kPersistent, static_cast<cudaStream_t>(stream));
}
