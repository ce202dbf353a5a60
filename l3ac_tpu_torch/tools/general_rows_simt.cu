// The general routes' former row passes, kept as the yardstick of
// csrc/general_rows.cu: built only by tools/rows_variants.py, never by the
// kernel library. Each block takes one output row: dw_norm one (batch, time)
// row of the depthwise conv + ChannelNorm, looping over C in three passes
// (mean, variance, output) with the conv recomputed in each; up_blend_norm
// one output row (b, t, p) of the up path's blend + ChannelNorm, z's rows
// read in each of its three passes and stored at the interleaved address
// element by element. Each statistic is a block-wide tree in shared memory.
// The entry points are those of csrc/general_rows.cu.
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ld(const void* p, long long i, int bf) {
  return bf ? __bfloat162float(static_cast<const bf16*>(p)[i]) : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, long long i, float v, int bf) {
  if (bf)
    static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

constexpr int kRowThreads = 256;

// the sum of v over the block (every thread gets it); red: kRowThreads floats
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kRowThreads / 2; s > 0; s >>= 1) {
    if (static_cast<int>(threadIdx.x) < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();
  return total;
}

// ------------------------------------------------------------- dw_norm

struct DwArgs {
  const void* x;  // x(b, t, c) = x[b sb + t st + c sc]
  long long sb, st, sc;
  int x_bf, T, C, K, dil;
  const float* dw;    // (C, K)
  const float* dw_b;  // (C,)
  const float* nw;    // (C,) ChannelNorm, or null
  const float* nb;
  void* out;  // (B T, C) contiguous
  int o_bf;
};

__device__ __forceinline__ float dw_at(const DwArgs& a, int b, int t, int c) {
  float s = a.dw_b[c];
  const int pad = (a.K - 1) * a.dil / 2;
  const long long base = static_cast<long long>(b) * a.sb + c * a.sc;
  for (int k = 0; k < a.K; ++k) {
    const int tt = t - pad + k * a.dil;
    if (tt >= 0 && tt < a.T) s = fmaf(a.dw[c * a.K + k], ld(a.x, base + tt * a.st, a.x_bf), s);
  }
  return s;
}

__global__ void __launch_bounds__(kRowThreads) dw_norm_kernel(DwArgs a) {
  __shared__ float red[kRowThreads];
  const long long m = blockIdx.x;
  const int b = static_cast<int>(m / a.T), t = static_cast<int>(m % a.T);
  if (!a.nw) {
    for (int c = threadIdx.x; c < a.C; c += kRowThreads)
      st(a.out, m * a.C + c, dw_at(a, b, t, c), a.o_bf);
    return;
  }
  float s = 0.0f;
  for (int c = threadIdx.x; c < a.C; c += kRowThreads) s += dw_at(a, b, t, c);
  const float u = block_sum(s, red) / a.C;
  float q = 0.0f;
  for (int c = threadIdx.x; c < a.C; c += kRowThreads) {
    const float d = dw_at(a, b, t, c) - u;
    q = fmaf(d, d, q);
  }
  const float den = sqrtf(block_sum(q, red) / a.C + l3ac::kSnakeEps);
  for (int c = threadIdx.x; c < a.C; c += kRowThreads) {
    const float xn = (dw_at(a, b, t, c) - u) / den;
    st(a.out, m * a.C + c, fmaf(a.nw[c], xn, a.nb[c]), a.o_bf);
  }
}

// ------------------------------------------------------- up_blend_norm

struct UpArgs {
  const float* z;     // (B T, Co) fp32: the 1x1 conv with its bias
  const float* taps;  // (s, 3): each phase's (prev, cur, next) weights
  const float* nw;    // (Co,) ChannelNorm, or null
  const float* nb;
  void* out;          // out(b, c, t, p) = out[b ob + c oc + t ot + p op]
  long long ob, oc, ot, op;
  int T, Co, s, o_bf;
};

// phase p of row t, channel c: x_prev wp + x wc, or x wc + x_next wn (the
// plain version's order, each product and the sum rounded once)
__device__ __forceinline__ float blend(const UpArgs& a, long long r, int t, int p, int c) {
  const float* z = a.z + r * a.Co + c;
  if (a.s == 1) return *z;
  const float wp = a.taps[3 * p], wc = a.taps[3 * p + 1], wn = a.taps[3 * p + 2];
  if (wp != 0.0f) {
    const float prev = t > 0 ? z[-a.Co] : z[0];
    return __fadd_rn(__fmul_rn(prev, wp), __fmul_rn(z[0], wc));
  }
  const float next = t + 1 < a.T ? z[a.Co] : z[0];
  return __fadd_rn(__fmul_rn(z[0], wc), __fmul_rn(next, wn));
}

__global__ void __launch_bounds__(kRowThreads) up_blend_norm_kernel(UpArgs a) {
  __shared__ float red[kRowThreads];
  const long long row = blockIdx.x;  // (b, t, p)
  const int p = static_cast<int>(row % a.s);
  const long long r = row / a.s;     // z row (b, t)
  const int t = static_cast<int>(r % a.T);
  const long long b = r / a.T;
  const long long o = b * a.ob + t * a.ot + p * a.op;
  if (!a.nw) {
    for (int c = threadIdx.x; c < a.Co; c += kRowThreads)
      st(a.out, o + c * a.oc, blend(a, r, t, p, c), a.o_bf);
    return;
  }
  float s = 0.0f;
  for (int c = threadIdx.x; c < a.Co; c += kRowThreads) s += blend(a, r, t, p, c);
  const float u = block_sum(s, red) / a.Co;
  float q = 0.0f;
  for (int c = threadIdx.x; c < a.Co; c += kRowThreads) {
    const float d = blend(a, r, t, p, c) - u;
    q = fmaf(d, d, q);
  }
  const float den = sqrtf(block_sum(q, red) / a.Co + l3ac::kSnakeEps);
  for (int c = threadIdx.x; c < a.Co; c += kRowThreads) {
    const float xn = (blend(a, r, t, p, c) - u) / den;
    st(a.out, o + c * a.oc, fmaf(a.nw[c], xn, a.nb[c]), a.o_bf);
  }
}

}  // namespace

// The ConvUnit's depthwise conv + ChannelNorm into a (B T, C) buffer; see DwArgs.
extern "C" int l3ac_general_dw_norm(const void* x, long long sb, long long st_, long long sc,
                                    int x_bf, int B, int T, int C, int K, int dil,
                                    const float* dw, const float* dw_b, const float* nw,
                                    const float* nb, void* out, int o_bf, void* stream) {
  if (B < 1 || T < 1 || C < 1 || K < 1 || K % 2 == 0 || (nw == nullptr) != (nb == nullptr) ||
      static_cast<long long>(B) * T > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const DwArgs a{x, sb, st_, sc, x_bf, T, C, K, dil, dw, dw_b, nw, nb, out, o_bf};
  dw_norm_kernel<<<B * T, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// The up path's blend + ChannelNorm from z = W x + b; see UpArgs.
extern "C" int l3ac_general_up(const float* z, const float* taps, const float* nw,
                               const float* nb, void* out, long long ob, long long oc,
                               long long ot, long long op, int B, int T, int Co, int s, int o_bf,
                               void* stream) {
  if (B < 1 || T < 1 || Co < 1 || s < 1 || (nw == nullptr) != (nb == nullptr) ||
      static_cast<long long>(B) * T * s > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const UpArgs a{z, taps, nw, nb, out, ob, oc, ot, op, T, Co, s, o_bf};
  up_blend_norm_kernel<<<B * T * s, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
