// Decoder up path as one kernel, for both activation layouts:
//   z = W x + b (1x1 conv Ci -> Co) -> linear upsample x s with torch's
//   align_corners=False edge rule -> ChannelNorm over Co (eps 1e-8 inside the
//   sqrt) -> affine
//
// Replaces l3ac_tpu/ops/pallas/upsample.py:up_fused_ct (body _kernel_ct,
// (B, C, T), with phase_split) and :up_fused (body _kernel, (B, T, C)). The
// input and output strides are arguments, so one kernel serves both, and the
// output may be the interleaved (.., T s, ..) array or s phase arrays.
//
// Bound on the H100: 2 Ci Co operations per input column for the conv, plus
// about 8 s Co for blend and norm, against 4 Ci bytes read and 4 s Co bytes
// written: the wide (B, T, C) stages (Ci = 512, 256) are near the fp32 rate,
// the narrow (B, C, T) stages on memory.
// Design: one block per (batch, tile of St input columns), 256 threads.
//   1. stage the tile and one column on each side in shared memory; outside
//      [0, T) that column is the edge column itself (the clamp of
//      align_corners=False), so no edge case remains below.
//   2. z for the St + 2 columns into shared memory, four output channels per
//      thread from float4 weight loads.
//   3. for each (column, phase) the mean and standard deviation over Co of the
//      blended value w_prev z[t-1] + w_cur z[t] + w_next z[t+1], recomputed
//      from z (three reads), never stored.
//   4. every output element blended, normalized and stored at its final
//      address: the interleave is the store address, not a pass. The element
//      order follows the output's contiguous axis, so stores coalesce.
// Phase weights are computed in double from (p + 0.5) / s - 0.5 and rounded
// to float, which gives the same float weights as the plain version.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNormEps = 1e-8f;
enum Order { kTimeFastest = 0, kChannelFastest = 1, kPhaseFastest = 2 };

struct Args {
  const float* x;
  const float* wt;      // (Ci, Co): the conv weight transposed
  const float* b;       // (Co)
  const float* norm_w;  // (Co) or null: no norm
  const float* norm_b;
  float* out;
  int Ci, Co, T, s, St;
  long long xB, xC, xT;      // input strides
  long long oB, oC, oT, oP;  // output strides of batch, channel, input column, phase
  int order;
};

struct Taps {
  float wp, wc, wn;
};

__device__ __forceinline__ Taps phase_taps(int p, int s) {
  const double d = (p + 0.5) / s - 0.5;
  if (d >= 0.0) return {0.0f, static_cast<float>(1.0 - d), static_cast<float>(d)};
  const double w = 1.0 + d;
  return {static_cast<float>(1.0 - w), static_cast<float>(w), 0.0f};
}

// the upsampled value of phase t at tile column j (z row zr, staged column j + 1)
__device__ __forceinline__ float blend(const float* zr, int j, const Taps& k) {
  return k.wp != 0.0f ? zr[j] * k.wp + zr[j + 1] * k.wc
                      : zr[j + 1] * k.wc + zr[j + 2] * k.wn;
}

__global__ void __launch_bounds__(kThreads) up_fused_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int Ci = a.Ci, Co = a.Co, s = a.s, St = a.St;
  const int XP = St + 2;
  float* xs = smem;               // (Ci, XP) staged input
  float* zs = xs + Ci * XP;       // (Co, XP) conv output
  float* mu = zs + Co * XP;       // (St * s) mean per (column, phase)
  float* sd = mu + St * s;        // (St * s) standard deviation
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const long long t0 = static_cast<long long>(blockIdx.x) * St;
  const float* xb = a.x + b * a.xB;

  // 1. stage columns t0 - 1 .. t0 + St, clamped into [0, T)
  for (int e = tid; e < Ci * XP; e += kThreads) {
    int c, i;
    if (a.xT == 1) { c = e / XP; i = e - c * XP; } else { i = e / Ci; c = e - i * Ci; }
    long long g = t0 - 1 + i;
    g = g < 0 ? 0 : (g >= a.T ? a.T - 1 : g);
    xs[c * XP + i] = xb[c * a.xC + g * a.xT];
  }
  __syncthreads();

  // 2. z = W x + b
  for (int e = tid; e < (Co / 4) * XP; e += kThreads) {
    const int oq = e / XP, i = e - oq * XP;
    const int o = 4 * oq;
    float4 acc = make_float4(a.b[o], a.b[o + 1], a.b[o + 2], a.b[o + 3]);
    for (int c = 0; c < Ci; ++c) {
      const float xv = xs[c * XP + i];
      const float4 wv = __ldg(reinterpret_cast<const float4*>(a.wt + static_cast<long long>(c) * Co + o));
      acc.x += wv.x * xv;
      acc.y += wv.y * xv;
      acc.z += wv.z * xv;
      acc.w += wv.w * xv;
    }
    zs[o * XP + i] = acc.x;
    zs[(o + 1) * XP + i] = acc.y;
    zs[(o + 2) * XP + i] = acc.z;
    zs[(o + 3) * XP + i] = acc.w;
  }
  __syncthreads();

  // 3. moments over Co per (column, phase)
  const bool norm = a.norm_w != nullptr;
  if (norm) {
    for (int e = tid; e < St * s; e += kThreads) {
      const int j = e / s, p = e - j * s;
      const Taps k = phase_taps(p, s);
      float sum = 0.0f;
      for (int o = 0; o < Co; ++o) sum += blend(zs + o * XP, j, k);
      const float u = sum / Co;
      float var = 0.0f;
      for (int o = 0; o < Co; ++o) {
        const float dv = blend(zs + o * XP, j, k) - u;
        var += dv * dv;
      }
      mu[e] = u;
      sd[e] = sqrtf(var / Co + kNormEps);
    }
    __syncthreads();
  }

  // 4. blend, normalize, store
  const int cols = St * s;
  for (int e = tid; e < Co * cols; e += kThreads) {
    int o, j, p;
    if (a.order == kChannelFastest) {
      o = e % Co;
      const int jj = e / Co;
      j = jj / s;
      p = jj - j * s;
    } else if (a.order == kPhaseFastest) {
      j = e % St;
      const int r = e / St;
      o = r % Co;
      p = r / Co;
    } else {
      const int jj = e % cols;
      o = e / cols;
      j = jj / s;
      p = jj - j * s;
    }
    const long long t = t0 + j;
    if (t >= a.T) continue;
    float y = blend(zs + o * XP, j, phase_taps(p, s));
    if (norm) {
      const int m = j * s + p;
      y = (y - mu[m]) / sd[m] * a.norm_w[o] + a.norm_b[o];
    }
    a.out[b * a.oB + o * a.oC + t * a.oT + p * a.oP] = y;
  }
}

}  // namespace

// x: (B, Ci, T) with (xC, xT) = (T, 1), or (B, T, Ci) with (xC, xT) = (1, Ci);
// wt: (Ci, Co) with Co a multiple of 4; b, norm_w, norm_b: (Co), norm null for
// none. out[b oB + o oC + t oT + p oP] receives phase p of input column t;
// order names the output's fastest axis (0 time, 1 channel, 2 time within a
// phase array). All fp32 and contiguous. Returns the CUDA error code.
extern "C" int l3ac_up_fused(const float* x, const float* wt, const float* b,
                             const float* norm_w, const float* norm_b, float* out,
                             int B, int Ci, int Co, int T, int s, long long xB,
                             long long xC, long long xT, long long oB, long long oC,
                             long long oT, long long oP, int order, void* stream) {
  if (B < 1 || Ci < 1 || Co < 4 || Co % 4 != 0 || T < 1 || s < 1 || order < 0 || order > 2)
    return cudaErrorInvalidValue;
  const int St = (Ci + Co <= 384) ? 64 : 32;
  const Args a{x, wt, b, norm_w, norm_b, out, Ci, Co, T, s, St,
               xB, xC, xT, oB, oC, oT, oP, order};
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(Ci + Co) * (St + 2) + 2 * static_cast<size_t>(St) * s);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(up_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(l3ac::ceil_div(T, St), B);
  up_fused_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
