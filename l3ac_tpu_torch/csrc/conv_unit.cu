// Residual ConvUnit as one fused kernel, for both activation layouts.
//
// Replaces l3ac_tpu/ops/pallas/conv_unit.py:conv_unit_ct (body _kernel_t,
// (B, C, T)) and :conv_unit (body _kernel, (B, T, C)). One kernel takes the
// batch, channel and time strides, so it serves both.
//   depthwise conv k, dilation d, zero pad -> ChannelNorm (eps 1e-8 inside the
//   sqrt) -> pw1 C->4C -> snake (or exact GELU) -> pw2 4C->C with GRN folded
//   into it by the caller (n = 1) -> + x
//
// Bound on the H100: 16 C^2 flops per column against 8 C bytes moved, so from
// C = 24 up the fp32 SIMT rate bounds it, not memory. What the TPU kernel
// keeps out of device memory, this one does too: the (S, 4C) hidden
// activations exist only chunk by chunk in shared memory.
// Design: one block per (batch, kS-column tile), 256 threads; kS = 64 up to
// C = 192 and 32 above, so that the (C, kS) tile, the staged input and the
// accumulators fit (C = 512: 64 KB + 16 KB + 80 KB of shared memory, 64
// accumulators per thread).
//   1. stage x with a halo of (k-1)d/2 columns in shared memory, zero outside
//      [0, T); depthwise conv and ChannelNorm into a (C, kS) tile.
//   2. walk the 4C hidden units in chunks of 4 G (G = 256 / (kS / 4) thread
//      groups): each thread computes a 4x4 (hidden x column) block of
//      h = W1 a + b1 from float4 loads, applies the activation and writes it
//      to shared memory; then each thread adds W2'[chunk] h into its own
//      (channel x 4 column) accumulators in registers.
//   3. add the folded bias and the residual and store.
// Products are SIMT fp32 FMAs; wgmma is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNarrowMaxC = 192;  // widest C at the 64-column tile
constexpr float kNormEps = 1e-8f;

// kS time columns per block; kGroups thread groups of kS / 4 column quads;
// kMC hidden units per chunk (one quad per group)
template <int kS> constexpr int kGroups = kThreads / (kS / 4);
template <int kS> constexpr int kMC = 4 * kGroups<kS>;

struct Args {
  const float* x;
  float* out;
  const float* dw_w;    // (C, K)
  const float* dw_b;    // (C)
  const float* norm_w;  // (C) or null
  const float* norm_b;  // (C) or null
  const float* w1t;     // (C, 4C): pw1 transposed
  const float* b1;      // (4C)
  const float* alpha;   // (4C) or null: exact GELU
  const float* w2f;     // (4C, C): pw2 transposed, GRN folded
  const float* b2f;     // (C): GRN folded
  int C, T, K, dil;
  long long sB, sC, sT;
};

template <int kS>
__host__ __device__ inline int x_stride(int K, int dil) {
  // staged row length, odd so that column-wise stores do not collide in banks
  return (kS + (K - 1) * dil) | 1;
}

// CPT: channels per thread group in the output product, ceil(C / kGroups)
template <int CPT, int kS>
__global__ void __launch_bounds__(kThreads) conv_unit_kernel(Args a) {
  constexpr int kG = kGroups<kS>;
  constexpr int kM = kMC<kS>;
  extern __shared__ __align__(16) float smem[];
  const int C = a.C, C4 = 4 * a.C;
  const int halo = (a.K - 1) * a.dil / 2;
  const int XW = kS + 2 * halo;
  const int XP = x_stride<kS>(a.K, a.dil);
  float* an = smem;                // (C, kS) normalized dw output
  float* hs = an + C * kS;         // (kM, kS) hidden chunk
  float* mu = hs + kM * kS;        // (kS)
  float* sd = mu + kS;             // (kS)
  float* xs = sd + kS;             // (C, XP) staged input

  const int b = blockIdx.y;
  const long long t0 = static_cast<long long>(blockIdx.x) * kS;
  const float* xb = a.x + b * a.sB;
  const int tid = threadIdx.x;

  // 1. stage x, coalesced along whichever axis is contiguous
  for (int e = tid; e < C * XW; e += kThreads) {
    int c, i;
    if (a.sT == 1) { c = e / XW; i = e - c * XW; } else { i = e / C; c = e - i * C; }
    const long long g = t0 - halo + i;
    xs[c * XP + i] = (g >= 0 && g < a.T) ? xb[c * a.sC + g * a.sT] : 0.0f;
  }
  __syncthreads();

  for (int e = tid; e < C * kS; e += kThreads) {
    const int c = e / kS, j = e - c * kS;
    const float* xr = xs + c * XP + j;
    const float* wr = a.dw_w + c * a.K;
    float acc = a.dw_b[c];
    for (int k = 0; k < a.K; ++k) acc += xr[k * a.dil] * wr[k];
    an[e] = acc;
  }
  __syncthreads();

  if (a.norm_w != nullptr) {
    if (tid < kS) {
      float s = 0.0f;
      for (int c = 0; c < C; ++c) s += an[c * kS + tid];
      const float u = s / C;
      float v = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float d = an[c * kS + tid] - u;
        v += d * d;
      }
      mu[tid] = u;
      sd[tid] = sqrtf(v / C + kNormEps);
    }
    __syncthreads();
    for (int e = tid; e < C * kS; e += kThreads) {
      const int c = e / kS, j = e - c * kS;
      an[e] = (an[e] - mu[j]) / sd[j] * a.norm_w[c] + a.norm_b[c];
    }
    __syncthreads();
  }

  // 2. hidden chunks
  const int jq = tid % (kS / 4);   // column quad: columns 4 jq .. 4 jq + 3
  const int grp = tid / (kS / 4);  // 0 .. kG - 1
  float acc[CPT][4];
#pragma unroll
  for (int q = 0; q < CPT; ++q)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[q][jj] = 0.0f;

  for (int m0 = 0; m0 < C4; m0 += kM) {
    const int m = m0 + 4 * grp;  // this thread's hidden quad
    float h[4][4];
    if (m < C4) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const float bv = a.b1[m + mi];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) h[mi][jj] = bv;
      }
      for (int c = 0; c < C; ++c) {
        const float4 av = *reinterpret_cast<const float4*>(an + c * kS + 4 * jq);
        const float4 wv = __ldg(reinterpret_cast<const float4*>(a.w1t + static_cast<long long>(c) * C4 + m));
        const float w[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          h[mi][0] += w[mi] * av.x;
          h[mi][1] += w[mi] * av.y;
          h[mi][2] += w[mi] * av.z;
          h[mi][3] += w[mi] * av.w;
        }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        if (a.alpha != nullptr) {
          const float al = a.alpha[m + mi];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) h[mi][jj] = l3ac::snake(h[mi][jj], al);
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) h[mi][jj] = l3ac::gelu(h[mi][jj]);
        }
      }
    } else {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) h[mi][jj] = 0.0f;
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      *reinterpret_cast<float4*>(hs + (4 * grp + mi) * kS + 4 * jq) =
          make_float4(h[mi][0], h[mi][1], h[mi][2], h[mi][3]);
    __syncthreads();

    const int mlen = min(kM, C4 - m0);
    for (int mm = 0; mm < mlen; ++mm) {
      const float4 hv = *reinterpret_cast<const float4*>(hs + mm * kS + 4 * jq);
      const float* wr = a.w2f + static_cast<long long>(m0 + mm) * C;
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int c = grp + kG * q;
        if (c < C) {
          const float w = __ldg(wr + c);
          acc[q][0] += w * hv.x;
          acc[q][1] += w * hv.y;
          acc[q][2] += w * hv.z;
          acc[q][3] += w * hv.w;
        }
      }
    }
    __syncthreads();  // hs is rewritten by the next chunk
  }

  // 3. folded bias + residual
  float* ob = a.out + b * a.sB;
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const int c = grp + kG * q;
    if (c >= C) continue;
    const float bc = a.b2f[c];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * jq + jj;
      const long long t = t0 + j;
      if (t < a.T) ob[c * a.sC + t * a.sT] = xs[c * XP + halo + j] + (acc[q][jj] + bc);
    }
  }
}

template <int CPT, int kS>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(a.C) * kS + kMC<kS> * kS + 2 * kS +
       static_cast<size_t>(a.C) * x_stride<kS>(a.K, a.dil));
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv_unit_kernel<CPT, kS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(l3ac::ceil_div(a.T, kS), B);
  conv_unit_kernel<CPT, kS><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x, out: (B, C, T) with (sC, sT) = (T, 1), or (B, T, C) with (sC, sT) = (1, C);
// dw_w: (C, K); w1t: (C, 4C); w2f: (4C, C) with GRN folded; b2f: (C).
// norm_w/norm_b null: no ChannelNorm; alpha null: exact GELU instead of snake.
// All fp32 and contiguous, out not aliasing x. Returns the CUDA error code.
extern "C" int l3ac_conv_unit(const float* x, float* out, const float* dw_w,
                              const float* dw_b, const float* norm_w, const float* norm_b,
                              const float* w1t, const float* b1, const float* alpha,
                              const float* w2f, const float* b2f, int B, int C, int T,
                              int K, int dil, long long sB, long long sC, long long sT,
                              void* stream) {
  if (B < 1 || C < 1 || T < 1 || K < 1 || K % 2 == 0 || dil < 1) return cudaErrorInvalidValue;
  const Args a{x, out, dw_w, dw_b, norm_w, norm_b, w1t, b1, alpha, w2f, b2f,
               C, T, K, dil, sB, sC, sT};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= kNarrowMaxC) {  // 64-column tile, 16 groups
    switch ((C + kGroups<64> - 1) / kGroups<64>) {
      case 1: return launch<1, 64>(a, B, s);
      case 2: return launch<2, 64>(a, B, s);
      case 3: return launch<3, 64>(a, B, s);
      case 4: return launch<4, 64>(a, B, s);
      case 5: return launch<5, 64>(a, B, s);
      case 6: return launch<6, 64>(a, B, s);
      case 7: return launch<7, 64>(a, B, s);
      case 8: return launch<8, 64>(a, B, s);
      case 9: return launch<9, 64>(a, B, s);
      case 10: return launch<10, 64>(a, B, s);
      case 11: return launch<11, 64>(a, B, s);
      case 12: return launch<12, 64>(a, B, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch ((C + kGroups<32> - 1) / kGroups<32>) {  // 32-column tile, 32 groups
    case 7: return launch<7, 32>(a, B, s);
    case 8: return launch<8, 32>(a, B, s);
    case 9: return launch<9, 32>(a, B, s);
    case 10: return launch<10, 32>(a, B, s);
    case 11: return launch<11, 32>(a, B, s);
    case 12: return launch<12, 32>(a, B, s);
    case 13: return launch<13, 32>(a, B, s);
    case 14: return launch<14, 32>(a, B, s);
    case 15: return launch<15, 32>(a, B, s);
    case 16: return launch<16, 32>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}
