// A conv_unit_ct-like chain on bf16 (B, C, T), stage by stage: the bisection
// of where a fused ConvUnit's time goes.
//
// Replaces the TPU probe tools/bisect_kernel.py (pallas_call :91, body
// _kernel :33). Seven modes, each a template instance that holds only the
// stages it runs, so its time measures exactly those stages:
//   copy       out = x
//   halo_only  stage x with 3 columns on each side in shared memory, out = x
//   dw         depthwise conv k7 with zero pads at every multiple of tile
//   norm       ChannelNorm of x (no affine; two-pass variance, eps 1e-8
//              inside the sqrt)
//   mm         x + W2 bf16(W1 bf16(x))
//   dw_mm      a = dw(x); a + W2 bf16(W1 bf16(a))
//   full       a = norm(dw(x)), zero pads only at 0 and T; h = W1 bf16(a);
//              a + W2 bf16(h + sin(h)^2)
// Hold to the probe: the taps of dw / dw_mm see zeros at every multiple of
// tile (its tile-local jnp.pad, :45-46); only halo_only and full read the
// neighbouring tiles (:39-44). tile is an argument, not the kernel's own
// column tile, which never shows in the result. Depthwise taps are added in
// order k = 0..6 from 0 in fp32; product operands are rounded to bf16 and
// summed in fp32; the output is rounded to bf16 (round to nearest even).
//
// Bound on the H100: copy .. norm by bytes (4 bytes per element moved, a few
// fp32 operations); the products 16 C^2 operations per column, which bf16
// tensor cores would bound at C = 96 and memory at C <= 48. Design: one block
// per (batch, 64-column tile), 256 threads, as csrc/conv_unit.cu: the staged
// input, the chain's fp32 activation and its bf16-rounded copy in shared
// memory, the (4C, 64) hidden activation one 64-row chunk at a time. The
// products are SIMT fp32 FMAs on bf16-rounded operands (each product exact,
// so the order of the sums is the only difference from the plain version);
// weights are read from device memory through the read-only cache. wgmma and
// TMA are later work.
#include "common.cuh"

namespace {

enum Mode { kCopy = 0, kHaloOnly, kDw, kNorm, kMm, kDwMm, kFull };

constexpr int kThreads = 256;
constexpr int kS = 64;                        // columns per block
constexpr int kQuads = kS / 4;                // column quads per block
constexpr int kGroups = kThreads / kQuads;    // thread groups of the products
constexpr int kM = 4 * kGroups;               // hidden units per chunk
constexpr int kHalo = 3, kTaps = 7;
constexpr int kXP = (kS + 2 * kHalo) | 1;     // staged row length, odd
constexpr float kNormEps = 1e-8f;

template <int kMode> constexpr bool kStagesHalo = kMode == kHaloOnly || kMode == kDw ||
                                                  kMode == kDwMm || kMode == kFull;
template <int kMode> constexpr bool kDepthwise = kMode == kDw || kMode == kDwMm || kMode == kFull;
template <int kMode> constexpr bool kNormed = kMode == kNorm || kMode == kFull;
template <int kMode> constexpr bool kProducts = kMode == kMm || kMode == kDwMm || kMode == kFull;

struct Args {
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  const __nv_bfloat16* dww;  // (C, 7)
  const __nv_bfloat16* w1t;  // (4C, C)
  const __nv_bfloat16* w2t;  // (C, 4C)
  int C, T, tile;
};

// shared memory, in floats: staged input, activation, its bf16 copy, hidden
// chunk, column moments
struct Layout {
  int xs, acc, ab, hs, mom;
  __host__ __device__ int total() const { return xs + acc + ab + hs + mom; }
};

template <int kMode>
__host__ __device__ Layout layout(int C) {
  return {kStagesHalo<kMode> ? (C * kXP + 3) / 4 * 4 : 0,  // keep the float4 arrays aligned
          (kMode != kCopy && kMode != kHaloOnly && kMode != kDw) ? C * kS : 0,
          kProducts<kMode> ? C * kS : 0, kProducts<kMode> ? kM * kS : 0,
          kNormed<kMode> ? 2 * kS : 0};
}

// CPT: output channels per thread group in the second product, >= C / kGroups
template <int kMode, int CPT>
__global__ void __launch_bounds__(kThreads) stages_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int C = a.C, T = a.T, tid = threadIdx.x;
  const int t0 = blockIdx.x * kS;
  const int ncol = min(kS, T - t0);
  const long long base = static_cast<long long>(blockIdx.y) * C * T + t0;
  const __nv_bfloat16* xb = a.x + base;  // column t0 of row 0
  __nv_bfloat16* ob = a.out + base;

  if constexpr (kMode == kCopy) {
    for (int e = tid; e < C * kS; e += kThreads) {
      const int c = e / kS, j = e - c * kS;
      if (j < ncol) ob[static_cast<long long>(c) * T + j] = xb[static_cast<long long>(c) * T + j];
    }
    return;
  }

  const Layout L = layout<kMode>(C);
  float* xs = smem;         // (C, kXP): columns t0 - 3 .. t0 + kS + 2, zero outside [0, T)
  float* acc = xs + L.xs;   // (C, kS): the chain's activation
  float* ab = acc + L.acc;  // (C, kS): acc rounded to bf16
  float* hs = ab + L.ab;    // (kM, kS): a hidden chunk, rounded to bf16
  float* mu = hs + L.hs;    // (kS) column means
  float* sd = mu + kS;      // (kS) column standard deviations

  // 1. stage x: with the halo where a mode reads it, else straight into acc
  if constexpr (kStagesHalo<kMode>) {
    constexpr int kW = kS + 2 * kHalo;
    for (int e = tid; e < C * kW; e += kThreads) {
      const int c = e / kW, i = e - c * kW;
      const int g = t0 - kHalo + i;
      xs[c * kXP + i] = (g >= 0 && g < T)
          ? l3ac::load_bf16(xb + static_cast<long long>(c) * T + (i - kHalo)) : 0.0f;
    }
  } else {
    for (int e = tid; e < C * kS; e += kThreads) {
      const int c = e / kS, j = e - c * kS;
      acc[e] = j < ncol ? l3ac::load_bf16(xb + static_cast<long long>(c) * T + j) : 0.0f;
    }
  }
  __syncthreads();

  if constexpr (kMode == kHaloOnly) {
    for (int e = tid; e < C * kS; e += kThreads) {
      const int c = e / kS, j = e - c * kS;
      if (j < ncol) l3ac::store_bf16(ob + static_cast<long long>(c) * T + j, xs[c * kXP + kHalo + j]);
    }
    return;
  }

  // 2. depthwise conv; a tap outside [lo, hi) reads zero: the column's tile
  //    (dw, dw_mm) or the sequence (full)
  if constexpr (kDepthwise<kMode>) {
    for (int e = tid; e < C * kS; e += kThreads) {
      const int c = e / kS, j = e - c * kS;
      const int t = t0 + j;
      const int lo = kMode == kFull ? 0 : t / a.tile * a.tile;
      const int hi = kMode == kFull ? T : lo + a.tile;
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const int u = t + k - kHalo;
        const float v = (u >= lo && u < hi) ? xs[c * kXP + j + k] : 0.0f;
        s = __fadd_rn(s, __fmul_rn(v, l3ac::load_bf16(a.dww + c * kTaps + k)));
      }
      if constexpr (kMode == kDw) {
        if (j < ncol) l3ac::store_bf16(ob + static_cast<long long>(c) * T + j, s);
      } else {
        acc[e] = s;
      }
    }
    if constexpr (kMode == kDw) return;
    __syncthreads();
  }

  // 3. ChannelNorm without affine
  if constexpr (kNormed<kMode>) {
    if (tid < kS) {
      float s = 0.0f;
      for (int c = 0; c < C; ++c) s += acc[c * kS + tid];
      const float u = s / C;
      float v = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float d = acc[c * kS + tid] - u;
        v += d * d;
      }
      mu[tid] = u;
      sd[tid] = sqrtf(v / C + kNormEps);
    }
    __syncthreads();
    for (int e = tid; e < C * kS; e += kThreads) {
      const int c = e / kS, j = e - c * kS;
      const float y = (acc[e] - mu[j]) / sd[j];
      if constexpr (kMode == kNorm) {
        if (j < ncol) l3ac::store_bf16(ob + static_cast<long long>(c) * T + j, y);
      } else {
        acc[e] = y;
      }
    }
    if constexpr (kMode == kNorm) return;
    __syncthreads();
  }

  // 4. acc + W2 bf16(act(W1 bf16(acc))), the hidden units in chunks of kM
  if constexpr (kProducts<kMode>) {
    const int C4 = 4 * C;
    for (int e = tid; e < C * kS; e += kThreads) ab[e] = l3ac::round_bf16(acc[e]);
    __syncthreads();
    const int jq = tid % kQuads;  // columns 4 jq .. 4 jq + 3
    const int grp = tid / kQuads;
    float y[CPT][4];
#pragma unroll
    for (int q = 0; q < CPT; ++q)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) y[q][jj] = 0.0f;

    for (int m0 = 0; m0 < C4; m0 += kM) {
      const int m = m0 + 4 * grp;  // this thread's hidden quad
      float h[4][4] = {};
      if (m < C4) {
        for (int c = 0; c < C; ++c) {
          const float4 av = *reinterpret_cast<const float4*>(ab + c * kS + 4 * jq);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            const float w = l3ac::load_bf16(a.w1t + (m + mi) * C + c);
            h[mi][0] += w * av.x;
            h[mi][1] += w * av.y;
            h[mi][2] += w * av.z;
            h[mi][3] += w * av.w;
          }
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            float v = h[mi][jj];
            if constexpr (kMode == kFull) {
              const float sv = sinf(v);
              v = __fadd_rn(v, __fmul_rn(sv, sv));
            }
            h[mi][jj] = l3ac::round_bf16(v);
          }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        *reinterpret_cast<float4*>(hs + (4 * grp + mi) * kS + 4 * jq) =
            make_float4(h[mi][0], h[mi][1], h[mi][2], h[mi][3]);
      __syncthreads();

      const int mlen = min(kM, C4 - m0);
      for (int mm = 0; mm < mlen; ++mm) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + mm * kS + 4 * jq);
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          const int c = grp + kGroups * q;
          if (c < C) {
            const float w = l3ac::load_bf16(a.w2t + c * C4 + m0 + mm);
            y[q][0] += w * hv.x;
            y[q][1] += w * hv.y;
            y[q][2] += w * hv.z;
            y[q][3] += w * hv.w;
          }
        }
      }
      __syncthreads();  // hs is rewritten by the next chunk
    }

#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int c = grp + kGroups * q;
      if (c >= C) continue;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * jq + jj;
        if (j < ncol)
          l3ac::store_bf16(ob + static_cast<long long>(c) * T + j, acc[c * kS + j] + y[q][jj]);
      }
    }
  }
}

template <int kMode, int CPT>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(layout<kMode>(a.C).total());
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(stages_kernel<kMode, CPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(l3ac::ceil_div(a.T, kS), B);
  stages_kernel<kMode, CPT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_products(const Args& a, int B, cudaStream_t stream) {
  const int cpt = (a.C + kGroups - 1) / kGroups;
  if (cpt <= 1) return launch<kMode, 1>(a, B, stream);
  if (cpt <= 2) return launch<kMode, 2>(a, B, stream);
  if (cpt <= 3) return launch<kMode, 3>(a, B, stream);
  if (cpt <= 4) return launch<kMode, 4>(a, B, stream);
  if (cpt <= 6) return launch<kMode, 6>(a, B, stream);
  if (cpt <= 8) return launch<kMode, 8>(a, B, stream);
  if (cpt <= 12) return launch<kMode, 12>(a, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, out: (B, C, T) bf16, contiguous, out not aliasing x; dww (C, 7), w1t
// (4C, C), w2t (C, 4C) bf16, contiguous; T a multiple of tile; C <= 192;
// mode 0..6 in the order of the enum above. Returns the CUDA error code.
extern "C" int l3ac_conv_unit_stages(const void* x, void* out, const void* dww,
                                     const void* w1t, const void* w2t, int B, int C,
                                     int T, int tile, int mode, void* stream) {
  if (B < 1 || C < 1 || C > 12 * kGroups || T < 1 || tile < 1 || T % tile != 0)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
               static_cast<const __nv_bfloat16*>(dww), static_cast<const __nv_bfloat16*>(w1t),
               static_cast<const __nv_bfloat16*>(w2t), C, T, tile};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kCopy: return launch<kCopy, 1>(a, B, s);
    case kHaloOnly: return launch<kHaloOnly, 1>(a, B, s);
    case kDw: return launch<kDw, 1>(a, B, s);
    case kNorm: return launch<kNorm, 1>(a, B, s);
    case kMm: return launch_products<kMm>(a, B, s);
    case kDwMm: return launch_products<kDwMm>(a, B, s);
    case kFull: return launch_products<kFull>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}
