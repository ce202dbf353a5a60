// A conv_unit_ct-like chain on bf16 (B, C, T), stage by stage: the bisection
// of where a fused ConvUnit's time goes.
//
// Replaces the TPU probe tools/bisect_kernel.py (pallas_call :91, body
// _kernel :33). Seven modes, each its own template instance that holds only
// the stages it runs, so its time measures exactly those stages:
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
// fp32 operations); the products 16 C^2 operations per column, by the bf16
// tensor cores at C = 96 and by bytes at C <= 48.
// Design:
//   copy: 16-byte loads and stores over the whole tensor.
//   halo_only, dw, norm: one block per (batch row, kS = 128 columns); x (with
//   a 16-byte piece of halo on each side where the mode reads one) staged by
//   cp.async, 16-byte pieces along T, zero outside [0, T); the result goes
//   out as 16-byte rows.
//   mm, dw_mm, full: the structure of the codec's narrow ConvUnit
//   (conv_unit_narrow.cu) on bf16 operands: the chain's fp32 activation in a
//   (C, kS) tile, its bf16 copy transposed as the (kS, C) K-major A of pw1;
//   the 4C hidden units in chunks of 32, W1's rows and W2's columns through a
//   2-stage cp.async ring; per warp (16 time rows) pw1 on one bf16 mma pass
//   (m16n8k16), the activation, the bf16-rounded chunk into the warp's own
//   shared buffer, and pw2 of the chunk added into its (16, C) sums. The
//   operands are bf16 already and the products are summed in fp32, so one
//   pass is the probe's exact function; each K step of 32 sums into a fresh
//   accumulator, as in tc_gemm.cuh. K and N are zero-filled in shared memory.
// 16-byte accesses need T % 8 == 0 (every probe shape); other T take 2-byte
// ones, as do the weights at C % 8 != 0.
#include "common.cuh"
#include "ptx.cuh"

namespace {

namespace ptx = l3ac::ptx;
using bf16 = __nv_bfloat16;

enum Mode { kCopy = 0, kHaloOnly, kDw, kNorm, kMm, kDwMm, kFull };

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kS = 16 * kWarps;  // columns per block: one m16 tile per warp
constexpr int kHalo = 3, kTaps = 7;
constexpr int kPad = 8;          // staged halo, one 16-byte piece (>= kHalo) per side
constexpr int kNC = 32;          // hidden units per chunk: one K step of pw2
constexpr int kStages = 2;       // weight-chunk ring
constexpr int kHS = kNC + 8;     // bf16 row stride of a hidden chunk and of W2's tile (20 words)
constexpr int kACS = kS + 4;     // fp32 row stride of the activation tile
constexpr float kNormEps = 1e-8f;

template <int kMode> constexpr bool kHaloed = kMode == kHaloOnly || kMode == kDw ||
                                              kMode == kDwMm || kMode == kFull;
template <int kMode> constexpr int kXW = kS + (kHaloed<kMode> ? 2 * kPad : 0);  // staged columns

struct Args {
  const bf16* x;
  bf16* out;
  const bf16* dww;  // (C, 7)
  const bf16* w1t;  // (4C, C)
  const bf16* w2t;  // (C, 4C)
  int C, T, tile;
  int vec;          // T % 8 == 0, x and out 16-byte aligned: 16-byte pieces along T
  int wvec;         // C % 8 == 0, weights 16-byte aligned
};

__device__ __forceinline__ float bf(const bf16* p) { return l3ac::load_bf16(p); }

// x columns [t0 - pad, t0 + kS + pad) of every channel into xs (C, w), zero
// outside [0, T): 16-byte cp.async pieces (vec), else 2-byte loads
template <int kW>
__device__ __forceinline__ void stage_x(bf16* xs, const bf16* xb, const Args& a, int t0) {
  constexpr int pad = (kW - kS) / 2;
  if (a.vec) {
    for (int e = threadIdx.x; e < a.C * (kW / 8); e += kThreads) {
      const int c = e / (kW / 8), p = e - c * (kW / 8), t = t0 - pad + 8 * p;
      const bool ok = t >= 0 && t < a.T;
      ptx::cp_async16(xs + c * kW + 8 * p, ok ? xb + static_cast<long long>(c) * a.T + t : a.x,
                      ok ? 16 : 0);
    }
    ptx::cp_async_commit();
    ptx::cp_async_wait<0>();
  } else {
    for (int e = threadIdx.x; e < a.C * kW; e += kThreads) {
      const int c = e / kW, i = e - c * kW, t = t0 - pad + i;
      xs[c * kW + i] = (t >= 0 && t < a.T) ? xb[static_cast<long long>(c) * a.T + t]
                                           : __float2bfloat16_rn(0.0f);
    }
  }
}

// rows of a bf16 (C, kS) result, from src (row stride w, first column off),
// to out columns [t0, t0 + kS) that lie before T
__device__ __forceinline__ void store_rows(bf16* ob, const bf16* src, int w, int off,
                                           const Args& a, int t0) {
  if (a.vec) {
    for (int e = threadIdx.x; e < a.C * (kS / 8); e += kThreads) {
      const int c = e / (kS / 8), p = e - c * (kS / 8), t = t0 + 8 * p;
      if (t < a.T)
        *reinterpret_cast<uint4*>(ob + static_cast<long long>(c) * a.T + t) =
            *reinterpret_cast<const uint4*>(src + c * w + off + 8 * p);
    }
  } else {
    for (int e = threadIdx.x; e < a.C * kS; e += kThreads) {
      const int c = e / kS, j = e - c * kS;
      if (t0 + j < a.T) ob[static_cast<long long>(c) * a.T + t0 + j] = src[c * w + off + j];
    }
  }
}

// depthwise k7 of column j, channel c, from the staged row (kPad columns of
// halo): taps outside [lo, hi) read zero; in order from 0, fp32
__device__ __forceinline__ float depthwise(const bf16* xr, const bf16* wr, int t, int lo, int hi) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const int u = t + k - kHalo;
    const float v = (u >= lo && u < hi) ? bf(xr + k - kHalo) : 0.0f;
    s = __fadd_rn(s, __fmul_rn(v, bf(wr + k)));
  }
  return s;
}

__global__ void __launch_bounds__(kThreads) copy_kernel(const Args a, long long n) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (a.vec) {
    for (; i < n / 8; i += step)
      reinterpret_cast<uint4*>(a.out)[i] = reinterpret_cast<const uint4*>(a.x)[i];
  } else {
    for (; i < n; i += step) a.out[i] = a.x[i];
  }
}

// halo_only, dw, norm
template <int kMode>
__global__ void __launch_bounds__(kThreads) stream_kernel(const Args a) {
  constexpr int kW = kXW<kMode>;
  extern __shared__ __align__(16) float smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);                   // (C, kW)
  const int C = a.C, T = a.T, tid = threadIdx.x, t0 = blockIdx.x * kS;
  const long long base = static_cast<long long>(blockIdx.y) * C * T;
  stage_x<kW>(xs, a.x + base, a, t0);
  __syncthreads();

  if constexpr (kMode == kHaloOnly) {
    store_rows(a.out + base, xs, kW, kPad, a, t0);
  } else if constexpr (kMode == kDw) {
    bf16* os = xs + C * kW;                                   // (C, kS)
    for (int e = tid; e < C * kS; e += kThreads) {
      const int c = e / kS, j = e - c * kS, t = t0 + j;
      const int lo = t / a.tile * a.tile;
      os[e] = __float2bfloat16_rn(
          depthwise(xs + c * kW + kPad + j, a.dww + c * kTaps, t, lo, lo + a.tile));
    }
    __syncthreads();
    store_rows(a.out + base, os, kS, 0, a, t0);
  } else {  // kNorm: moments per column, then the tile normalized in place
    float* mu = reinterpret_cast<float*>(xs + C * kW);
    float* sd = mu + kS;
    if (tid < kS) {
      float s = 0.0f;
      for (int c = 0; c < C; ++c) s += bf(xs + c * kW + tid);
      const float u = s / C;
      float v = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float d = bf(xs + c * kW + tid) - u;
        v += d * d;
      }
      mu[tid] = u;
      sd[tid] = sqrtf(v / C + kNormEps);
    }
    __syncthreads();
    for (int e = tid; e < C * kS; e += kThreads) {
      const int j = e % kS;
      xs[e] = __float2bfloat16_rn((bf(xs + e) - mu[j]) / sd[j]);
    }
    __syncthreads();
    store_rows(a.out + base, xs, kW, 0, a, t0);
  }
}

// shared-memory regions of the product modes, in bytes
struct ChainLayout {
  int kp;      // K of pw1 zero-filled to k16 steps
  int as;      // bf16 row stride of the A tile and W1's tile: kp + 8 (4 mod 8 words)
  int acc;     // (C, kACS) fp32 activation, then the output
  int a, w1, w2, stage, hb, xs;
  int total;
  __host__ __device__ ChainLayout(int C, int pairs, int xw) {
    kp = (C + 15) / 16 * 16;
    as = kp + 8;
    acc = 4 * C * kACS;
    a = 2 * kS * as;
    w1 = 2 * kNC * as;
    w2 = 2 * 16 * pairs * kHS;
    stage = w1 + w2;
    hb = 2 * kWarps * 16 * kHS;
    xs = 2 * C * xw;
    const int run = a + kStages * stage + hb;  // the staged x is dead before these
    total = acc + (run > xs ? run : xs);
  }
};

// mm, dw_mm, full; kNT >= ceil(C / 8) n8 tiles of pw2 (an even count)
template <int kMode, int kNT>
__global__ void __launch_bounds__(kThreads, kNT <= 6 ? 2 : 1) chain_kernel(const Args a) {
  constexpr int kW = kXW<kMode>, kPairs = kNT / 2;
  extern __shared__ __align__(16) float smem[];
  const int C = a.C, T = a.T, C4 = 4 * C, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * kS, nt2 = (C + 7) / 8;
  const ChainLayout L(C, kPairs, kW);
  char* sm = reinterpret_cast<char*>(smem);
  float* acc = reinterpret_cast<float*>(sm);                 // (C, kACS)
  bf16* xs = reinterpret_cast<bf16*>(sm + L.acc);            // (C, kW), before the products
  bf16* sa = reinterpret_cast<bf16*>(sm + L.acc);            // (kS, as)
  char* ring = sm + L.acc + L.a;
  bf16* hb = reinterpret_cast<bf16*>(ring + kStages * L.stage) + warp * 16 * kHS;
  const long long base = static_cast<long long>(blockIdx.y) * C * T;
  const int chunks = (C4 + kNC - 1) / kNC;

  // 1. the chain up to the products, into acc
  stage_x<kW>(xs, a.x + base, a, t0);
  __syncthreads();
  for (int e = tid; e < C * kS; e += kThreads) {
    const int c = e / kS, j = e - c * kS, t = t0 + j;
    const bf16* xr = xs + c * kW + (kW - kS) / 2 + j;
    float v;
    if constexpr (kMode == kMm) {
      v = bf(xr);
    } else {
      const int lo = kMode == kFull ? 0 : t / a.tile * a.tile;
      v = depthwise(xr, a.dww + c * kTaps, t, lo, kMode == kFull ? T : lo + a.tile);
    }
    acc[c * kACS + j] = v;
  }
  __syncthreads();
  if constexpr (kMode == kFull) {  // ChannelNorm without affine
    float* mom = reinterpret_cast<float*>(ring);  // xs is dead: 2 kS floats past it
    if (tid < kS) {
      float s = 0.0f;
      for (int c = 0; c < C; ++c) s += acc[c * kACS + tid];
      const float u = s / C;
      float v = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float d = acc[c * kACS + tid] - u;
        v += d * d;
      }
      mom[tid] = u;
      mom[kS + tid] = sqrtf(v / C + kNormEps);
    }
    __syncthreads();
    for (int e = tid; e < C * kS; e += kThreads) {
      const int c = e / kS, j = e - c * kS;
      acc[c * kACS + j] = (acc[c * kACS + j] - mom[j]) / mom[kS + j];
    }
    __syncthreads();
  }
  // bf16(acc), transposed: pw1's (kS, kp) K-major A, zero past C
  for (int e = tid; e < kS * L.kp; e += kThreads) {
    const int j = e % kS, c = e / kS;
    sa[j * L.as + c] = __float2bfloat16_rn(c < C ? acc[c * kACS + j] : 0.0f);
  }

  // W1 rows and W2 columns [32 i, 32 i + 32) into stage i % kStages
  auto stage_weights = [&](int i) {
    bf16* w1s = reinterpret_cast<bf16*>(ring + (i % kStages) * L.stage);
    bf16* w2s = w1s + kNC * L.as;
    const int n0 = i * kNC;
    if (a.wvec) {
      for (int e = tid; e < kNC * (L.kp / 8); e += kThreads) {
        const int row = e / (L.kp / 8), col = 8 * (e % (L.kp / 8)), n = n0 + row;
        const bool ok = n < C4 && col < C;
        ptx::cp_async16(w1s + row * L.as + col,
                        ok ? a.w1t + static_cast<long long>(n) * C + col : a.w1t, ok ? 16 : 0);
      }
      for (int e = tid; e < 16 * kPairs * (kNC / 8); e += kThreads) {
        const int row = e / (kNC / 8), col = 8 * (e % (kNC / 8));
        const bool ok = row < C && n0 + col < C4;
        ptx::cp_async16(w2s + row * kHS + col,
                        ok ? a.w2t + static_cast<long long>(row) * C4 + n0 + col : a.w2t,
                        ok ? 16 : 0);
      }
    } else {
      const bf16 zero = __float2bfloat16_rn(0.0f);
      for (int e = tid; e < kNC * L.kp; e += kThreads) {
        const int row = e / L.kp, col = e % L.kp, n = n0 + row;
        w1s[row * L.as + col] =
            (n < C4 && col < C) ? a.w1t[static_cast<long long>(n) * C + col] : zero;
      }
      for (int e = tid; e < 16 * kPairs * kNC; e += kThreads) {
        const int row = e / kNC, col = e % kNC;
        w2s[row * kHS + col] =
            (row < C && n0 + col < C4) ? a.w2t[static_cast<long long>(row) * C4 + n0 + col] : zero;
      }
    }
  };
  __syncthreads();  // sa is complete; the staged x is dead
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) stage_weights(s);
    ptx::cp_async_commit();
  }

  // 2. hidden chunks
  const int q = lane >> 3, r = lane & 7, gq = lane >> 2, tq = lane & 3, r0 = 16 * warp;
  const bf16* pa = sa + (r0 + (q & 1) * 8 + r) * L.as + (q >> 1) * 8;
  const int ob1 = ((q >> 1) * 8 + r) * L.as + (q & 1) * 8;
  const bf16* ph = hb + ((q & 1) * 8 + r) * kHS + (q >> 1) * 8;
  const int ob2 = ((q >> 1) * 8 + r) * kHS + (q & 1) * 8;
  float sum2[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) sum2[nt][i] = 0.0f;

  for (int ci = 0; ci < chunks; ++ci) {
    ptx::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (ci + kStages - 1 < chunks) stage_weights(ci + kStages - 1);
    ptx::cp_async_commit();
    const bf16* w1s = reinterpret_cast<const bf16*>(ring + (ci % kStages) * L.stage);
    const bf16* w2s = w1s + kNC * L.as;

    // pw1: (16, 32) = bf16(a) . W1[n0:n0+32]^T, a fresh sum per K step of 32
    float sum1[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum1[nt][i] = 0.0f;
    for (int kb = 0; kb < L.kp; kb += 32) {
      float f[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) f[nt][i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 32; kk += 16) {
        const int k = kb + kk;
        if (k < L.kp) {
          uint32_t af[4];
          ptx::ldmatrix_x4(af, pa + k);
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            uint32_t b[4];
            ptx::ldmatrix_x4(b, w1s + ob1 + jp * 16 * L.as + k);
            const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
            ptx::mma_bf16(f[2 * jp], af, b0);
            ptx::mma_bf16(f[2 * jp + 1], af, b1);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum1[nt][i] += f[nt][i];
    }
    // (full: h + sin(h)^2), rounded to bf16 into this warp's buffer
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          v[jj] = sum1[nt][2 * h + jj];
          if constexpr (kMode == kFull) {
            const float sv = sinf(v[jj]);
            v[jj] = __fadd_rn(v[jj], __fmul_rn(sv, sv));
          }
        }
        *reinterpret_cast<uint32_t*>(hb + (gq + 8 * h) * kHS + nt * 8 + 2 * tq) =
            ptx::bf16x2_rn(v[0], v[1]);
      }
    __syncwarp();

    // pw2: (16, C) += bf16(h) (16, 32) . W2[:, n0:n0+32]^T, one fresh sum
    uint32_t hf[2][4];
    ptx::ldmatrix_x4(hf[0], ph);
    ptx::ldmatrix_x4(hf[1], ph + 16);
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      if (2 * p >= nt2) break;
      float f[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t b[4];
        ptx::ldmatrix_x4(b, w2s + ob2 + p * 16 * kHS + ks * 16);
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        ptx::mma_bf16(f[0], hf[ks], b0);
        if (2 * p + 1 < nt2) ptx::mma_bf16(f[1], hf[ks], b1);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sum2[2 * p][i] += f[0][i];
        sum2[2 * p + 1][i] += f[1][i];
      }
    }
    __syncwarp();  // hb is rewritten by the next chunk
  }

  // 3. out = bf16(acc + sum): each lane adds into its own (c, j) of acc
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = nt * 8 + 2 * tq + jj;
      if (c >= C) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) acc[c * kACS + r0 + gq + 8 * h] += sum2[nt][2 * h + jj];
    }
  __syncthreads();
  bf16* ob = a.out + base;
  if (a.vec) {
    for (int e = tid; e < C * (kS / 8); e += kThreads) {
      const int c = e / (kS / 8), p = e - c * (kS / 8), t = t0 + 8 * p;
      if (t >= T) continue;
      const float4 u = *reinterpret_cast<const float4*>(acc + c * kACS + 8 * p);
      const float4 v = *reinterpret_cast<const float4*>(acc + c * kACS + 8 * p + 4);
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(c) * T + t) =
          make_uint4(ptx::bf16x2_rn(u.x, u.y), ptx::bf16x2_rn(u.z, u.w),
                     ptx::bf16x2_rn(v.x, v.y), ptx::bf16x2_rn(v.z, v.w));
    }
  } else {
    for (int e = tid; e < C * kS; e += kThreads) {
      const int c = e / kS, j = e - c * kS;
      if (t0 + j < T) l3ac::store_bf16(ob + static_cast<long long>(c) * T + t0 + j,
                                       acc[c * kACS + j]);
    }
  }
}

constexpr int kSmemMax = 227 * 1024;

template <class K>
cudaError_t launch_tile(K kernel, size_t smem, const Args& a, int B, cudaStream_t stream) {
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(l3ac::ceil_div(a.T, kS), B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_stream(const Args& a, int B, cudaStream_t s) {
  const size_t xs = 2 * static_cast<size_t>(a.C) * kXW<kMode>;
  const size_t extra = kMode == kDw ? 2 * static_cast<size_t>(a.C) * kS
                                    : kMode == kNorm ? 2 * sizeof(float) * kS : 0;
  return launch_tile(stream_kernel<kMode>, xs + extra, a, B, s);
}

template <int kMode, int kNT>
cudaError_t launch_chain_at(const Args& a, int B, cudaStream_t s) {
  const ChainLayout L(a.C, kNT / 2, kXW<kMode>);
  return launch_tile(chain_kernel<kMode, kNT>, static_cast<size_t>(L.total), a, B, s);
}

template <int kMode>
cudaError_t launch_chain(const Args& a, int B, cudaStream_t s) {
  const int nt = (a.C + 7) / 8;
  if (nt <= 2) return launch_chain_at<kMode, 2>(a, B, s);
  if (nt <= 4) return launch_chain_at<kMode, 4>(a, B, s);
  if (nt <= 6) return launch_chain_at<kMode, 6>(a, B, s);
  if (nt <= 12) return launch_chain_at<kMode, 12>(a, B, s);
  if (nt <= 24) return launch_chain_at<kMode, 24>(a, B, s);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x, out: (B, C, T) bf16, contiguous, out not aliasing x; dww (C, 7), w1t
// (4C, C), w2t (C, 4C) bf16, contiguous; T a multiple of tile; C <= 192;
// mode 0..6 in the order of the enum above. Returns the CUDA error code.
extern "C" int l3ac_conv_unit_stages(const void* x, void* out, const void* dww,
                                     const void* w1t, const void* w2t, int B, int C,
                                     int T, int tile, int mode, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || C > 192 || T < 1 || tile < 1 || T % tile != 0)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(x), static_cast<bf16*>(out),
               static_cast<const bf16*>(dww), static_cast<const bf16*>(w1t),
               static_cast<const bf16*>(w2t), C, T, tile,
               T % 8 == 0 && aligned16(x) && aligned16(out),
               C % 8 == 0 && aligned16(w1t) && aligned16(w2t)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kCopy: {
      const long long n = static_cast<long long>(B) * C * T;
      const long long items = a.vec ? n / 8 : n;
      const int blocks = static_cast<int>((items + kThreads - 1) / kThreads < 65535
                                              ? (items + kThreads - 1) / kThreads : 65535);
      copy_kernel<<<blocks, kThreads, 0, s>>>(a, n);
      return cudaGetLastError();
    }
    case kHaloOnly: return launch_stream<kHaloOnly>(a, B, s);
    case kDw: return launch_stream<kDw>(a, B, s);
    case kNorm: return launch_stream<kNorm>(a, B, s);
    case kMm: return launch_chain<kMm>(a, B, s);
    case kDwMm: return launch_chain<kDwMm>(a, B, s);
    case kFull: return launch_chain<kFull>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}
