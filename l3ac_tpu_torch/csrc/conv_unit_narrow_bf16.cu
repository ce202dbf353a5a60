// Residual ConvUnit on bf16 (B, C, T) for C <= 96, fused, both products one
// bf16 tensor-core pass: the bf16 variant of conv_unit_narrow.cu.
//
// Replaces l3ac_tpu/ops/pallas/conv_unit.py:conv_unit_ct (body _kernel_t) on
// bf16 activations at the encoder's channels-first widths (24, 48, 96; debug's
// 8, 12, 16), rounding where that body does:
//   depthwise conv k, dilation d, zero pad, from the dw bias, taps added in
//   order in fp32 -> ChannelNorm (eps 1e-8 inside the sqrt, fp32, affine)
//   -> bf16 -> pw1 C->4C (fp32 sums) + b1 -> snake (or exact GELU) in fp32
//   -> bf16 -> pw2 4C->C with GRN folded (W2' bf16, fp32 sums) + b2'
//   -> + x in fp32 -> bf16.
// Vectors (dw, dw bias, norm, b1, alpha, b2') arrive in fp32, W1 and W2' in
// bf16, prepared once per weight set by ops/kernels/conv_unit.py.
//
// Bound on the H100: 16 C^2 operations per column against 4 C bytes; at the
// bf16 tensor-core rate (989 TFLOP/s) that is below the bytes bound up to
// C = 96, so the kernel is bound by its bytes and its SIMT work (the exact
// snake on 4C values per column, the depthwise conv, the norm).
//
// Design: the structure of conv_unit_stages.cu's full mode (the bisection
// probe of this chain) with the codec's unit in it: one block per (batch
// row, kS = 128 time columns), 8 warps of 16 rows, time as the M axis.
//   1. x and its halo (rounded up to 16-byte pieces) staged by cp.async
//      (16-byte pieces where T % 8 == 0, else 2-byte loads; zero outside
//      [0, T)); the depthwise conv of each (channel, column) in fp32 into an
//      fp32 (C, kS) tile; ChannelNorm's moments per column in fp32 (two
//      passes), the tile normalized, then rounded to bf16 and transposed into
//      pw1's (kS, C) K-major A operand, zero-filled to k16 steps.
//   2. The 4C hidden units in chunks of 32; W1's rows and W2''s columns of a
//      chunk through a 2-stage cp.async ring; per warp pw1 (m16n8k16), b1
//      and the activation in fp32, the chunk rounded to bf16 into the warp's
//      own buffer, and pw2 of the chunk added into its (16, C) sums.
//   3. b2' is added and the tile goes through shared memory, transposed
//      back; out = bf16(x + y), x read again from device memory.
#include "common.cuh"
#include "ptx.cuh"

namespace {

namespace ptx = l3ac::ptx;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kS = 16 * kWarps;  // columns per block: one m16 tile per warp
constexpr int kNC = 32;          // hidden units per chunk: one K step of pw2
constexpr int kStages = 2;       // weight-chunk ring
constexpr int kHS = kNC + 8;     // bf16 row stride of a hidden chunk and of W2''s tile
constexpr int kACS = kS + 4;     // fp32 row stride of the activation tile
constexpr int kMaxC = 96;
constexpr float kNormEps = 1e-8f;

struct Args {
  const bf16* x;
  bf16* out;
  const float* dw;      // (C, K)
  const float* dw_b;    // (C)
  const float* norm_w;  // (C) or null
  const float* norm_b;
  const bf16* w1;       // (4C, C)
  const float* b1;      // (4C)
  const float* alpha;   // (4C) or null: exact GELU
  const bf16* w2;       // (C, 4C) pw2 with GRN folded
  const float* b2;      // (C)
  int C, T, K, dil;
  int vec;              // T % 8 == 0, x and out 16-byte aligned
  int wvec;             // C % 8 == 0, W1 and W2' 16-byte aligned
};

// shared-memory regions, in bytes
struct Geometry {
  int halo, pad;  // the conv's halo; the staged halo, rounded up to 8 columns
  int xw;         // staged columns: kS + 2 pad
  int kp;         // K of pw1 zero-filled to k16 steps
  int as;         // bf16 row stride of the A tile and of W1's tile: kp + 8
  int acc, a, w1, w2, stage, hb, xs, total;
  __host__ __device__ Geometry(int C, int K, int dil, int pairs) {
    halo = (K - 1) * dil / 2;
    pad = (halo + 7) / 8 * 8;
    xw = kS + 2 * pad;
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

// kNT >= ceil(C / 8) n8 tiles of pw2 (an even count)
template <int kNT>
__global__ void __launch_bounds__(kThreads, kNT <= 6 ? 2 : 1) narrow_bf16_kernel(const Args a) {
  constexpr int kPairs = kNT / 2;
  extern __shared__ __align__(16) float smem[];
  const int C = a.C, T = a.T, C4 = 4 * C, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * kS, nt2 = (C + 7) / 8;
  const Geometry L(C, a.K, a.dil, kPairs);
  char* sm = reinterpret_cast<char*>(smem);
  float* acc = reinterpret_cast<float*>(sm);                 // (C, kACS)
  bf16* xs = reinterpret_cast<bf16*>(sm + L.acc);            // (C, xw), before the products
  bf16* sa = reinterpret_cast<bf16*>(sm + L.acc);            // (kS, as)
  char* ring = sm + L.acc + L.a;
  bf16* hb = reinterpret_cast<bf16*>(ring + kStages * L.stage) + warp * 16 * kHS;
  const long long base = static_cast<long long>(blockIdx.y) * C * T;
  const bf16* xb = a.x + base;
  const int chunks = (C4 + kNC - 1) / kNC;

  // 1. x columns [t0 - pad, t0 + kS + pad), zero outside [0, T)
  if (a.vec) {
    for (int e = tid; e < C * (L.xw / 8); e += kThreads) {
      const int c = e / (L.xw / 8), p = e - c * (L.xw / 8), t = t0 - L.pad + 8 * p;
      const bool ok = t >= 0 && t < T;
      ptx::cp_async16(xs + c * L.xw + 8 * p, ok ? xb + static_cast<long long>(c) * T + t : a.x,
                      ok ? 16 : 0);
    }
    ptx::cp_async_commit();
    ptx::cp_async_wait<0>();
  } else {
    for (int e = tid; e < C * L.xw; e += kThreads) {
      const int c = e / L.xw, i = e - c * L.xw, t = t0 - L.pad + i;
      xs[c * L.xw + i] = (t >= 0 && t < T) ? xb[static_cast<long long>(c) * T + t]
                                           : __float2bfloat16_rn(0.0f);
    }
  }
  __syncthreads();
  // the depthwise conv in fp32, taps in order from the bias
  for (int e = tid; e < C * kS; e += kThreads) {
    const int c = e / kS, j = e - c * kS;
    const bf16* xr = xs + c * L.xw + L.pad - L.halo + j;
    const float* wr = a.dw + c * a.K;
    float v = a.dw_b[c];
    for (int k = 0; k < a.K; ++k) v += __bfloat162float(xr[k * a.dil]) * wr[k];
    acc[c * kACS + j] = v;
  }
  __syncthreads();
  if (a.norm_w != nullptr) {  // ChannelNorm per column, fp32
    float* mom = reinterpret_cast<float*>(sm + L.acc + L.xs);  // past the staged x
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
      acc[c * kACS + j] = (acc[c * kACS + j] - mom[j]) / mom[kS + j] * a.norm_w[c] + a.norm_b[c];
    }
    __syncthreads();
  }
  // bf16(acc), transposed: pw1's (kS, kp) K-major A, zero past C
  for (int e = tid; e < kS * L.kp; e += kThreads) {
    const int j = e % kS, c = e / kS;
    sa[j * L.as + c] = __float2bfloat16_rn(c < C ? acc[c * kACS + j] : 0.0f);
  }

  // W1 rows and W2' columns [32 i, 32 i + 32) into stage i % kStages
  auto stage_weights = [&](int i) {
    bf16* w1s = reinterpret_cast<bf16*>(ring + (i % kStages) * L.stage);
    bf16* w2s = w1s + kNC * L.as;
    const int n0 = i * kNC;
    if (a.wvec) {
      for (int e = tid; e < kNC * (L.kp / 8); e += kThreads) {
        const int row = e / (L.kp / 8), col = 8 * (e % (L.kp / 8)), n = n0 + row;
        const bool ok = n < C4 && col < C;
        ptx::cp_async16(w1s + row * L.as + col,
                        ok ? a.w1 + static_cast<long long>(n) * C + col : a.w1, ok ? 16 : 0);
      }
      for (int e = tid; e < 16 * kPairs * (kNC / 8); e += kThreads) {
        const int row = e / (kNC / 8), col = 8 * (e % (kNC / 8));
        const bool ok = row < C && n0 + col < C4;
        ptx::cp_async16(w2s + row * kHS + col,
                        ok ? a.w2 + static_cast<long long>(row) * C4 + n0 + col : a.w2,
                        ok ? 16 : 0);
      }
    } else {
      const bf16 zero = __float2bfloat16_rn(0.0f);
      for (int e = tid; e < kNC * L.kp; e += kThreads) {
        const int row = e / L.kp, col = e % L.kp, n = n0 + row;
        w1s[row * L.as + col] =
            (n < C4 && col < C) ? a.w1[static_cast<long long>(n) * C + col] : zero;
      }
      for (int e = tid; e < 16 * kPairs * kNC; e += kThreads) {
        const int row = e / kNC, col = e % kNC;
        w2s[row * kHS + col] =
            (row < C && n0 + col < C4) ? a.w2[static_cast<long long>(row) * C4 + n0 + col] : zero;
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
    const int n0 = ci * kNC;

    // pw1: (16, 32) = bf16(a) . W1[n0:n0+32]^T
    float s1[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s1[nt][i] = 0.0f;
    for (int k = 0; k < L.kp; k += 16) {
      uint32_t af[4];
      ptx::ldmatrix_x4(af, pa + k);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t b[4];
        ptx::ldmatrix_x4(b, w1s + ob1 + jp * 16 * L.as + k);
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        ptx::mma_bf16(s1[2 * jp], af, b0);
        ptx::mma_bf16(s1[2 * jp + 1], af, b1);
      }
    }
    // + b1 and the activation in fp32, rounded to bf16 into this warp's
    // buffer; hidden units past 4C are zero
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int m = n0 + nt * 8 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const bool ok = m + jj < C4;
          const float y = s1[nt][2 * h + jj] + (ok ? a.b1[m + jj] : 0.0f);
          v[jj] = !ok ? 0.0f
                      : (a.alpha != nullptr ? l3ac::snake(y, a.alpha[m + jj]) : l3ac::gelu(y));
        }
        *reinterpret_cast<uint32_t*>(hb + (gq + 8 * h) * kHS + nt * 8 + 2 * tq) =
            ptx::bf16x2_rn(v[0], v[1]);
      }
    }
    __syncwarp();

    // pw2: (16, C) += bf16(h) (16, 32) . W2'[:, n0:n0+32]^T
    uint32_t hf[2][4];
    ptx::ldmatrix_x4(hf[0], ph);
    ptx::ldmatrix_x4(hf[1], ph + 16);
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      if (2 * p >= nt2) break;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t b[4];
        ptx::ldmatrix_x4(b, w2s + ob2 + p * 16 * kHS + ks * 16);
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        ptx::mma_bf16(sum2[2 * p], hf[ks], b0);
        if (2 * p + 1 < nt2) ptx::mma_bf16(sum2[2 * p + 1], hf[ks], b1);
      }
    }
    __syncwarp();  // hb is rewritten by the next chunk
  }

  // 3. y = sum + b2' into acc (dead since sa was built), then out = bf16(x + y)
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = nt * 8 + 2 * tq + jj;
      if (c >= C) continue;
      const float bc = a.b2[c];
#pragma unroll
      for (int h = 0; h < 2; ++h) acc[c * kACS + r0 + gq + 8 * h] = sum2[nt][2 * h + jj] + bc;
    }
  __syncthreads();
  bf16* ob = a.out + base;
  if (a.vec) {
    for (int e = tid; e < C * (kS / 8); e += kThreads) {
      const int c = e / (kS / 8), p = e - c * (kS / 8), t = t0 + 8 * p;
      if (t >= T) continue;
      const uint4 xv = __ldg(reinterpret_cast<const uint4*>(xb + static_cast<long long>(c) * T + t));
      const float* y = acc + c * kACS + 8 * p;
      const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
      uint32_t ow[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ow[i] = ptx::bf16x2_rn(__uint_as_float(xw[i] << 16) + y[2 * i],
                               __uint_as_float(xw[i] & 0xffff0000u) + y[2 * i + 1]);
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(c) * T + t) =
          make_uint4(ow[0], ow[1], ow[2], ow[3]);
    }
  } else {
    for (int e = tid; e < C * kS; e += kThreads) {
      const int c = e / kS, j = e - c * kS;
      if (t0 + j < T) {
        const long long o = static_cast<long long>(c) * T + t0 + j;
        l3ac::store_bf16(ob + o, __bfloat162float(xb[o]) + acc[c * kACS + j]);
      }
    }
  }
}

template <int kNT>
cudaError_t launch_at(const Args& a, int B, cudaStream_t stream) {
  const Geometry L(a.C, a.K, a.dil, kNT / 2);
  const size_t smem = static_cast<size_t>(L.total) + 2 * sizeof(float) * kS;  // + the moments
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(narrow_bf16_kernel<kNT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(l3ac::ceil_div(a.T, kS), B);
  narrow_bf16_kernel<kNT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x, out: (B, C, T) bf16, 1 <= C <= 96; dw: (C, K), dw_b, norm_w / norm_b
// (null: no ChannelNorm), b1 (4C), alpha (4C; null: exact GELU), b2 (C) fp32;
// w1: (4C, C) and w2: (C, 4C) bf16 (pw2 with GRN folded). All contiguous, out
// not aliasing x. Returns the CUDA error code (invalid value for a shape it
// does not take).
extern "C" int l3ac_conv_unit_narrow_bf16(const void* x, void* out, const float* dw,
                                          const float* dw_b, const float* norm_w,
                                          const float* norm_b, const void* w1, const float* b1,
                                          const float* alpha, const void* w2, const float* b2,
                                          int B, int C, int T, int K, int dil, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || C > kMaxC || T < 1 || K < 1 || K % 2 == 0 || dil < 1)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(x), static_cast<bf16*>(out), dw, dw_b, norm_w, norm_b,
               static_cast<const bf16*>(w1), b1, alpha, static_cast<const bf16*>(w2), b2,
               C, T, K, dil, T % 8 == 0 && aligned16(x) && aligned16(out),
               C % 8 == 0 && aligned16(w1) && aligned16(w2)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = (C + 7) / 8;
  if (nt <= 2) return launch_at<2>(a, B, s);
  if (nt <= 4) return launch_at<4>(a, B, s);
  if (nt <= 6) return launch_at<6>(a, B, s);
  if (nt <= 8) return launch_at<8>(a, B, s);
  return launch_at<12>(a, B, s);
}
