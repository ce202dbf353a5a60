// Residual ConvUnit on (B, C, T) for C <= 96, fused, with both products on
// the tensor cores.
//
// Replaces l3ac_tpu/ops/pallas/conv_unit.py:conv_unit_ct (body _kernel_t) at
// every width the codec runs channels first (24, 48, 96; debug's 8, 12, 16):
//   depthwise conv k, dilation d, zero pad -> ChannelNorm (eps 1e-8 inside
//   the sqrt) -> pw1 C->4C -> snake (or exact GELU) -> pw2 4C->C with GRN
//   folded into it (n = 1) -> + x
//
// Bound on the H100: 16 C^2 operations per column against 8 C bytes. At the
// tensor cores' 3xTF32 rate (tc_gemm.cuh) that is within 1.5-3x of the bytes
// bound at C = 24-96, so the normalized input and the (4C) hidden activation
// must not go through device memory (that alone would cost more than the
// products): as the TPU kernel does, one block keeps them on the SM.
//
// Design: one block per (batch row, kS = 128 time columns), 8 warps of 16
// rows. Time is the M axis of both products, so the B operands are the
// prepared nn.Linear-layout W1 (4C, C) and W2' (C, 4C), K-major as in
// tc_gemm.cuh, and its fragment addressing applies unchanged.
//   1. x and its halo are staged with cp.async (16-byte copies where T is a
//      multiple of 4, coalesced along T; zero fill outside [0, T)), together
//      with the first weight chunk. Each warp computes the depthwise conv of
//      4 columns x 8 channels per step (lanes over both, so the staged rows
//      are read without bank conflicts), reduces ChannelNorm's moments over
//      its 8 channel lanes with shuffles (two passes), and writes the
//      normalized tile transposed, (kS, C) K-major, zero-filled to a multiple
//      of 8 channels.
//   2. The 4C hidden units are walked in chunks of kNC = 32. Per chunk, W1's
//      32 rows and W2''s 32 columns (TF32 hi and lo, prepared once per weight
//      set by the wrapper) arrive through a 2-stage cp.async ring; each warp
//      runs pw1 for its 16 rows (3xTF32, mma.sync m16n8k8, the A fragments
//      split into hi / lo as they are loaded), applies b1 and the activation,
//      stores the 16 x 32 chunk into its own shared buffer as pw2's A, and
//      adds pw2 of the chunk into its (16, C) accumulators. A warp consumes
//      only the hidden rows it produced, so between the two products it needs
//      __syncwarp, not a block barrier.
//   3. b2' is added and the tile goes through shared memory, transposed back,
//      so that each (c, t) run is written, with the residual, as 16-byte rows.
// Accuracy as in tc_gemm.cuh: each K step of 32 sums into a fresh
// accumulator that is added to the fp32 total (pw1: K = C in steps of 32,
// zero-filled to 8; pw2: each chunk of 32 hidden units is one step). K and N
// are zero-filled in shared memory, no padded copy in device memory.
// Shared memory at C = 96: the (128, 100) normalized tile, two 52 KB weight
// stages and 8 warp buffers, 177 KB (1 block per SM); the staged x aliases
// the second stage and the warp buffers. C = 48: 99 KB, C = 24: 64 KB.
// Exact sinf in the snake epilogue (the fast sine is not ported).
//
// Tiling, measured on the card against its alternatives with
// l3ac_tpu_torch/tools/narrow_variants.py (PERF.md): 8 warps x 16 rows (128
// columns) per block, a 2-stage ring (a third stage does not fit at C = 96),
// W1 / W2' as prepared TF32 hi / lo, and up to 3 blocks per SM at C <= 24
// (80 registers and a small spill, 5 % faster there than 2 blocks without).
// 4 warps (64 columns) stage the weights twice as often and ran 1.4-1.7x
// slower; fp32-only weights split at fragment load ran within the 2-3 %
// spread. The same tool's ablations put a third of the time in the exact
// snake and most of the rest in latency: at C = 96 one block of 8 warps per
// SM, and a block's phases run one after another.
#include "common.cuh"
#include "ptx.cuh"

namespace {

namespace ptx = l3ac::ptx;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kS = 16 * kWarps;  // time columns per block: one m16 tile per warp
constexpr int kNC = 32;          // hidden units per chunk: one K step of pw2
constexpr int kStages = 2;       // weight-chunk ring
constexpr int kHS = kNC + 4;     // row stride of a warp's hidden chunk and of W2''s tile
constexpr int kOS = kS + 4;      // row stride of the output tile
constexpr int kMaxK8 = 12;       // C <= 96
constexpr int kBatch = 4;        // residual loads in flight per thread in the epilogue
constexpr float kNormEps = 1e-8f;

struct Args {
  const float* x;
  float* out;
  const float* dw_w;    // (C, K)
  const float* dw_b;    // (C)
  const float* norm_w;  // (C) or null
  const float* norm_b;  // (C) or null
  const float* w1_hi;   // (4C, C) pw1, TF32 hi / lo
  const float* w1_lo;
  const float* b1;      // (4C)
  const float* alpha;   // (4C) or null: exact GELU
  const float* w2_hi;   // (C, 4C) pw2 with GRN folded, TF32 hi / lo
  const float* w2_lo;
  const float* b2;      // (C) folded bias
  int C, T, K, dil;
  int x_vec;            // T % 4 == 0, x and out 16-byte aligned
  int w1_vec;           // C % 4 == 0, W1 16-byte aligned
  int H;                // hidden units: 4C, or a tensor-parallel shard of them
  int partial;          // 1: out = the unit's partial sum, no residual (TP mode)
};

// Shared-memory regions in floats. Row strides are 4 mod 8 words, so the
// eight rows of an ldmatrix tile (and the staged x rows read by 8 channel
// lanes) fall in distinct banks.
struct Geometry {
  int k8;      // K steps of 8 in pw1: ceil(C / 8)
  int as;      // row stride of the normalized tile, 8 k8 + 4
  int halo, halo4;
  int xp;      // row stride of the staged x: kS + 2 halo4 columns, from t0 - halo4
  int w1, w2;  // floats of one W1 (kNC x as) and one W2' (16 pairs x kHS) tile
  int stage;   // one ring stage: W1 hi, W1 lo, W2' hi, W2' lo
  int a;       // the normalized tile, later the (C, kOS) output tile
  int total;
  __host__ __device__ Geometry(int C, int K, int dil, int pairs2) {
    k8 = (C + 7) / 8;
    as = 8 * k8 + 4;
    halo = (K - 1) * dil / 2;
    halo4 = (halo + 3) / 4 * 4;
    xp = (kS + 2 * halo4) | 4;
    w1 = kNC * as;
    w2 = 16 * pairs2 * kHS;
    stage = 2 * (w1 + w2);
    a = kS * as > C * kOS ? kS * as : C * kOS;
    const int run = kStages * stage + kWarps * 16 * kHS;
    const int prologue = stage + C * xp;
    total = a + (run > prologue ? run : prologue);
  }
};

__device__ __forceinline__ float warp_sum8(float v) {  // over lanes that differ in bits 0-2
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

// raw fp32 fragment -> TF32 hi and lo
__device__ __forceinline__ void split(const uint32_t (&raw)[4], uint32_t (&hi)[4],
                                      uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v = __uint_as_float(raw[i]);
    hi[i] = ptx::tf32_rna(v);
    lo[i] = ptx::tf32_rna(v - __uint_as_float(hi[i]));
  }
}

// the three passes of one m16n8k8 step, small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  const uint32_t bh[2] = {bh0, bh1}, bl[2] = {bl0, bl1};
  ptx::mma_tf32(d, al, bh);
  ptx::mma_tf32(d, ah, bl);
  ptx::mma_tf32(d, ah, bh);
}

// kNT2: n8 tiles of pw2's output, ceil(C / 8)
template <int kNT2>
__global__ void __launch_bounds__(kThreads, kNT2 <= 3 ? 3 : kNT2 <= 6 ? 2 : 1)
narrow_kernel(const Args a) {
  constexpr int kPairs2 = (kNT2 + 1) / 2;
  extern __shared__ __align__(16) float smem[];
  const int C = a.C, T = a.T, C4 = a.H;
  const Geometry g(C, a.K, a.dil, kPairs2);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * kS;
  const long long xoff = static_cast<long long>(blockIdx.y) * C * T;
  const float* xb = a.x + xoff;
  float* sa = smem;                                      // (kS, as) normalized tile
  float* ring = sa + g.a;
  float* xs = ring + g.stage;                            // (C, xp), during step 1 only
  float* hb = ring + kStages * g.stage + warp * 16 * kHS;  // this warp's (16, kHS) chunk
  const int chunks = (C4 + kNC - 1) / kNC;

  // W1 rows and W2' columns [32 i, 32 i + 32) into stage i % kStages
  auto stage_weights = [&](int i) {
    float* st = ring + (i % kStages) * g.stage;
    const int n0 = i * kNC, q1 = 2 * g.k8;  // 16-byte pieces per W1 row
    for (int e = tid; e < 2 * kNC * q1; e += kThreads) {
      const int hl = e / (kNC * q1), rem = e - hl * kNC * q1;
      const int row = rem / q1, col = 4 * (rem - row * q1), n = n0 + row;
      const float* src = hl ? a.w1_lo : a.w1_hi;
      float* dst = st + hl * g.w1 + row * g.as + col;
      if (a.w1_vec) {
        const bool ok = n < C4 && col < C;
        ptx::cp_async16(dst, ok ? src + static_cast<long long>(n) * C + col : src, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = n < C4 && col + u < C;
          ptx::cp_async4(dst + u, ok ? src + static_cast<long long>(n) * C + col + u : src,
                         ok ? 4 : 0);
        }
      }
    }
    const int rows2 = 16 * kPairs2;
    for (int e = tid; e < 2 * rows2 * (kNC / 4); e += kThreads) {
      const int hl = e / (rows2 * (kNC / 4)), rem = e - hl * rows2 * (kNC / 4);
      const int row = rem / (kNC / 4), col = 4 * (rem % (kNC / 4));
      const float* src = hl ? a.w2_lo : a.w2_hi;
      float* dst = st + 2 * g.w1 + hl * g.w2 + row * kHS + col;
      const bool ok = row < C && n0 + col < C4;
      ptx::cp_async16(dst, ok ? src + static_cast<long long>(row) * C4 + n0 + col : src,
                      ok ? 16 : 0);
    }
  };

  // 1. stage x (columns t0 - halo4 .. t0 + kS + halo4) and the first chunk
  {
    const int gs = t0 - g.halo4, q = (kS + 2 * g.halo4) / 4;
    for (int e = tid; e < C * q; e += kThreads) {
      const int c = e / q, p = e - c * q, t = gs + 4 * p;
      float* dst = xs + c * g.xp + 4 * p;
      const float* row = xb + static_cast<long long>(c) * T;
      if (t >= T || t + 4 <= 0) {
        ptx::cp_async16(dst, a.x, 0);
      } else if (a.x_vec && t >= 0) {
        ptx::cp_async16(dst, row + t, 16);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = t + u >= 0 && t + u < T;
          ptx::cp_async4(dst + u, ok ? row + t + u : a.x, ok ? 4 : 0);
        }
      }
    }
    stage_weights(0);
    ptx::cp_async_commit();
    ptx::cp_async_wait<0>();
    __syncthreads();

    const int cs = lane & 7, off = g.halo4 - g.halo;
    for (int jg = warp; jg < kS / 4; jg += kWarps) {
      const int j = 4 * jg + (lane >> 3);
      float y[kMaxK8], s = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxK8; ++i) {
        const int c = 8 * i + cs;
        y[i] = 0.0f;
        if (c < C) {
          const float* xr = xs + c * g.xp + j + off;
          const float* wr = a.dw_w + c * a.K;
          float acc = a.dw_b[c];
#pragma unroll 7
          for (int k = 0; k < a.K; ++k) acc += xr[k * a.dil] * __ldg(wr + k);
          y[i] = acc;
          s += acc;
        }
      }
      if (a.norm_w != nullptr) {
        const float u = warp_sum8(s) / C;
        float v = 0.0f;
#pragma unroll
        for (int i = 0; i < kMaxK8; ++i) {
          const float d = y[i] - u;
          if (8 * i + cs < C) v += d * d;
        }
        const float sd = sqrtf(warp_sum8(v) / C + kNormEps);
#pragma unroll
        for (int i = 0; i < kMaxK8; ++i) {
          const int c = 8 * i + cs;
          if (c < C) y[i] = (y[i] - u) / sd * a.norm_w[c] + a.norm_b[c];
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxK8; ++i) {
        const int c = 8 * i + cs;
        if (i < g.k8) sa[j * g.as + c] = c < C ? y[i] : 0.0f;  // zero to 8 k8
      }
    }
    __syncthreads();  // xs is dead: the ring's later stages and the warp buffers take its place
  }
  for (int s = 1; s < kStages - 1; ++s) {
    if (s < chunks) stage_weights(s);
    ptx::cp_async_commit();
  }

  // 2. hidden chunks
  const int q = lane >> 3, r = lane & 7, gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * warp;
  const float* pa = sa + (r0 + (q & 1) * 8 + r) * g.as + (q >> 1) * 4;
  const int ob1 = ((q >> 1) * 8 + r) * g.as + (q & 1) * 4;
  const float* ph = hb + ((q & 1) * 8 + r) * kHS + (q >> 1) * 4;
  const int ob2 = ((q >> 1) * 8 + r) * kHS + (q & 1) * 4;
  float sum2[kNT2][4];
#pragma unroll
  for (int nt = 0; nt < kNT2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) sum2[nt][i] = 0.0f;

  for (int ci = 0; ci < chunks; ++ci) {
    ptx::cp_async_wait<kStages - 2>();  // chunk ci has landed
    __syncthreads();                    // ... for every thread; stage (ci - 1) is free
    if (ci + kStages - 1 < chunks) stage_weights(ci + kStages - 1);
    ptx::cp_async_commit();
    const float* st = ring + (ci % kStages) * g.stage;
    const float* w1h = st + ob1;
    const float* w1l = st + g.w1 + ob1;
    const float* w2h = st + 2 * g.w1 + ob2;
    const float* w2l = st + 2 * g.w1 + g.w2 + ob2;
    const int n0 = ci * kNC;

    // pw1: (16, 32) = a (16, C) . W1[n0:n0+32]^T, a fresh sum per K step of 32
    float sum1[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum1[nt][i] = 0.0f;
    for (int kb = 0; kb < g.k8; kb += 4) {
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k8 = kb + kk;
        if (k8 < g.k8) {
          uint32_t raw[4], hi[4], lo[4];
          ptx::ldmatrix_x4(raw, pa + k8 * 8);
          split(raw, hi, lo);
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            uint32_t bh[4], bl[4];
            ptx::ldmatrix_x4(bh, w1h + jp * 16 * g.as + k8 * 8);
            ptx::ldmatrix_x4(bl, w1l + jp * 16 * g.as + k8 * 8);
            mma3(acc[2 * jp], hi, lo, bh[0], bh[1], bl[0], bl[1]);
            mma3(acc[2 * jp + 1], hi, lo, bh[2], bh[3], bl[2], bl[3]);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum1[nt][i] += acc[nt][i];
    }

    // b1 and the activation; hidden units past 4C are zero. Lane (gq, tq)
    // holds rows gq and gq + 8, columns 2 tq and 2 tq + 1 of each n8 tile.
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int m = n0 + nt * 8 + 2 * tq;
      float v[2][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const bool ok = m + jj < C4;
        const float bb = ok ? a.b1[m + jj] : 0.0f;
        const float al = (ok && a.alpha != nullptr) ? a.alpha[m + jj] : 1.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float y = sum1[nt][2 * h + jj] + bb;
          v[h][jj] = !ok ? 0.0f : (a.alpha != nullptr ? l3ac::snake(y, al) : l3ac::gelu(y));
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(hb + (gq + 8 * h) * kHS + nt * 8 + 2 * tq) =
            make_float2(v[h][0], v[h][1]);
    }
    __syncwarp();

    // pw2: (16, C) += h (16, 32) . W2'[:, n0:n0+32]^T, one fresh sum
    uint32_t hh[4][4], hl[4][4];
#pragma unroll
    for (int k8 = 0; k8 < 4; ++k8) {
      uint32_t raw[4];
      ptx::ldmatrix_x4(raw, ph + k8 * 8);
      split(raw, hh[k8], hl[k8]);
    }
#pragma unroll
    for (int p = 0; p < kPairs2; ++p) {
      constexpr int kLast = kNT2 - 1;
      float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int k8 = 0; k8 < 4; ++k8) {
        uint32_t bh[4], bl[4];
        ptx::ldmatrix_x4(bh, w2h + p * 16 * kHS + k8 * 8);
        ptx::ldmatrix_x4(bl, w2l + p * 16 * kHS + k8 * 8);
        mma3(acc[0], hh[k8], hl[k8], bh[0], bh[1], bl[0], bl[1]);
        if (2 * p + 1 <= kLast) mma3(acc[1], hh[k8], hl[k8], bh[2], bh[3], bl[2], bl[3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sum2[2 * p][i] += acc[0][i];
        if (2 * p + 1 <= kLast) sum2[(2 * p + 1) % kNT2][i] += acc[1][i];
      }
    }
    __syncwarp();  // hb is rewritten by the next chunk
  }

  // 3. b2', then out = x + tile through shared memory, (C, kOS) over sa
  __syncthreads();
  float* os = smem;
#pragma unroll
  for (int nt = 0; nt < kNT2; ++nt)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = nt * 8 + 2 * tq + jj;
      if (c >= C) continue;
      const float bc = a.b2[c];
#pragma unroll
      for (int h = 0; h < 2; ++h) os[c * kOS + r0 + gq + 8 * h] = sum2[nt][2 * h + jj] + bc;
    }
  __syncthreads();
  // the residual is read back in batches of kBatch independent loads per
  // thread, issued before any of their stores
  float* ob = a.out + xoff;
  if (a.partial) {  // TP mode: the tile as it is, consecutive threads on consecutive t
    for (int e = tid; e < C * kS; e += kThreads) {
      const int c = e / kS, j = e % kS;
      if (t0 + j < T) ob[static_cast<long long>(c) * T + t0 + j] = os[c * kOS + j];
    }
  } else if (a.x_vec) {  // 16-byte pieces: T and t are multiples of 4
    const int n = C * (kS / 4);
    for (int e0 = tid; e0 < n; e0 += kBatch * kThreads) {
      float4 xv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads, c = e / (kS / 4), t = t0 + 4 * (e % (kS / 4));
        if (e < n && t < T)
          xv[u] = __ldg(reinterpret_cast<const float4*>(xb + static_cast<long long>(c) * T + t));
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads, c = e / (kS / 4), p = e % (kS / 4), t = t0 + 4 * p;
        if (e < n && t < T) {
          const float4 ov = *reinterpret_cast<const float4*>(os + c * kOS + 4 * p);
          *reinterpret_cast<float4*>(ob + static_cast<long long>(c) * T + t) =
              make_float4(xv[u].x + ov.x, xv[u].y + ov.y, xv[u].z + ov.z, xv[u].w + ov.w);
        }
      }
    }
  } else {  // 4-byte elements, consecutive threads on consecutive t
    const int n = C * kS;
    for (int e0 = tid; e0 < n; e0 += 4 * kBatch * kThreads) {
      float xv[4 * kBatch];
#pragma unroll
      for (int u = 0; u < 4 * kBatch; ++u) {
        const int e = e0 + u * kThreads, c = e / kS, t = t0 + e % kS;
        if (e < n && t < T) xv[u] = __ldg(xb + static_cast<long long>(c) * T + t);
      }
#pragma unroll
      for (int u = 0; u < 4 * kBatch; ++u) {
        const int e = e0 + u * kThreads, c = e / kS, j = e % kS;
        if (e < n && t0 + j < T) ob[static_cast<long long>(c) * T + t0 + j] = xv[u] + os[c * kOS + j];
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int kNT2>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const Geometry g(a.C, a.K, a.dil, (kNT2 + 1) / 2);
  const size_t smem = sizeof(float) * static_cast<size_t>(g.total);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(narrow_kernel<kNT2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(l3ac::ceil_div(a.T, kS), B);
  narrow_kernel<kNT2><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x, out: (B, C, T), 1 <= C <= 96; dw_w: (C, K); w1_hi / w1_lo: (H, C) pw1
// split into TF32; b1, alpha: (H); w2_hi / w2_lo: (C, H) pw2 with GRN folded,
// split, 16-byte aligned; b2: (C) folded bias. H: the hidden units, 4C, or in
// the tensor-parallel mode (partial 1) a rank's shard of them, a multiple of
// 4 (zero-padded by the wrapper); partial 1 writes the shard's sum without
// the residual. norm_w / norm_b null: no ChannelNorm; alpha null: exact GELU
// instead of snake. All fp32 and contiguous, out not aliasing x. Returns the
// CUDA error code (invalid value for a shape it does not take).
extern "C" int l3ac_conv_unit_narrow(const float* x, float* out, const float* dw_w,
                                     const float* dw_b, const float* norm_w,
                                     const float* norm_b, const float* w1_hi,
                                     const float* w1_lo, const float* b1, const float* alpha,
                                     const float* w2_hi, const float* w2_lo, const float* b2,
                                     int B, int C, int T, int K, int dil, int H, int partial,
                                     void* stream) {
  if (B < 1 || B > 65535 || C < 1 || C > 8 * kMaxK8 || T < 1 || K < 1 || K % 2 == 0 ||
      dil < 1 || H < 4 || H % 4 != 0 || !aligned16(w2_hi) || !aligned16(w2_lo))
    return cudaErrorInvalidValue;
  const Args a{x, out, dw_w, dw_b, norm_w, norm_b, w1_hi, w1_lo, b1, alpha, w2_hi, w2_lo, b2,
               C, T, K, dil, T % 4 == 0 && aligned16(x) && aligned16(out),
               C % 4 == 0 && aligned16(w1_hi) && aligned16(w1_lo), H, partial != 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((C + 7) / 8) {
    case 1: return launch<1>(a, B, s);
    case 2: return launch<2>(a, B, s);
    case 3: return launch<3>(a, B, s);
    case 4: return launch<4>(a, B, s);
    case 5: return launch<5>(a, B, s);
    case 6: return launch<6>(a, B, s);
    case 7: return launch<7>(a, B, s);
    case 8: return launch<8>(a, B, s);
    case 9: return launch<9>(a, B, s);
    case 10: return launch<10>(a, B, s);
    case 11: return launch<11>(a, B, s);
    case 12: return launch<12>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}
