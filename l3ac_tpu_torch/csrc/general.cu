// The general routes of the codec's kernels: every width the JAX kernels
// take (ROADMAP C3), past the fast instantiations of the other sources.
//
// The Pallas kernels' BlockSpecs hold whole channel and head dims, bounded
// only by VMEM, so the JAX model runs any feature_dim, encoder and decoder
// widths. The fast kernels of this port are instantiated for the released
// widths (head dims multiples of 4 up to 128, ConvUnits at C % 64 == 0 up to
// 1024, the tail up to 64 channels, the stream up path up to 128). The
// wrappers send every other width here (ops/kernels/*.py: each module's
// route rule), where each kernel loops over its channel, K or N tiles, so
// no width is refused:
//
// - gemm: the product of the general routes on the tensor cores, for the
//   operands the fast cores do not read: A by a two-level (batch, time) row
//   address with any strides, so both activation layouts are read in place,
//   and K optionally split into (channel, tap) so that a SAME-padded k7 conv
//   is one product (im2col by address); B (N, K) row-major (fp32: plus the
//   TF32 lo term of a prepared split); bias, snake, exact GELU or tanh, a
//   residual and round_mid in the epilogue; bf16 or fp32 operands and output.
//   fp32 runs 3xTF32 mma.sync m16n8k8, bf16 one m16n8k16 pass, fp32 sums.
//   The wrappers send a K-major A with flat rows (every unit product, the
//   contiguous (B, T, C) up path) to the fast cores instead: tc_gemm.cuh
//   (fp32) and gemm_sm90.cuh (bf16; ops/kernels/conv_unit.py:gemm_route).
//   What stays here is the (B, C, T) up path's 1x1 conv, the tail's convs and
//   any strided view. Staging: each thread loads its elements of the next K
//   step into registers, one address each (the im2col shift, the time edges
//   and past K zero), during this step's products, and stores them as fp32
//   into the other stage of the ring: one code path for every stride and
//   both dtypes (cp.async needs 4-byte granules, which a bf16 row at an odd
//   offset or an im2col shift of one element does not give). Bound: the
//   products (tensor passes) at the tail's and the up path's widths; bf16
//   runs far from its bound (PERF.md §6), the element staging (a load and
//   its address arithmetic per element) the suspect.
// - dw_norm: the ConvUnit's depthwise conv and ChannelNorm, one block per
//   (batch, time) row looping over C in three passes (mean, variance,
//   output), the conv recomputed per pass, so no row buffer bounds C.
// - up_blend_norm: the up path's linear upsample phase and ChannelNorm over
//   Co, one block per output row, stored at its interleaved address
//   (either layout, phase_split) as up_fused.cu's stores are.
// - attention: the design of the fast kernels (local_attention.cu), without
//   their instantiation limits: one block per (64 query rows, O's column
//   slab, window, batch * head), S = q K^T and O += P V on the tensor cores
//   (fp32 3xTF32 m16n8k8 with P kept in S's accumulator registers by the
//   key order sigma; bf16 m16n8k16, V by ldmatrix.trans), the softmax in
//   fp32 (one pass; bf16 two, see Rounding). Any D: S runs over D in chunks of 64 columns (q's and
//   K's chunk staged together, zero past D, so the k step's padding is
//   zero), O holds up to 256 columns in registers and runs over them in
//   chunks of 64; above 256 columns O is split into slabs of equal width,
//   one block each (S is then computed once per slab: beyond D = 256 only).
//   Bound: the products at D >= 64, but at the C3 shape (B 2, H 6, T 750,
//   n 250) there are only 144 work items of 64 rows for 132 SMs, and O's
//   registers (up to 128 a thread) allow one block an SM: so each row
//   group's key tiles are split between two warps (8 a block, each half
//   with its own online softmax, merged at the end) and the blocks run
//   longest first, so that a second wave holds the shortest (PERF.md §6
//   has the times of each step). Shared memory is fixed whatever D and n (two stages of one
//   chunk pair, 68 KB fp32, 36 KB bf16; the halves' merge needs up to 66
//   KB). Copies: 16-byte cp.async where every row start is aligned and D a
//   multiple of the piece, 4-byte ones else (bf16: at even offsets and
//   strides), bf16 element loads at odd offsets; only the columns the
//   products read.
// - snake: the legacy tail's snakes, elementwise (the phase pair read in
//   place); its convs are gemm's (any C).
//
// Rounding: where the bf16 plain versions round (ops/kernels/*.py), these
// do: bf16 operands with fp32 sums, the snake or GELU in fp32 then rounded
// where the plain version stores bf16. The bf16 attention takes two passes
// over the keys, the first for each row's max and sum, so that it rounds the
// normalized P = exp(s - max) / sum to bf16 as the plain version does (a
// one-pass softmax rounds the unnormalized P, as local_attention_bf16.cu
// does: it moved 4 of the 122 FSQ indices of a debug model at head dim 10,
// against the floor of 3; the S products are computed twice, cheap in
// bf16). fp32 is held to fp32: 3xTF32 with a fresh accumulator per K step
// of 32 (tc_gemm.cuh's scheme), a one-pass softmax.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "ptx.cuh"

namespace {

namespace ptx = l3ac::ptx;
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

// row m of a (batch, time) row space with `rows` rows a batch
__device__ __forceinline__ long long row_at(long long m, int rows, long long sb, long long st_) {
  return (m / rows) * sb + (m % rows) * st_;
}

// ---------------------------------------------------------------- gemm

struct GemmArgs {
  // A(m, k) with m = (b, t), b = m / a_rows, t = m % a_rows, and k = (c, tap),
  // c = k / taps, tap = k % taps: a[b a_sb + t' a_st + c a_sk] at
  // t' = t + (tap - taps / 2) dil, zero outside [0, a_rows) (taps 1: a plain
  // product; taps 7: a SAME-padded k7 conv as one product, im2col by address)
  const void* a;
  long long a_sb, a_st, a_sk;
  int a_rows, a_bf, taps, dil;
  const void* b;     // (N, K) row-major, of A's dtype
  const float* b_lo; // fp32: a second (N, K) term added to b (TF32 hi / lo), or null
  int b_bf;
  const float* bias;   // (N,) or null
  const float* alpha;  // (N,) snake, when act == 1
  int act;             // 0 none, 1 snake, 2 exact GELU, 3 tanh
  const void* res;     // residual at the output's address map, or null
  int res_bf, round_mid;  // round_mid: the product + bias rounded to bf16 before the residual
  void* out;
  long long o_sb, o_st, o_sn;
  int o_rows, o_bf;
  long long M;
  int N, K;
};

// 128 x 64 outputs a block: 8 warps of 32 x 32 (4 along M, 2 along N), K in
// steps of 32 through a two-stage ring in shared memory, both dtypes staged
// as fp32 (A as [k][m], B as [n][k]; the strides keep each fragment read free
// of bank conflicts: A 8 (fp32) / 4 (bf16) mod 32, B 4 mod 32 / 8 mod 32 with
// 8-byte pair reads).
constexpr int kGM = 128, kGN = 64, kGK = 32, kGemmThreads = 256;
constexpr int kGemmA = kGM * kGK / kGemmThreads;  // A elements a thread stages a step
constexpr int kGemmB = kGN * kGK / kGemmThreads;  // B elements
constexpr int kNoRow = -(1 << 30);                // a row past M: every t' out of range

template <bool kBf>
struct GemmTile {
  static constexpr int lda = kBf ? kGM + 4 : kGM + 8;
  static constexpr int ldb = kBf ? kGK + 8 : kGK + 4;
  static constexpr int stage = kGK * lda + kGN * ldb;  // floats
  static constexpr size_t smem = sizeof(float) * 2 * stage;
};

template <bool kBf>
__device__ __forceinline__ float load(const void* p, long long i) {
  if constexpr (kBf) return __bfloat162float(static_cast<const bf16*>(p)[i]);
  else return static_cast<const float*>(p)[i];
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = ptx::tf32_rna(x[i]);
    lo[i] = ptx::tf32_rna(x[i] - __uint_as_float(hi[i]));
  }
}

// the three passes of one m16n8k8 step, small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  ptx::mma_tf32(d, al, bh);
  ptx::mma_tf32(d, ah, bl);
  ptx::mma_tf32(d, ah, bh);
}

// One block per 128 x 64 output tile, two blocks an SM (at most 128
// registers a thread: one block of the fp32 kernel's 156 left the loads'
// latency exposed, 1.9 ms against 1.3 ms for the tail at C = 96). Each thread fetches its elements of the
// next K step into registers (each element by its own address: the two-level
// row, the im2col shift, zero outside the rows and past K) while the block's
// warps run this step's products from shared memory, then stores them into
// the other stage: one barrier a step. A is read with the thread index along
// m where A's time stride is the smaller one (channels-first: each warp reads
// 32 consecutive time rows), else along k. Each K step of 32 sums into a
// fresh accumulator, added to the fp32 total with a rounded add (fp32 3xTF32:
// the tensor core's own adds truncate, tc_gemm.cuh).
template <bool kBf, int kTaps>
__global__ void __launch_bounds__(kGemmThreads, 2) gemm_kernel(const GemmArgs g) {
  using L = GemmTile<kBf>;
  extern __shared__ __align__(16) float smem_gemm[];
  __shared__ long long row_off[kGM];  // b a_sb + t a_st of each row of the tile
  __shared__ int row_t[kGM];          // its t, kNoRow past M
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2, gq = lane >> 2, tq = lane & 3;
  const long long m0 = static_cast<long long>(blockIdx.x) * kGM;
  const int n0 = blockIdx.y * kGN;
  for (int r = tid; r < kGM; r += kGemmThreads) {
    const long long m = m0 + r;
    const bool in = m < g.M;
    const long long bb = in ? m / g.a_rows : 0;
    const int t = in ? static_cast<int>(m - bb * g.a_rows) : 0;
    row_t[r] = in ? t : kNoRow;
    row_off[r] = bb * g.a_sb + t * g.a_st;
  }
  __syncthreads();
  const bool mfast = g.a_sk != 1;  // channels-first A: t is the contiguous axis

  auto a_at = [&](int r, int k) -> float {
    if (k >= g.K) return 0.0f;
    int c = k, sh = 0;
    if constexpr (kTaps > 1) {
      c = k / kTaps;
      sh = (k - c * kTaps - kTaps / 2) * g.dil;
    }
    const int t = row_t[r] + sh;
    if (t < 0 || t >= g.a_rows) return 0.0f;
    return load<kBf>(g.a, row_off[r] + sh * g.a_st + c * g.a_sk);
  };
  float ra[kGemmA], rb[kGemmB];
  auto fetch = [&](int k0) {
    if (mfast) {
      const int r = tid % kGM;
#pragma unroll
      for (int i = 0; i < kGemmA; ++i) ra[i] = a_at(r, k0 + tid / kGM + 2 * i);
    } else {
#pragma unroll
      for (int i = 0; i < kGemmA; ++i) ra[i] = a_at(tid / kGK + 8 * i, k0 + tid % kGK);
    }
    const int k = k0 + tid % kGK;
#pragma unroll
    for (int i = 0; i < kGemmB; ++i) {
      const int n = n0 + tid / kGK + 8 * i;
      float v = 0.0f;
      if (k < g.K && n < g.N) {
        const long long e = static_cast<long long>(n) * g.K + k;
        v = load<kBf>(g.b, e);
        if (!kBf && g.b_lo) v += g.b_lo[e];
      }
      rb[i] = v;
    }
  };
  auto put = [&](int s) {
    float* sa = smem_gemm + s * L::stage;
    float* sb = sa + kGK * L::lda;
    if (mfast) {
#pragma unroll
      for (int i = 0; i < kGemmA; ++i) sa[(tid / kGM + 2 * i) * L::lda + tid % kGM] = ra[i];
    } else {
#pragma unroll
      for (int i = 0; i < kGemmA; ++i) sa[(tid % kGK) * L::lda + tid / kGK + 8 * i] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kGemmB; ++i) sb[(tid / kGK + 8 * i) * L::ldb + tid % kGK] = rb[i];
  };

  float sum[2][4][4], acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[mt][nt][i] = 0.0f;
  const int steps = (g.K + kGK - 1) / kGK;
  fetch(0);
  put(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) fetch((s + 1) * kGK);  // in flight during the products
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    const float* sa = smem_gemm + (s & 1) * L::stage + wm * 32 + gq;
    const float* sb = smem_gemm + (s & 1) * L::stage + kGK * L::lda + (wn * 32 + gq) * L::ldb;
    if constexpr (kBf) {
#pragma unroll
      for (int ks = 0; ks < kGK / 16; ++ks) {
        uint32_t af[2][4], bfr[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* p = sa + (16 * ks + 2 * tq) * L::lda + 16 * mt;  // rows k = 2t, 2t + 1
          af[mt][0] = ptx::bf16x2_rn(p[0], p[L::lda]);
          af[mt][1] = ptx::bf16x2_rn(p[8], p[L::lda + 8]);
          af[mt][2] = ptx::bf16x2_rn(p[8 * L::lda], p[9 * L::lda]);
          af[mt][3] = ptx::bf16x2_rn(p[8 * L::lda + 8], p[9 * L::lda + 8]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* q = sb + 8 * nt * L::ldb + 16 * ks + 2 * tq;
          const float2 lo = *reinterpret_cast<const float2*>(q);
          const float2 hi = *reinterpret_cast<const float2*>(q + 8);
          bfr[nt][0] = ptx::bf16x2_rn(lo.x, lo.y);
          bfr[nt][1] = ptx::bf16x2_rn(hi.x, hi.y);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) ptx::mma_bf16(acc[mt][nt], af[mt], bfr[nt]);
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kGK / 8; ++ks) {
        uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* p = sa + (8 * ks + tq) * L::lda + 16 * mt;
          const float x[4] = {p[0], p[8], p[4 * L::lda], p[4 * L::lda + 8]};
          split(x, ah[mt], al[mt]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* q = sb + 8 * nt * L::ldb + 8 * ks + tq;
          const float y[2] = {q[0], q[4]};
          split(y, bh[nt], bl[nt]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma3(acc[mt][nt], ah[mt], al[mt], bh[nt], bl[nt]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[mt][nt][i] += acc[mt][nt][i];
    if (s + 1 < steps) put((s + 1) & 1);
    __syncthreads();
  }

  // lane (g, t) holds rows g and g + 8, columns 2t and 2t + 1 of each tile
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wm * 32 + 16 * mt + gq + 8 * h;
      if (m >= g.M) continue;
      const long long orow = row_at(m, g.o_rows, g.o_sb, g.o_st);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + wn * 32 + 8 * nt + 2 * tq + j;
          if (n >= g.N) continue;
          float v = sum[mt][nt][2 * h + j];
          if (g.bias) v += g.bias[n];
          if (g.act == 1)
            v = l3ac::snake(v, g.alpha[n]);
          else if (g.act == 2)
            v = l3ac::gelu(v);
          else if (g.act == 3)
            v = tanhf(v);
          const long long o = orow + n * g.o_sn;
          if (g.res) {
            if (g.round_mid) v = l3ac::round_bf16(v);
            v = ld(g.res, o, g.res_bf) + v;
          }
          st(g.out, o, v, g.o_bf);
        }
      }
    }
  }
}

// ------------------------------------------------- block sums of one row

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

// ----------------------------------------------------------- attention

struct AttnArgs {
  const void *q, *k, *v, *kp, *pk, *pv;  // q, k, v, kp: (B, H, T, D) by strides; pk, pv (B, H, n, D)
  const void* bias;   // (H, n, 2n), or null
  const void* table;  // (2n, H), or null
  void* out;          // (B, T, H, D)
  long long qs[3], ks[3], vs[3], kps[3];
  long long BH;        // batch * heads
  int H, T, n, D, mask_first;
  int piece;          // bytes a copy stages: 16, 4 (any fp32; bf16 pairs), 2 (bf16 elements)
  int nslab;          // O's column slabs (blocks that share a query tile)
  float scale;
};

// One block per (64 query rows, O's column slab, window, batch * head): 8
// warps, two per 16 query rows, each of the two taking 32 of every 64-key
// tile with its own online softmax, merged at the end (twice the warps of
// one warp per row group, half its S registers). Per key tile: S = (q
// scale) K^T over D in chunks of 64 columns (each chunk's q and K rows
// staged together), the softmax in registers, then O += P V over the slab
// in chunks of 64 columns, every chunk one stage of a two-stage cp.async
// ring.
constexpr int kAThreads = 256, kARows = 64, kAKeys = 64, kAChunk = 64;
constexpr int kMaxOT = 32;  // n8 tiles of O a thread block holds in registers: 256 columns

template <bool kBf>
struct AttnTile {
  // row strides in staged elements: ldmatrix reads 8 rows of 16 bytes (4
  // words apart mod 32); fp32 V is read as B fragments V[t][g] (8 mod 32)
  static constexpr int lqk = kBf ? kAChunk + 8 : kAChunk + 4;
  static constexpr int lv = kAChunk + 8;
  static constexpr int stage = 2 * kARows * lqk;  // q and K chunks; a V chunk fits
  static_assert(kAKeys * lv <= stage, "a V chunk fits a stage");
};

template <bool kBf>
constexpr int kRingBytes = (kBf ? 2 : 4) * 2 * AttnTile<kBf>::stage;  // two stages

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename E>
__device__ __forceinline__ E to_e(float v) {
  if constexpr (std::is_same_v<E, bf16>) return __float2bfloat16_rn(v);
  else return v;
}

__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t p, float s) {
  return ptx::bf16x2_rn(__uint_as_float(p << 16) * s, __uint_as_float(p & 0xffff0000u) * s);
}

// kOT n8 tiles of O (the slab's columns, zero past D) in registers.
// fp32: both products as 3xTF32 m16n8k8 with the fast kernel's key order
// sigma in S's tiles (local_attention.cu), so that S's accumulator is P's A
// fragment; P V sums each 32 keys in a fresh accumulator. bf16: m16n8k16,
// q scaled in bf16 (the plain version's rounding), K by ldmatrix, V by
// ldmatrix.trans, a first pass for each row's max and sum (merged over the
// two key halves), then P = exp(s - max) / sum rounded to bf16 from S's
// accumulator (its A layout).
template <bool kBf, int kOT>
__global__ void __launch_bounds__(kAThreads) attention_kernel(const AttnArgs a) {
  using E = std::conditional_t<kBf, bf16, float>;
  using L = AttnTile<kBf>;
  constexpr int kNV = (kOT + 7) / 8;  // V chunks of the slab
  extern __shared__ __align__(16) unsigned char smem_attn[];
  E* ring = reinterpret_cast<E*>(smem_attn);
  const int n = a.n, D = a.D, W = a.T / n, nqt = (n + kARows - 1) / kARows;
  // work items longest first (local_attention.py:general_work_item is the
  // host twin): the windows w >= 1 (n keys more than window 0), then window
  // 0, each from the last query tile to the first, so that a second wave
  // holds the shortest blocks
  const long long per = static_cast<long long>(a.nslab) * a.BH, rest = (W - 1) * per;
  long long idx = blockIdx.x, r;
  int qt, w;
  if (idx < nqt * rest) {
    qt = nqt - 1 - static_cast<int>(idx / rest);
    r = idx % rest;
    w = 1 + static_cast<int>(r / per);
    r %= per;
  } else {
    idx -= nqt * rest;
    qt = nqt - 1 - static_cast<int>(idx / per);
    r = idx % per;
    w = 0;
  }
  const int sl = static_cast<int>(r / a.BH);
  const long long bh = r % a.BH;
  const int b = static_cast<int>(bh / a.H), h = static_cast<int>(bh % a.H);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = qt * kARows, d0 = sl * 8 * kOT;
  const int rows = min(kARows, n - i0);
  const int j_begin = w == 0 && a.mask_first ? n : 0;
  const int j_end = n + i0 + rows;  // one past the last row's last key
  const int ntiles = (j_end - j_begin + kAKeys - 1) / kAKeys;
  const int nqk = (D + kAChunk - 1) / kAChunk;
  const int nv = (min(8 * kOT, D - d0) + kAChunk - 1) / kAChunk;
  const int stats = kBf ? ntiles * nqk : 0;  // bf16: the first pass's items (S alone)
  const int per_tile = nqk + nv, total = stats + ntiles * per_tile;
  const long long q_row0 = static_cast<long long>(w) * n + i0;  // time of query row 0
  const long long k_row0 = static_cast<long long>(w) * n - n;   // time of key j = 0
  const E* qb = static_cast<const E*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const E* kb = static_cast<const E*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const E* vb = static_cast<const E*>(a.v) + b * a.vs[0] + h * a.vs[1];
  const E* kpb = static_cast<const E*>(a.kp) + b * a.kps[0] + h * a.kps[1];
  const long long p_row0 = bh * n;  // pk / pv row of key j = 0

  // the row of head-dim element 0, or null where the row is zero: query row
  // r < rows; key j of [prev | cur]: j >= n from k / v, j < n of window w >= 1
  // from kp / v, of window 0 from pk / pv
  auto q_row = [&](int r) -> const E* { return r < rows ? qb + (q_row0 + r) * a.qs[2] : nullptr; };
  auto key_row = [&](int j, bool value) -> const E* {
    if (j >= j_end) return nullptr;
    const long long t = k_row0 + j;
    if (j >= n) return value ? vb + t * a.vs[2] : kb + t * a.ks[2];
    if (w > 0) return value ? vb + t * a.vs[2] : kpb + t * a.kps[2];
    return static_cast<const E*>(value ? a.pv : a.pk) + (p_row0 + j) * D;
  };
  // 64 rows x columns [c0, c0 + ncols) into dst (row stride ld; ncols a
  // multiple of 16, the columns the products read), zero past D and in null
  // rows: 16-byte copies, 4-byte ones, or (bf16 at odd offsets) element loads
  auto copy_chunk = [&](E* dst, int ld, int c0, int ncols, auto row_of) {
    if (a.piece == 16 || a.piece == 4) {
      const int per = a.piece / static_cast<int>(sizeof(E)), pieces = ncols / per;
      for (int e = tid; e < 64 * pieces; e += kAThreads) {
        const int r = e / pieces, c = (e - r * pieces) * per;
        const E* src = row_of(r);
        const bool ok = src != nullptr && c0 + c < D;
        if (a.piece == 16)
          ptx::cp_async16(dst + r * ld + c, ok ? src + c0 + c : a.q, ok ? 16 : 0);
        else
          ptx::cp_async4(dst + r * ld + c, ok ? src + c0 + c : a.q, ok ? 4 : 0);
      }
    } else {
      for (int e = tid; e < 64 * ncols; e += kAThreads) {
        const int r = e / ncols, c = e - r * ncols;
        const E* src = row_of(r);
        dst[r * ld + c] = src != nullptr && c0 + c < D ? src[c0 + c] : to_e<E>(0.0f);
      }
    }
  };
  // item c of key tile t: c < nqk the q and K chunk c, else V chunk c - nqk
  // of the slab (bf16: the first pass's tiles first, their q and K chunks)
  auto stage_item = [&](int item) {
    if (item < total) {
      const int k = item < stats ? item : item - stats, span = item < stats ? nqk : per_tile;
      const int t = k / span, c = k - t * span, j0 = j_begin + t * kAKeys;
      E* st = ring + (item & 1) * L::stage;
      if (c < nqk) {  // S's k steps read D rounded up to 16
        const int cols = min(kAChunk, (D - kAChunk * c + 15) / 16 * 16);
        copy_chunk(st, L::lqk, kAChunk * c, cols, q_row);
        copy_chunk(st + kARows * L::lqk, L::lqk, kAChunk * c, cols,
                   [&](int r) { return key_row(j0 + r, false); });
      } else {        // P V reads the slab's 8 kOT columns
        const int v = c - nqk;
        copy_chunk(st, L::lv, d0 + kAChunk * v, min(kAChunk, 8 * kOT - kAChunk * v),
                   [&](int r) { return key_row(j0 + r, true); });
      }
    }
    ptx::cp_async_commit();
  };
  int item = 0;
  // the next item has landed for every thread, the one before it is consumed
  auto advance = [&]() -> const E* {
    ptx::cp_async_wait<0>();
    __syncthreads();
    stage_item(item + 1);
    return ring + (item++ & 1) * L::stage;
  };

  // warp w: query rows 16 (w % 4) .., keys 32 (w / 4) .. of every key tile
  const int g = lane >> 2, t4 = lane & 3, q8 = lane >> 3, r8 = lane & 7;
  const int r0 = 16 * (warp & 3), kh = warp >> 2;
  const int ia = i0 + r0 + g, ib = ia + 8;      // this lane's two query rows
  const int i_last = min(i0 + r0 + 15, n - 1);  // the warp's last real row
  const bool warp_live = i0 + r0 < n;
  // ldmatrix row addresses of q's A fragments and of the warp's K rows' B fragments
  const int q_off = kBf ? (r0 + (lane & 15)) * L::lqk + (lane >> 4) * 8
                        : (r0 + (q8 & 1) * 8 + r8) * L::lqk + (q8 >> 1) * 4;
  const int k_off = (kARows + 32 * kh) * L::lqk +
                    (kBf ? ((lane & 7) + ((lane >> 4) << 3)) * L::lqk + ((lane >> 3) & 1) * 8
                         : ((q8 >> 1) * 8 + (r8 >> 1) + 4 * (r8 & 1)) * L::lqk + (q8 & 1) * 4);

  float o[kOT][4];
#pragma unroll
  for (int dt = 0; dt < kOT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;

  // S of the warp's 32 keys of the key tile from j0 (nqk items), then the
  // mask and the bias; s[nt][e]: row (e < 2 ? ia : ib), key j0 + 8 nt +
  // (fp32: t4 + 4 (e & 1), the order sigma; bf16: 2 t4 + (e & 1))
  auto scores = [&](float (&s)[4][4], int j0, bool live) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
    for (int c = 0; c < nqk; ++c) {
      const E* st = advance();
      if (!live) continue;
      const int cols = min(kAChunk, D - kAChunk * c);  // zero-filled to the k step
      if constexpr (kBf) {
#pragma unroll
        for (int k16 = 0; k16 < kAChunk / 16; ++k16) {
          if (16 * k16 >= cols) break;
          uint32_t qa[4];
          ptx::ldmatrix_x4(qa, st + q_off + 16 * k16);
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = scale_bf16x2(qa[e], a.scale);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t kr[4];
            ptx::ldmatrix_x4(kr, st + k_off + np * 16 * L::lqk + 16 * k16);
            const uint32_t b0[2] = {kr[0], kr[1]}, b1[2] = {kr[2], kr[3]};
            ptx::mma_bf16(s[2 * np], qa, b0);
            ptx::mma_bf16(s[2 * np + 1], qa, b1);
          }
        }
      } else {
#pragma unroll
        for (int k8 = 0; k8 < kAChunk / 8; ++k8) {
          if (8 * k8 >= cols) break;
          uint32_t raw[4], qh[4], ql[4];
          ptx::ldmatrix_x4(raw, st + q_off + 8 * k8);
          float x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) x[e] = __uint_as_float(raw[e]) * a.scale;
          split(x, qh, ql);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            ptx::ldmatrix_x4(raw, st + k_off + np * 16 * L::lqk + 8 * k8);
#pragma unroll
            for (int e = 0; e < 4; ++e) x[e] = __uint_as_float(raw[e]);
            uint32_t hi[4], lo[4];
            split(x, hi, lo);
            const uint32_t bh0[2] = {hi[0], hi[1]}, bl0[2] = {lo[0], lo[1]};
            const uint32_t bh1[2] = {hi[2], hi[3]}, bl1[2] = {lo[2], lo[3]};
            mma3(s[2 * np], qh, ql, bh0, bl0);
            mma3(s[2 * np + 1], qh, ql, bh1, bl1);
          }
        }
      }
    }
    if (!live) return;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? ia : ib;
        const int j = j0 + 8 * nt + (kBf ? 2 * t4 + (e & 1) : t4 + 4 * (e & 1));
        const bool ok = i < n && j <= n + i;
        float x = s[nt][e];
        if (ok && a.table)
          x += load<kBf>(a.table, static_cast<long long>(n + i - j) * a.H + h);
        else if (ok && a.bias)
          x += load<kBf>(a.bias, (static_cast<long long>(h) * n + i) * (2 * n) + j);
        s[nt][e] = ok ? x : -INFINITY;
      }
  };
  // the online softmax's step on a tile's scores: the running max and
  // per-lane partial sums; s becomes exp(s - max); returns the rescale of
  // rows a and b (0 before the first key)
  auto online = [&](float (&s)[4][4], float& c_a, float& c_b) {
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
    const float mu_a = mn_a == -INFINITY ? 0.0f : mn_a;
    const float mu_b = mn_b == -INFINITY ? 0.0f : mn_b;
    c_a = expf(m_a - mu_a);
    c_b = expf(m_b - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - (e < 2 ? mu_a : mu_b));  // masked: exp(-inf) = 0
        s[nt][e] = p;
        if (e < 2) ps_a += p;
        else ps_b += p;
      }
    l_a = l_a * c_a + ps_a;  // per-lane partial sums; the quad adds them
    l_b = l_b * c_b + ps_b;
  };

  stage_item(0);
  if constexpr (kBf) {
    // bf16 first pass: each row's max and sum, of both key halves, so that
    // the second rounds the normalized P = exp(s - max) / sum to bf16 where
    // the plain version does
    for (int tile = 0; tile < ntiles; ++tile) {
      const int j0 = j_begin + tile * kAKeys + 32 * kh;
      const bool live = warp_live && j0 <= n + i_last;
      float s[4][4], c_a, c_b;
      scores(s, j0, live);
      if (live) online(s, c_a, c_b);
    }
    float* xst = reinterpret_cast<float*>(smem_attn + kRingBytes<kBf>);  // [half][row]: max, sum
    const float sl_a = quad_sum(l_a), sl_b = quad_sum(l_b);
    if (t4 == 0) {
      xst[2 * (kh * kARows + r0 + g)] = m_a;
      xst[2 * (kh * kARows + r0 + g) + 1] = sl_a;
      xst[2 * (kh * kARows + r0 + g + 8)] = m_b;
      xst[2 * (kh * kARows + r0 + g + 8) + 1] = sl_b;
    }
    __syncthreads();
    const float* other = xst + 2 * ((1 - kh) * kARows + r0 + g);
    auto merged = [](float m0, float l0, float m1, float l1, float& m, float& l) {
      const float mx = fmaxf(m0, m1), mu = mx == -INFINITY ? 0.0f : mx;
      m = mu;
      l = l0 * expf(m0 - mu) + l1 * expf(m1 - mu);
    };
    merged(m_a, sl_a, other[0], other[1], m_a, l_a);
    merged(m_b, sl_b, other[16], other[17], m_b, l_b);
  }
  for (int tile = 0; tile < ntiles; ++tile) {
    const int j0 = j_begin + tile * kAKeys + 32 * kh;  // the warp's first key
    const bool live = warp_live && j0 <= n + i_last;   // warp-uniform: some key valid
    float s[4][4];
    scores(s, j0, live);
    if (live) {
      if constexpr (kBf) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[nt][e] = expf(s[nt][e] - (e < 2 ? m_a : m_b)) / (e < 2 ? l_a : l_b);
      } else {
        float c_a, c_b;
        online(s, c_a, c_b);
#pragma unroll
        for (int dt = 0; dt < kOT; ++dt) {
          o[dt][0] *= c_a;
          o[dt][1] *= c_a;
          o[dt][2] *= c_b;
          o[dt][3] *= c_b;
        }
      }
    }

    // O += P V over the warp's 32 keys, one V chunk of 64 columns (8 of O's
    // n8 tiles) at a time
#pragma unroll
    for (int vc = 0; vc < kNV; ++vc) {
      if (vc >= nv) break;
      const E* vt = advance() + 32 * kh * L::lv;
      if (!live) continue;
      if constexpr (kBf) {
        // P's A fragment of k16 step kk: S tiles 2 kk and 2 kk + 1, rounded
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint32_t pa[4] = {ptx::bf16x2_rn(s[2 * kk][0], s[2 * kk][1]),
                                  ptx::bf16x2_rn(s[2 * kk][2], s[2 * kk][3]),
                                  ptx::bf16x2_rn(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                  ptx::bf16x2_rn(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int dp = 0; dp < 4; ++dp) {
            const int dt = 8 * vc + 2 * dp;
            if (dt >= kOT) break;
            uint32_t vr[4];
            ptx::ldmatrix_x4_trans(vr, vt + (16 * kk + (lane & 15)) * L::lv + 16 * dp +
                                           (lane >> 4) * 8);
            const uint32_t b0[2] = {vr[0], vr[1]}, b1[2] = {vr[2], vr[3]};
            ptx::mma_bf16(o[dt], pa, b0);
            ptx::mma_bf16(o[dt + 1], pa, b1);
          }
        }
      } else {
        // s[kk] is P's A fragment of k8 step kk: {P[g][t], P[g+8][t],
        // P[g][t+4], P[g+8][t+4]} = s[kk][0, 2, 1, 3]; the 32 keys sum into
        // a fresh accumulator
        uint32_t ph[4][4], pl[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float pa[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
          split(pa, ph[kk], pl[kk]);
        }
#pragma unroll
        for (int dl = 0; dl < 8; ++dl) {
          const int dt = 8 * vc + dl;
          if (dt >= kOT) break;
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const E* vr = vt + (kk * 8 + t4) * L::lv + 8 * dl + g;
            const float vv[2] = {vr[0], vr[4 * L::lv]};
            uint32_t vh[2], vl[2];
            split(vv, vh, vl);
            mma3(acc, ph[kk], pl[kk], vh, vl);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) o[dt][e] += acc[e];
        }
      }
    }
  }

  // the two key halves of each row group merged: the warps of keys 32 ..
  // hand their O (fp32: with their max and sum) to those of keys 0 ..
  // through shared memory (the ring is consumed), which add them (fp32:
  // rescaled to the common max, then divided by the sum) and store out[b,
  // t, h, d0 + ...]; lane (g, t4) holds columns 2 t4, 2 t4 + 1 of each n8
  // tile of rows ia and ib
  ptx::cp_async_wait<0>();
  __syncthreads();
  constexpr int kXo = 8 * kOT + 4;  // floats a row of the exchange
  float* xo = reinterpret_cast<float*>(smem_attn);
  float* xs = xo + kARows * kXo;    // per row: max, sum
  const float sl_a = kBf ? l_a : quad_sum(l_a), sl_b = kBf ? l_b : quad_sum(l_b);
  if (kh == 1) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + g + 8 * hf;
#pragma unroll
      for (int dt = 0; dt < kOT; ++dt) {
        xo[r * kXo + 8 * dt + 2 * t4] = o[dt][2 * hf];
        xo[r * kXo + 8 * dt + 2 * t4 + 1] = o[dt][2 * hf + 1];
      }
      if (t4 == 0) {
        xs[2 * r] = hf ? m_b : m_a;
        xs[2 * r + 1] = hf ? sl_b : sl_a;
      }
    }
  }
  __syncthreads();
  if (kh == 1) return;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g + 8 * hf, i = i0 + r;
    if (i >= n) continue;
    float c0 = 1.0f, c1 = 1.0f, inv = 1.0f;  // bf16: P was normalized
    if constexpr (!kBf) {
      const float m0 = hf ? m_b : m_a, m1 = xs[2 * r];
      const float mx = fmaxf(m0, m1), mu = mx == -INFINITY ? 0.0f : mx;
      c0 = expf(m0 - mu);
      c1 = expf(m1 - mu);
      inv = 1.0f / ((hf ? sl_b : sl_a) * c0 + xs[2 * r + 1] * c1);
    }
    E* orow = static_cast<E*>(a.out) +
              ((static_cast<long long>(b) * a.T + static_cast<long long>(w) * n + i) * a.H + h) *
                  D;
#pragma unroll
    for (int dt = 0; dt < kOT; ++dt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = d0 + 8 * dt + 2 * t4 + j;
        const float v = o[dt][2 * hf + j] * c0 + xo[r * kXo + 8 * dt + 2 * t4 + j] * c1;
        if (d < D) orow[d] = to_e<E>(v * inv);
      }
  }
}

// ---------------------------------------------------------------- tail

struct TailIn {
  const void* x0;  // x(b, c, t) = x0[b sb + c sc + t], or with x1 the phase
  const void* x1;  // pair: x_{t % 2}[b sb + c sc + t / 2]
  long long sb, sc;
};

__device__ __forceinline__ float tail_in(const TailIn& x, int b, int c, int t, int bf) {
  const long long base = b * x.sb + c * x.sc;
  if (x.x1) return ld(t & 1 ? x.x1 : x.x0, base + (t >> 1), bf);
  return ld(x.x0, base + t, bf);
}

struct SnakeArgs {
  TailIn x;
  const float* alpha;  // (C,)
  void* out;           // (B, C, T) contiguous
  void* copy;          // (B, C, T): x itself, or null
  int B, C, T, bf;
};

__global__ void snake_kernel(SnakeArgs a) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(a.B) * a.C * a.T) return;
  const int t = static_cast<int>(e % a.T);
  const int c = static_cast<int>((e / a.T) % a.C);
  const int b = static_cast<int>(e / (static_cast<long long>(a.T) * a.C));
  const float v = tail_in(a.x, b, c, t, a.bf);
  st(a.out, e, l3ac::snake(v, a.alpha[c]), a.bf);
  if (a.copy) st(a.copy, e, v, a.bf);
}

int blocks_for(long long n, int threads) { return l3ac::ceil_div(n, threads); }

template <bool kBf, int kTaps>
cudaError_t launch_gemm_as(const GemmArgs& g, cudaStream_t stream) {
  auto kernel = gemm_kernel<kBf, kTaps>;
  constexpr size_t smem = GemmTile<kBf>::smem;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((g.M + kGM - 1) / kGM), l3ac::ceil_div(g.N, kGN));
  kernel<<<grid, kGemmThreads, smem, stream>>>(g);
  return cudaGetLastError();
}

cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  if (g.M < 1 || g.N < 1 || g.K < 1 || g.a_rows < 1 || g.o_rows < 1 ||
      (g.taps != 1 && g.taps != 7) || g.a_bf != g.b_bf || (g.b_lo && g.b_bf) ||
      (g.act == 1 && !g.alpha) || l3ac::ceil_div(g.N, kGN) > 65535 ||
      (g.M + kGM - 1) / kGM > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (g.taps == 7) return g.a_bf ? launch_gemm_as<true, 7>(g, stream) : launch_gemm_as<false, 7>(g, stream);
  return g.a_bf ? launch_gemm_as<true, 1>(g, stream) : launch_gemm_as<false, 1>(g, stream);
}

template <bool kBf, int kOT>
cudaError_t launch_attention_as(const AttnArgs& a, long long blocks, cudaStream_t stream) {
  auto kernel = attention_kernel<kBf, kOT>;
  // the ring (bf16: and the first pass's row statistics behind it), then
  // the halves' exchange of O in the same memory
  constexpr size_t ring = kRingBytes<kBf> + (kBf ? sizeof(float) * 2 * kARows * 2 : 0);
  constexpr size_t merge = sizeof(float) * kARows * (8 * kOT + 4 + 2);
  constexpr size_t smem = ring > merge ? ring : merge;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kAThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// O's n8 tiles a block holds: D's in slabs of at most kMaxOT tiles, each the
// instantiation at or above its share
template <bool kBf>
cudaError_t launch_attention(AttnArgs a, int B, cudaStream_t stream) {
  const int d8 = (a.D + 7) / 8;
  const int slabs = (d8 + kMaxOT - 1) / kMaxOT, per = (d8 + slabs - 1) / slabs;
  const int ot = per <= 2 ? 2 : per <= 4 ? 4 : per <= 8 ? 8 : per <= 16 ? 16 : per <= 24 ? 24 : 32;
  a.nslab = (d8 + ot - 1) / ot;
  const long long blocks = static_cast<long long>(B) * a.H * (a.T / a.n) * a.nslab *
                           ((a.n + kARows - 1) / kARows);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  switch (ot) {
    case 2: return launch_attention_as<kBf, 2>(a, blocks, stream);
    case 4: return launch_attention_as<kBf, 4>(a, blocks, stream);
    case 8: return launch_attention_as<kBf, 8>(a, blocks, stream);
    case 16: return launch_attention_as<kBf, 16>(a, blocks, stream);
    case 24: return launch_attention_as<kBf, 24>(a, blocks, stream);
    default: return launch_attention_as<kBf, 32>(a, blocks, stream);
  }
}

bool aligned_to(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// C = act(A B^T + bias) (+ residual), the general route's product; see GemmArgs.
extern "C" int l3ac_general_gemm(const void* a, long long a_sb, long long a_st, long long a_sk,
                                 int a_rows, int a_bf, const void* b, const float* b_lo, int b_bf,
                                 const float* bias, const float* alpha, int act, const void* res,
                                 int res_bf, int round_mid, void* out, long long o_sb,
                                 long long o_st, long long o_sn, int o_rows, int o_bf,
                                 long long M, int N, int K, void* stream) {
  const GemmArgs g{a, a_sb, a_st, a_sk, a_rows, a_bf, 1, 1, b, b_lo, b_bf, bias, alpha, act,
                   res, res_bf, round_mid, out, o_sb, o_st, o_sn, o_rows, o_bf, M, N, K};
  return launch_gemm(g, static_cast<cudaStream_t>(stream));
}

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

// Block-local causal attention at any head dim and any element strides;
// strides: q, k, v, kp (B, H, T each); see AttnArgs.
extern "C" int l3ac_general_attention(const void* q, const void* k, const void* v, const void* kp,
                                      const void* pk, const void* pv, const void* bias,
                                      const void* table, void* out, int B, int H, int T, int n,
                                      int D, int left_edge, const long long* strides, int bf,
                                      float scale, void* stream) {
  if (B < 1 || H < 1 || n < 1 || T < n || T % n || D < 1 || (pk == nullptr) != (pv == nullptr) ||
      (bias != nullptr && table != nullptr))
    return cudaErrorInvalidValue;
  AttnArgs a{q, k, v, kp, pk, pv, bias, table, out, {}, {}, {}, {},
             static_cast<long long>(B) * H, H, T, n, D, pk == nullptr || left_edge != 0, 0, 1,
             scale};
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.kps[i] = kp ? strides[9 + i] : strides[3 + i];
  }
  if (kp == nullptr) a.kp = k;
  // the widest copy every row admits: 16 bytes where every row start is
  // 16-byte aligned and D a multiple of the piece, 4 bytes (fp32 always;
  // bf16 pairs at even offsets), else bf16 element by element
  const int per = bf ? 8 : 4;
  bool v16 = D % per == 0, v4 = !bf || D % 2 == 0;
  for (int i = 0; i < 12; ++i) {
    v16 = v16 && strides[i] % per == 0;
    v4 = v4 && (!bf || strides[i] % 2 == 0);
  }
  for (const void* p : {q, k, v, a.kp, pk, pv}) {
    if (p == nullptr) continue;
    v16 = v16 && aligned_to(p, 16);
    v4 = v4 && aligned_to(p, 4);
  }
  a.piece = v16 ? 16 : v4 ? 4 : 2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf ? launch_attention<true>(a, B, s) : launch_attention<false>(a, B, s);
}

// The legacy tail at any C: 3 x [x + 1x1(snake(k7_d(snake x)))] -> snake ->
// k7 C -> 1 -> tanh. x0 (and x1: the phase pair) (B, C, Tin) with batch /
// channel strides sb, sc; w1 (3, C, C, 7), w2 (3, C, C), wo (1, C, 7) in the
// activations' dtype; vec fp32 (3, C) a1, b1, a2, b2, then (C) ao and bo;
// xbuf, hbuf, sbuf (B, C, T) scratch of the activations' dtype; out (B, T).
// Each snake is an elementwise pass (the first one also copies x into xbuf,
// the residual stream), each conv one product (a k7 conv by im2col
// addresses), the residual and the bf16 roundings in its epilogue.
extern "C" int l3ac_general_tail(const void* x0, const void* x1, long long sb, long long sc,
                                 const void* w1, const void* w2, const void* wo,
                                 const float* vec, void* xbuf, void* hbuf, void* sbuf, void* out,
                                 int B, int C, int T, int bf, void* stream) {
  if (B < 1 || C < 1 || T < 1 || static_cast<long long>(B) * C * T > 0x7fffffffffLL)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kThreads = 256;
  const long long cT = static_cast<long long>(C) * T, M = static_cast<long long>(B) * T;
  const int grid = blocks_for(static_cast<long long>(B) * cT, kThreads);
  const TailIn in{x0, x1, sb, sc}, xb{xbuf, nullptr, cT, T}, hb{hbuf, nullptr, cT, T};
  const float *a1 = vec, *b1 = vec + 3 * C, *a2 = vec + 6 * C, *b2 = vec + 9 * C;
  const float *ao = vec + 12 * C, *bo = vec + 13 * C;
  const int es = bf ? 2 : 4;
  constexpr int kDil[3] = {1, 3, 9};
  // a conv of sbuf (B, C, T) into (B, N, T) rows (b, t) of the output map
  auto conv = [&](const void* w, int N, int taps, int dil, const float* bias, int act,
                  const void* res, void* o, long long o_sb, long long o_sn) {
    const GemmArgs g{sbuf, cT, 1, T, T, bf, taps, dil, w, nullptr, bf, bias, nullptr, act, res,
                     bf, res ? bf : 0, o, o_sb, 1, o_sn, T, bf, M, N, C * taps};
    return launch_gemm(g, s);
  };
  cudaError_t err;
  for (int u = 0; u < 3; ++u) {
    snake_kernel<<<grid, kThreads, 0, s>>>(
        SnakeArgs{u == 0 ? in : xb, a1 + u * C, sbuf, u == 0 ? xbuf : nullptr, B, C, T, bf});
    err = conv(static_cast<const char*>(w1) + static_cast<long long>(u) * C * C * 7 * es, C, 7,
               kDil[u], b1 + u * C, 0, nullptr, hbuf, cT, T);
    if (err != cudaSuccess) return err;
    snake_kernel<<<grid, kThreads, 0, s>>>(SnakeArgs{hb, a2 + u * C, sbuf, nullptr, B, C, T, bf});
    err = conv(static_cast<const char*>(w2) + static_cast<long long>(u) * C * C * es, C, 1, 1,
               b2 + u * C, 0, xbuf, xbuf, cT, T);
    if (err != cudaSuccess) return err;
  }
  snake_kernel<<<grid, kThreads, 0, s>>>(SnakeArgs{xb, ao, sbuf, nullptr, B, C, T, bf});
  err = conv(wo, 1, 7, 1, bo, 3, nullptr, out, T, 0);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
