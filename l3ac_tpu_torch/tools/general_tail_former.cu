// The general tail's former design, kept for comparison: each
// snake an elementwise SIMT pass into a scratch buffer (snake_kernel), each
// of the seven convs one launch of the former general product (gemm_kernel:
// every A element fetched by its own address, the k7 conv's im2col by
// address, bf16 staged as fp32, 64-column tiles), 14 launches a tail.
// The port runs csrc/general_gemm.cu (7 launches, the snakes in its
// prologue); tools/general_tail_variants.py times the two in one call. Same
// C entry points as the port's former csrc/general.cu had:
// l3ac_general_gemm (the product) and l3ac_general_tail.
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
