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
// - gemm: a tiled SIMT product, 128 x 128 outputs a block (8 x 8 a thread),
//   K in steps of 8 through shared memory, any M, N, K; rows of A by a
//   two-level address (batch, time) with any strides, so both activation
//   layouts are read in place, and K optionally split into (channel, tap)
//   so that a SAME-padded k-tap conv is one product (im2col by address);
//   bias, snake, exact GELU or tanh, and a residual in the epilogue; bf16 or
//   fp32 operands and output, fp32 sums. The ConvUnit's two products, the
//   up path's 1x1 conv and the tail's convs.
// - dw_norm: the ConvUnit's depthwise conv and ChannelNorm, one block per
//   (batch, time) row looping over C in three passes (mean, variance,
//   output), the conv recomputed per pass, so no row buffer bounds C.
// - up_blend_norm: the up path's linear upsample phase and ChannelNorm over
//   Co, one block per output row, stored at its interleaved address
//   (either layout, phase_split) as up_fused.cu's stores are.
// - attention: one warp per 4 consecutive query rows of a window, their q
//   and O in shared memory; the scores of 32 keys at a time by lanes over
//   the head dim (each key row read by the warp at once, once for the 4
//   rows) and a transpose through shared memory, the softmax's max and sum
//   in a first pass, P = exp(s - max) / sum in a second pass, then O by
//   lanes over the head dim, so any D and any element strides (rows need no
//   alignment: every load is one element).
// - snake: the legacy tail's snakes, elementwise (the phase pair read in
//   place); its convs are gemm's (any C).
//
// Rounding: where the bf16 plain versions round (ops/kernels/*.py), these
// do: bf16 operands with fp32 sums, the snake or GELU in fp32 then rounded
// where the plain version stores bf16. fp32 is exact fp32 (no TF32).
// Right before fast: these are the fallback-free routes of the shape rule,
// not tuned (PERF.md §6 gives their times).
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

__device__ __forceinline__ float rnd(float v, int bf) { return bf ? l3ac::round_bf16(v) : v; }

// row m of a (batch, time) row space with `rows` rows a batch
__device__ __forceinline__ long long row_at(long long m, int rows, long long sb, long long st_) {
  return (m / rows) * sb + (m % rows) * st_;
}

// ---------------------------------------------------------------- gemm

constexpr int kTM = 128, kTN = 128, kTK = 8, kGemmThreads = 256;
static_assert(kGemmThreads / kTK * 4 == kTM && kTM == kTN && kGemmThreads == 16 * 16,
              "each thread loads 4 rows of A and of B a step and owns 8 x 8 outputs");

struct GemmArgs {
  // A(m, k) with m = (b, t), b = m / a_rows, t = m % a_rows, and k = (c, tap),
  // c = k / taps, tap = k % taps: a[b a_sb + t' a_st + c a_sk] at
  // t' = t + (tap - taps / 2) dil, zero outside [0, a_rows) (taps 1: a plain
  // product; taps 7: a SAME-padded k7 conv as one product, im2col by address)
  const void* a;
  long long a_sb, a_st, a_sk;
  int a_rows, a_bf, taps, dil;
  const void* b;     // (N, K) row-major, bf16 or fp32
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

// 128 x 128 outputs a block, 8 x 8 a thread (rows 8 ty + i, columns 8 tx + j:
// each k's 8 values of A and of B a thread reads are contiguous, two 16-byte
// shared-memory loads each), K in steps of 8 through shared memory. Each thread
// loads one k of a step (tid % 8) for 4 rows of A and 4 of B, their row
// addresses computed once (no division in the K loop but k's by the taps),
// and loads the next step into registers while the block computes this one
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(GemmArgs g) {
  __shared__ __align__(16) float as[kTK][kTM + 4];
  __shared__ __align__(16) float bs[kTK][kTN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lk = tid % kTK, lr = tid / kTK;   // this thread's k and first row of a step
  const long long m0 = static_cast<long long>(blockIdx.x) * kTM;
  const int n0 = blockIdx.y * kTN;
  long long a_base[4];
  int a_t[4];
  for (int r = 0; r < 4; ++r) {
    const long long m = m0 + lr + 32 * r;
    a_t[r] = m < g.M ? static_cast<int>(m % g.a_rows) : -(1 << 30);  // rows past M read 0
    a_base[r] = (m / g.a_rows) * g.a_sb;
  }
  float na[4], nb[4];  // the next step's values
  auto fetch = [&](int k0) {
    const int k = k0 + lk;
    const bool kin = k < g.K;
    const int c = g.taps == 1 ? k : k / g.taps;
    const int shift = g.taps == 1 ? 0 : (k - c * g.taps - g.taps / 2) * g.dil;
    for (int r = 0; r < 4; ++r) {
      const int t = a_t[r] + shift;
      na[r] = kin && t >= 0 && t < g.a_rows
                  ? ld(g.a, a_base[r] + t * g.a_st + c * g.a_sk, g.a_bf)
                  : 0.0f;
      const int n = n0 + lr + 32 * r;
      float v = 0.0f;
      if (kin && n < g.N) {
        const long long i = static_cast<long long>(n) * g.K + k;
        v = ld(g.b, i, g.b_bf);
        if (g.b_lo) v += g.b_lo[i];
      }
      nb[r] = v;
    }
  };
  float acc[8][8];
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  fetch(0);
  for (int k0 = 0; k0 < g.K; k0 += kTK) {
    for (int r = 0; r < 4; ++r) {
      as[lk][lr + 32 * r] = na[r];
      bs[lk][lr + 32 * r] = nb[r];
    }
    __syncthreads();
    if (k0 + kTK < g.K) fetch(k0 + kTK);
    for (int kk = 0; kk < kTK; ++kk) {
      float ra[8], rb[8];
      for (int i = 0; i < 8; ++i) ra[i] = as[kk][8 * ty + i];
      for (int j = 0; j < 8; ++j) rb[j] = bs[kk][8 * tx + j];
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + 8 * ty + i;
    if (m >= g.M) continue;
    const long long orow = row_at(m, g.o_rows, g.o_sb, g.o_st);
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 8 * tx + j;
      if (n >= g.N) continue;
      float v = acc[i][j];
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

constexpr int kAttnWarps = 2;
constexpr int kQ = 4;  // query rows a warp: consecutive rows of one window, sharing each key load

// a warp's shared floats: q and O of its kQ rows (D each), P of a chunk (32
// a row), the lanes' max / sum (32), the 32 x 33 partial dot products of a
// chunk of keys for each row
__host__ __device__ constexpr int kAttnWarpFloats(int D) {
  return 2 * kQ * D + 32 * kQ + 32 + kQ * 32 * 33;
}

struct AttnArgs {
  const void *q, *k, *v, *kp, *pk, *pv;  // q, k, v, kp: (B, H, T, D) by strides; pk, pv (B, H, n, D)
  const void* bias;   // (H, n, 2n), or null
  const void* table;  // (2n, H), or null
  void* out;          // (B, T, H, D)
  long long qs[3], ks[3], vs[3], kps[3];
  int B, H, T, n, D, left_edge, bf, warps;
  float scale;
};

__device__ __forceinline__ const void* key_row(const AttnArgs& a, int b, int h, int w, int j,
                                               bool value, long long& off) {
  const int n = a.n;
  if (j >= n) {
    const long long* s = value ? a.vs : a.ks;
    off = b * s[0] + h * s[1] + static_cast<long long>(w * n + j - n) * s[2];
    return value ? a.v : a.k;
  }
  if (w > 0) {
    const long long* s = value ? a.vs : (a.kp ? a.kps : a.ks);
    off = b * s[0] + h * s[1] + static_cast<long long>((w - 1) * n + j) * s[2];
    return value ? a.v : (a.kp ? a.kp : a.k);
  }
  off = ((static_cast<long long>(b) * a.H + h) * n + j) * a.D;
  return value ? a.pv : a.pk;
}

__device__ __forceinline__ float bias_at(const AttnArgs& a, int h, int i, int j) {
  if (a.bias) return ld(a.bias, (static_cast<long long>(h) * a.n + i) * 2 * a.n + j, a.bf);
  if (a.table) return ld(a.table, static_cast<long long>(abs(a.n + i - j)) * a.H + h, a.bf);
  return 0.0f;
}

// the scores of keys c0 .. c0 + 31 (those <= j1) for the warp's nq rows:
// lane l sums the products of its head-dim columns l, l + 32, ... for each
// key of the chunk (a key's row read by the 32 lanes at once, once for the
// nq rows), writes them to part[row][key][lane], and after a warp barrier
// lane l sums row l of each: the score of key c0 + l, s[row]
__device__ __forceinline__ void chunk_scores(const AttnArgs& a, const float* qs, float* part,
                                             int b, int h, int w, int i0, int nq, int c0,
                                             int j1, int lane, float (&s)[kQ]) {
  const int cnt = min(32, j1 - c0 + 1);
  for (int x = 0; x < cnt; ++x) {
    long long off;
    const void* kr = key_row(a, b, h, w, c0 + x, false, off);
    float acc[kQ] = {};
    for (int d = lane; d < a.D; d += 32) {
      const float kv = ld(kr, off + d, a.bf);
      for (int q = 0; q < kQ; ++q) acc[q] = fmaf(qs[q * a.D + d], kv, acc[q]);
    }
    for (int q = 0; q < kQ; ++q) part[(q * 32 + x) * 33 + lane] = acc[q];
  }
  __syncwarp();
  for (int q = 0; q < kQ; ++q) {
    s[q] = 0.0f;
    if (lane < cnt && q < nq) {
      for (int y = 0; y < 32; ++y) s[q] += part[(q * 32 + lane) * 33 + y];
      s[q] += bias_at(a, h, i0 + q, c0 + lane);
    }
  }
  __syncwarp();
}

// one warp per kQ consecutive query rows i0 .. i0 + nq - 1 of one window
__global__ void attention_kernel(AttnArgs a) {
  extern __shared__ __align__(16) float smem_attn[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qs = smem_attn + warp * kAttnWarpFloats(a.D);  // [kQ][D]
  float* os = qs + kQ * a.D;                            // [kQ][D]
  float* ps = os + kQ * a.D;                            // [kQ][32]
  float* red = ps + kQ * 32;                            // [32]
  float* part = red + 32;                               // [kQ][32][33]
  const int G = (a.n + kQ - 1) / kQ, W = a.T / a.n;     // row groups a window, windows
  const long long r = static_cast<long long>(blockIdx.x) * a.warps + warp;
  if (r >= static_cast<long long>(a.B) * a.H * W * G) return;
  const int i0 = static_cast<int>(r % G) * kQ;
  const int w = static_cast<int>((r / G) % W);
  const int h = static_cast<int>((r / (static_cast<long long>(G) * W)) % a.H);
  const int b = static_cast<int>(r / (static_cast<long long>(G) * W * a.H));
  const int nq = min(kQ, a.n - i0);
  for (int q = 0; q < kQ; ++q) {
    const long long qo = b * a.qs[0] + h * a.qs[1] + static_cast<long long>(w * a.n + i0 + q) *
                         a.qs[2];
    for (int d = lane; d < a.D; d += 32) {
      qs[q * a.D + d] = q < nq ? rnd(ld(a.q, qo + d, a.bf) * a.scale, a.bf) : 0.0f;
      os[q * a.D + d] = 0.0f;
    }
  }
  __syncwarp();
  const bool mask_first = a.pk == nullptr || a.left_edge;
  // keys j0 .. n + i of row i (causal), the union j0 .. j1 for the group
  const int j0 = (w == 0 && mask_first) ? a.n : 0, j1 = a.n + i0 + nq - 1;
  float s[kQ];
  // pass 1: each lane's running max and sum over its keys, then each row's
  float m[kQ], l[kQ];
  for (int q = 0; q < kQ; ++q) {
    m[q] = -INFINITY;
    l[q] = 0.0f;
  }
  for (int c0 = j0; c0 <= j1; c0 += 32) {
    chunk_scores(a, qs, part, b, h, w, i0, nq, c0, j1, lane, s);
    for (int q = 0; q < nq; ++q) {
      if (c0 + lane > a.n + i0 + q) continue;
      if (s[q] > m[q]) {
        l[q] = l[q] * expf(m[q] - s[q]) + 1.0f;
        m[q] = s[q];
      } else {
        l[q] += expf(s[q] - m[q]);
      }
    }
  }
  float mx[kQ], sum[kQ];
  for (int q = 0; q < kQ; ++q) {
    red[lane] = m[q];
    __syncwarp();
    mx[q] = red[0];
    for (int x = 1; x < 32; ++x) mx[q] = fmaxf(mx[q], red[x]);
    __syncwarp();
    red[lane] = m[q] == -INFINITY ? 0.0f : l[q] * expf(m[q] - mx[q]);
    __syncwarp();
    sum[q] = 0.0f;
    for (int x = 0; x < 32; ++x) sum[q] += red[x];
    __syncwarp();
  }
  // pass 2: P by lanes over keys, O by lanes over the head dim (each value
  // row read once for the group)
  for (int c0 = j0; c0 <= j1; c0 += 32) {
    chunk_scores(a, qs, part, b, h, w, i0, nq, c0, j1, lane, s);
    for (int q = 0; q < kQ; ++q)
      ps[q * 32 + lane] = q < nq && c0 + lane <= a.n + i0 + q
                              ? rnd(expf(s[q] - mx[q]) / sum[q], a.bf)
                              : 0.0f;
    __syncwarp();
    const int cnt = min(32, j1 - c0 + 1);
    for (int d = lane; d < a.D; d += 32) {
      float acc[kQ];
      for (int q = 0; q < kQ; ++q) acc[q] = os[q * a.D + d];
      for (int x = 0; x < cnt; ++x) {
        long long off;
        const void* vr = key_row(a, b, h, w, c0 + x, true, off);
        const float vv = ld(vr, off + d, a.bf);
        for (int q = 0; q < kQ; ++q) acc[q] = fmaf(ps[q * 32 + x], vv, acc[q]);
      }
      for (int q = 0; q < kQ; ++q) os[q * a.D + d] = acc[q];
    }
    __syncwarp();
  }
  for (int q = 0; q < nq; ++q) {
    const long long oo = ((static_cast<long long>(b) * a.T + w * a.n + i0 + q) * a.H + h) * a.D;
    for (int d = lane; d < a.D; d += 32) st(a.out, oo + d, os[q * a.D + d], a.bf);
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

cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  if (g.M < 1 || g.N < 1 || g.K < 1 || g.a_rows < 1 || g.o_rows < 1 || g.taps < 1 ||
      (g.act == 1 && !g.alpha) || l3ac::ceil_div(g.N, kTN) > 65535 ||
      (g.M + kTM - 1) / kTM > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((g.M + kTM - 1) / kTM), l3ac::ceil_div(g.N, kTN));
  gemm_kernel<<<grid, kGemmThreads, 0, stream>>>(g);
  return cudaGetLastError();
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
  if (B < 1 || H < 1 || n < 1 || T % n || D < 1 || (pk == nullptr) != (pv == nullptr))
    return cudaErrorInvalidValue;
  AttnArgs a{q, k, v, kp, pk, pv, bias, table, out, {}, {}, {}, {}, B, H, T, n, D, left_edge, bf,
             kAttnWarps, scale};
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.kps[i] = strides[9 + i];
  }
  constexpr size_t kMaxSmem = 227 * 1024;
  size_t per_warp = sizeof(float) * static_cast<size_t>(kAttnWarpFloats(D));
  while (a.warps > 1 && a.warps * per_warp > kMaxSmem) a.warps /= 2;
  const size_t smem = a.warps * per_warp;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long groups = static_cast<long long>(B) * H * (T / n) * ((n + kQ - 1) / kQ);
  if ((groups + a.warps - 1) / a.warps > 0x7fffffffLL) return cudaErrorInvalidValue;
  attention_kernel<<<static_cast<unsigned>((groups + a.warps - 1) / a.warps), 32 * a.warps,
                     smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
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
