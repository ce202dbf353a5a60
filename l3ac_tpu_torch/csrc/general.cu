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
// - the product: its own source, csrc/general_gemm.cu (the
//   former one, with the tail's elementwise snakes, is
//   tools/general_tail_former.cu).
// - the unit's dw + norm pass and the up path's blend + norm pass: their own
//   source, csrc/general_rows.cu.
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
