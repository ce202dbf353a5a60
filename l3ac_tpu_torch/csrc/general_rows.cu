// The general routes' two row passes (ROADMAP C3; their product is
// csrc/general_gemm.cu, their attention csrc/general.cu). ops/kernels/conv_unit.py:_launch_general and
// ops/kernels/up_fused.py's general route call them.
//
// - dw_norm: the ConvUnit's depthwise conv (K odd, dilation d, SAME zero
//   padding) and ChannelNorm over C, the general unit's first pass: the
//   dw + ChannelNorm stage of l3ac_tpu/ops/pallas/conv_unit.py::conv_unit
//   (:260) and ::conv_unit_ct (:144), whose whole-row BlockSpecs are sized
//   for VMEM. Replaces the general route's first pass of a block per row,
//   a block-wide tree per statistic and the conv recomputed in each of three
//   passes (each x element loaded 21 times).
// - up_blend_norm: the up path's linear upsample x s of z = W x + b (fp32,
//   the general product's output) into phases, then ChannelNorm over Co,
//   stored at the layout's address: the blend + ChannelNorm of
//   l3ac_tpu/ops/pallas/upsample.py::up_fused (:207) and ::up_fused_ct
//   (:129). Replaces the general route's first pass of a block per output
//   row (each z row read s times, in three passes each; the channels-first
//   stores a 32-byte sector per element).
//
// Bound: bytes. Each output element costs a few operations (the k7 conv: 7
// fmas) against 6-12 bytes moved, far below the 20 operations a byte at
// which the SMs' fp32 rate would bind. So the design reads each input byte
// from device memory once and writes each output byte once, in full sectors,
// and keeps the SMs' instruction slots for the arithmetic that remains:
// - Tiles: a tile is R time rows of one batch element, all s phases of them
//   (R from plan_rows: at most 64, at least 2 tiles an SM where the rows
//   allow it). A persistent grid (the SMs' worth of blocks) takes the tiles
//   in turn. A block stages the input rows a tile needs in shared memory
//   once, by cp.async (16 bytes a copy where the rows allow it, else element
//   by element): x's rows [t0 - pad, t0 + R + pad), zero outside [0, T),
//   beside the conv's taps transposed to (K, C), copied once a block; z's
//   rows t0 - 1 .. t0 + R, clamped to [0, T) (the edge frame repeated). Where
//   a row's channels are one chunk, two buffers: the next tile's rows are
//   copied in while the block computes this one's.
// - Rows: each row's values are computed once into registers (lane l holds
//   the 16-byte channel groups l, l + 32, ...); their mean, then the mean of
//   squared deviations from it, by shuffles over the row's lanes (the plain
//   version's two passes, over the values on chip); then normalized and
//   stored. dw_norm gives a row two warps of a 512-thread block (each half
//   its groups, the halves' (count, mean, M2) merged by Chan's formula): one
//   warp a row left the SMs with 8 warps, latency-bound. up_blend_norm's
//   channels-last rows: a warp a row, 16-byte stores in the output's dtype.
// - Chunks: where a row does not fit (past kMaxNJ groups a lane, or the
//   shared memory), the pass runs over C in chunks: the chunks' (count,
//   mean, M2) merged by Chan's formula, then a second sweep restages each
//   chunk (from L2), recomputes its values and stores them. No width is
//   refused.
// - up_blend_norm's other layouts (channels-first, phase_split, any other
//   strides) go through a transposing tile in shared memory: a row on half a
//   warp (Co is narrow there: half the shuffles a row) writes its normalized
//   values down the tile's channel rows; then each warp stores one channel's
//   contiguous run of the tile's R s time samples (phase_split: R of one
//   phase), a lane an element (bf16: a pair), 128 contiguous bytes a store.
//   The odd row strides of z's buffer and of the tile keep both sides of the
//   transpose on distinct banks.
//
// Rounding: fp32 sums and one rounding to the output's dtype at the store
// (bf16: where the bf16 plain versions round); the blend's products and sum
// each rounded once (__fmul_rn / __fadd_rn), as the plain version computes
// them; (v - mean) / den as IEEE division rounds it (common.cuh quotient),
// den = sqrt(M2 / C + eps). tools/rows_variants.py times the design beside
// its alternatives and ablations and the former passes.
#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

namespace ptx = l3ac::ptx;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMinRows = 8, kMaxRows = 64;  // R: rows a tile
constexpr int kMaxNJ = 12;                  // channel groups a lane holds, at most
constexpr int kMaxTileNJ = 4;               // the same, in up_blend_norm's tile layouts
constexpr size_t kBudget = 113 * 1024;      // shared memory a block: two blocks an SM
constexpr int kTilesPerSm = 2;              // R leaves at least this many tiles an SM
constexpr int kDwBlocks = 1, kUpBlocks = 2; // blocks an SM the registers leave room for
// dw_norm: a block of 16 warps, a row on two of them (each half its groups)
constexpr int kDwThreads = 512, kDwWarps = kDwThreads / 32, kDwRowsAPass = kDwWarps / 2;
constexpr size_t kMaxSmem = 227 * 1024;

// The launch plan of one pass: nch chunks of cw channels (a multiple of the
// 16-byte group's V channels; the last may be short), nj groups a lane, R
// rows a tile, bufs staging buffers (two: the next tile's copies in flight),
// the card's SMs, the shared memory a block takes and where the rows'
// statistics (and up_blend_norm's tile) start in it; vin: 16-byte copies
// in; vout: vector stores out; vpar: the per-channel vectors read 16 bytes
// at a time; mode (up_blend_norm): how the
// output is stored (kRowStores: channels-last rows; the others through a
// transposing tile: kChannelRuns each channel's R s samples contiguous (the
// channels-first layout), kPhaseRuns each (channel, phase)'s R samples
// (phase_split), kAnyRuns element by element at any strides).
enum Mode : int { kRowStores = 0, kChannelRuns = 1, kPhaseRuns = 2, kAnyRuns = 3 };
struct Plan {
  int nj, cw, nch, rows, bufs, sms, vin, vout, vpar, mode;
  size_t smem, stat_off, tile_off;
};

// the sum over each aligned group of G lanes (a row's lanes), on every lane
template <int G>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int m = G / 2; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// The row's (mean, M2) over the valid values its G lanes hold: the mean,
// then the sum of squared deviations from it (two passes on chip).
template <int G = 32, int N, typename Ok>
__device__ __forceinline__ float2 moments(const float (&v)[N], Ok ok, int n) {
  float s = 0.0f;  // the values past the row are zero
#pragma unroll
  for (int i = 0; i < N; ++i) s += v[i];
  const float mean = lanes_sum<G>(s) / static_cast<float>(n);
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (ok(i)) {
      const float d = v[i] - mean;
      q = fmaf(d, d, q);
    }
  return make_float2(mean, lanes_sum<G>(q));
}

// (mean, M2) of na values merged with (mean, M2) of nb more (Chan et al.)
__device__ __forceinline__ float2 chan_merge(float2 a, int na, float2 b, int nb) {
  if (na == 0 || nb == 0) return na == 0 ? b : a;
  const float n = static_cast<float>(na + nb);
  const float d = b.x - a.x;
  const float mean = fmaf(d, static_cast<float>(nb) / n, a.x);
  const float m2 = fmaf(d * d, static_cast<float>(na) * static_cast<float>(nb) / n, a.y + b.y);
  return make_float2(mean, m2);
}

// A row's norm from its moments over C values: (mean, den, 1 / den), den =
// sqrt(M2 / C + eps); the reciprocal for normed()'s quotient
__device__ __forceinline__ float4 row_norm(float2 m, int C) {
  const float den = sqrtf(m.y / static_cast<float>(C) + l3ac::kSnakeEps);
  return make_float4(m.x, den, __frcp_rn(den), 0.0f);
}

// w (v - mean) / den + b, the quotient IEEE division's (common.cuh)
__device__ __forceinline__ float normed(float v, float4 n, float w, float b) {
  return fmaf(w, l3ac::quotient(v - n.x, n.y, n.z), b);
}

// the row's first lane folds the chunk's moments into the row's running ones
// (.x mean, .y M2): after chunk k every chunk before it was whole, so the
// row has counted k cw values
template <int G = 32>
__device__ __forceinline__ void merge_row(float4* stat, int r, int k, int cw, float2 m, int n) {
  if ((threadIdx.x & (G - 1)) == 0) {
    const float2 run = k == 0 ? m : chan_merge(make_float2(stat[r].x, stat[r].y), k * cw, m, n);
    stat[r] = make_float4(run.x, run.y, 0.0f, 0.0f);
  }
}

// every used row's running moments -> its norm (row_norm); stat[ph R + tl]
__device__ __forceinline__ void finish_rows(float4* stat, int R, int rows, int s, int C,
                                            int threads = kThreads) {
  for (int i = threadIdx.x; i < R * s; i += threads)
    if (i % R < rows) stat[i] = row_norm(make_float2(stat[i].x, stat[i].y), C);
}

__device__ __forceinline__ float bf16_lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }

// V staged values (16 bytes of shared memory) as fp32
template <typename E, int V>
__device__ __forceinline__ void load_group(const E* p, float (&v)[V]) {
  if constexpr (std::is_same_v<E, bf16>) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[2 * q] = bf16_lo(w[q]);
      v[2 * q + 1] = bf16_hi(w[q]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  }
}

// p[0 .. V) of a per-channel fp32 vector (zero from n on): 16-byte loads
// where vec (p aligned, the group whole), else one by one
template <int V>
__device__ __forceinline__ void load_vec(const float* p, int n, bool vec, float (&v)[V]) {
  if (vec && n >= V) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = e < n ? __ldg(p + e) : 0.0f;
  }
}

// A tap row of dw_norm's chunk in shared memory: a lane reads its group's V
// fp32 taps at c as 16-byte loads from consecutive addresses. V = 4: the
// channels in order; V = 8 (bf16 x): two planes of cw / 2, channels 8 g ..
// 8 g + 3 at 4 g of the first, 8 g + 4 .. 8 g + 7 at 4 g of the second (in
// order, a lane's 32 bytes put the warp's loads two ways on each bank).
template <int V>
__device__ __forceinline__ int tap_slot(int c, int cw) {
  if constexpr (V == 8) return c / 8 * 4 + c % 8 / 4 * (cw / 2) + c % 4;
  else return c;
}
template <int V>
__device__ __forceinline__ void load_taps(const float* row, int c, int cw, float (&w)[V]) {
  if constexpr (V == 8) {
    float lo[4], hi[4];
    load_group<float, 4>(row + c / 2, lo);
    load_group<float, 4>(row + cw / 2 + c / 2, hi);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      w[e] = lo[e];
      w[4 + e] = hi[e];
    }
  } else {
    load_group<float, V>(row + c, w);
  }
}

template <typename E>
__device__ __forceinline__ E zero() {
  if constexpr (std::is_same_v<E, bf16>) return __float2bfloat16_rn(0.0f);
  else return 0.0f;
}

__device__ __forceinline__ void store_one(void* out, long long i, float v, int o_bf) {
  if (o_bf)
    static_cast<bf16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[i] = v;
}

// out[i .. i + n) = y[0 .. n) in the output's dtype; vec: n == V (4 or 8)
// and out + i aligned to V elements (fp32: V / 4 float4; bf16: 2 V bytes in
// one store)
template <int V>
__device__ __forceinline__ void store_group(void* out, long long i, const float (&y)[V], int n,
                                            int o_bf, bool vec) {
  if (vec && n == V) {
    if (o_bf) {
      uint32_t u[V / 2];
#pragma unroll
      for (int q = 0; q < V / 2; ++q) u[q] = ptx::bf16x2_rn(y[2 * q], y[2 * q + 1]);
      bf16* o = static_cast<bf16*>(out) + i;
      if constexpr (V == 8)
        *reinterpret_cast<uint4*>(o) = make_uint4(u[0], u[1], u[2], u[3]);
      else
        *reinterpret_cast<uint2*>(o) = make_uint2(u[0], u[1]);
    } else {
      float* o = static_cast<float*>(out) + i;
#pragma unroll
      for (int q = 0; q < V / 4; ++q)
        *reinterpret_cast<float4*>(o + 4 * q) =
            make_float4(y[4 * q], y[4 * q + 1], y[4 * q + 2], y[4 * q + 3]);
    }
  } else {
    for (int e = 0; e < n; ++e) store_one(out, i + e, y[e], o_bf);
  }
}

// ------------------------------------------------------------- dw_norm

struct DwArgs {
  const void* x;  // x(b, t, c) = x[b sb + t st + c sc]
  long long sb, st, sc;
  int B, T, C, K, dil;
  const float* dw;    // (C, K)
  const float* dw_b;  // (C,)
  const float* nw;    // (C,) ChannelNorm, or null: the conv alone
  const float* nb;
  void* out;  // (B T, C) contiguous
  int o_bf;
};

// A persistent block takes the tiles g = blockIdx.x, + gridDim.x, ... (tile
// g: p.rows rows of batch element g / tiles). Shared memory: the chunk's
// taps (K, cw) fp32, then x's staged rows (rows + 2 pad, cw) in x's dtype in
// one buffer, or two where C is one chunk (p.bufs): the next tile's rows are
// then copied in while the block computes this one's; then the rows' running
// (mean, M2) where C takes several chunks, their norms in the second sweep;
// then each row's two halves' (mean, M2). A row takes two warps: warp h of
// it holds the 16-byte groups 64 j + 32 h + lane, and the halves' moments
// are merged (Chan) into the row's.
template <bool kBf, int NJ>
__global__ void __launch_bounds__(kDwThreads, kDwBlocks)
    general_dw_norm_kernel(const DwArgs a, const Plan p) {
  using E = std::conditional_t<kBf, bf16, float>;
  constexpr int V = 16 / sizeof(E);
  extern __shared__ __align__(16) unsigned char smem_rows[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rs = warp >> 1, h = warp & 1;  // the warp's row of a pass, its half
  const int K = a.K, pad = (K - 1) * a.dil / 2, cw = p.cw, R = p.rows;
  const int tiles = (a.T + R - 1) / R, ntiles = a.B * tiles;
  float* taps = reinterpret_cast<float*>(smem_rows);
  E* xbuf = reinterpret_cast<E*>(taps + K * cw);
  const int xsize = (R + 2 * pad) * cw;  // elements of one x buffer
  float4* stat = reinterpret_cast<float4*>(smem_rows + p.stat_off);
  float2* halves = reinterpret_cast<float2*>(stat + R);  // [row][half]
  const bool norm = a.nw != nullptr;
  const int sweeps = norm && p.nch > 1 ? 2 : 1;

  // the copies of chunk k's taps (tap j of chunk channel c: taps[j][slot(c)],
  // dw[c0 + c][j], zero past C)
  auto stage_taps = [&](int k) {
    const int c0 = k * cw, cn = min(cw, a.C - c0);
    for (int c = tid; c < cw; c += kDwThreads) {
      const bool ok = c < cn;
      const float* src = a.dw + static_cast<long long>(c0 + c) * K;
      for (int j = 0; j < K; ++j)
        ptx::cp_async4(taps + j * cw + tap_slot<V>(c, cw), ok ? src + j : a.dw, ok ? 4 : 0);
    }
  };
  // the copies of tile g's x rows t0 - pad .. t0 + rows + pad, chunk k, into
  // buffer buf: a warp a row, V channels a lane, zero outside [0, T) and past C
  auto stage_x = [&](int g, int k, int buf) {
    const int b = g / tiles, t0 = (g - b * tiles) * R, c0 = k * cw;
    const int staged = min(R, a.T - t0) + 2 * pad, pieces = cw / V;
    const E* xb = static_cast<const E*>(a.x) + b * a.sb;
    for (int r = warp; r < staged; r += kDwWarps) {
      const int t = t0 - pad + r;
      const bool in = t >= 0 && t < a.T;
      E* row = xbuf + buf * xsize + r * cw;
      for (int q = lane; q < pieces; q += 32) {
        const int c = c0 + q * V;
        if (p.vin) {  // C % V == 0: a piece is whole or past C
          const bool ok = in && c < a.C;
          ptx::cp_async16(row + q * V, ok ? xb + t * a.st + c : a.x, ok ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e)
            row[q * V + e] = in && c + e < a.C ? xb[t * a.st + (c + e) * a.sc] : zero<E>();
        }
      }
    }
  };
  // tile g, chunk k of sweep `sweep` from buffer buf: the conv of each row,
  // two warps a row, its statistics, and (in the last sweep) its stores
  auto compute = [&](int g, int k, int sweep, int buf) {
    const int b = g / tiles, t0 = (g - b * tiles) * R, rows = min(R, a.T - t0);
    const int c0 = k * cw, cn = min(cw, a.C - c0);
    const E* xs = xbuf + buf * xsize;
    // the chunk channel of the warp's value i, and how many of them are valid
    auto ch = [&](int i) { return (lane + 32 * (2 * (i / V) + h)) * V + i % V; };
    int n_h = 0;
    for (int j = 0; j < NJ; ++j) n_h += max(0, min(32 * V, cn - 32 * (2 * j + h) * V));
    for (int r0 = 0; r0 < R; r0 += kDwRowsAPass) {  // the same count for every warp
      const int r = r0 + rs;
      const bool live = r < rows;
      // the conv of row t0 + r: staged rows r + kk dil, kk < K, every group's
      // tap kk at once
      float v[NJ * V];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = ch(j * V);
        float bias[V];
        load_vec<V>(a.dw_b + c0 + c, cn - c, p.vpar != 0, bias);
#pragma unroll
        for (int e = 0; e < V; ++e) v[j * V + e] = live ? bias[e] : 0.0f;
      }
      for (int kk = 0; live && kk < K; ++kk) {
        const E* xr = xs + (r + kk * a.dil) * cw;
        const float* wr = taps + kk * cw;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = ch(j * V);
          if (c >= cn) continue;
          float xv[V], wv[V];
          load_group<E, V>(xr + c, xv);
          load_taps<V>(wr, c, cw, wv);
#pragma unroll
          for (int e = 0; e < V; ++e) v[j * V + e] = fmaf(wv[e], xv[e], v[j * V + e]);
        }
      }
      auto ok = [&](int i) { return ch(i) < cn; };
      float4 nr = make_float4(0.0f, 1.0f, 1.0f, 0.0f);
      if (norm) {
        // the halves' moments, merged into the row's over the chunk
        const float2 m = n_h > 0 ? moments(v, ok, n_h) : make_float2(0.0f, 0.0f);
        if (lane == 0 && live) halves[2 * r + h] = m;
        __syncthreads();
        if (!live) continue;
        const int n_0 = h == 0 ? n_h : cn - n_h;
        const float2 mc = chan_merge(halves[2 * r], n_0, halves[2 * r + 1], cn - n_0);
        if (p.nch == 1) {
          nr = row_norm(mc, a.C);
        } else if (sweep == 0) {
          if (h == 0) merge_row(stat, r, k, cw, mc, cn);
          continue;
        } else {
          nr = stat[r];
        }
      }
      if (!live) continue;
      const long long o = (static_cast<long long>(b) * a.T + t0 + r) * a.C + c0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = ch(j * V);
        if (c >= cn) continue;
        float y[V];
#pragma unroll
        for (int e = 0; e < V; ++e) y[e] = v[j * V + e];
        if (norm) {
          float w[V], bb[V];
          load_vec<V>(a.nw + c0 + c, cn - c, p.vpar != 0, w);
          load_vec<V>(a.nb + c0 + c, cn - c, p.vpar != 0, bb);
#pragma unroll
          for (int e = 0; e < V; ++e) y[e] = normed(y[e], nr, w[e], bb[e]);
        }
        store_group<V>(a.out, o + c, y, min(V, cn - c), a.o_bf, p.vout != 0);
      }
    }
  };

  if (p.bufs == 2) {  // one chunk: the taps once, the next tile's rows in flight
    int g = blockIdx.x, buf = 0;
    stage_taps(0);
    stage_x(g, 0, buf);
    ptx::cp_async_commit();
    for (; g < ntiles; g += gridDim.x, buf ^= 1) {
      ptx::cp_async_wait<0>();
      __syncthreads();  // tile g has landed; the last tile's readers are done
      if (g + static_cast<int>(gridDim.x) < ntiles) stage_x(g + gridDim.x, 0, buf ^ 1);
      ptx::cp_async_commit();
      compute(g, 0, 0, buf);
    }
    return;
  }
  for (int g = blockIdx.x; g < ntiles; g += gridDim.x) {
    const int rows = min(R, a.T - (g % tiles) * R);
    for (int sweep = 0; sweep < sweeps; ++sweep) {
      for (int k = 0; k < p.nch; ++k) {
        __syncthreads();  // the last chunk's readers are done
        if (sweep == 1 && k == 0) finish_rows(stat, R, rows, 1, a.C, kDwThreads);
        stage_taps(k);
        stage_x(g, k, 0);
        ptx::cp_async_commit();
        ptx::cp_async_wait<0>();
        __syncthreads();
        compute(g, k, sweep, 0);
      }
    }
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
  int B, T, Co, s, o_bf;
};

// Phase ph's weights (prev, cur, next) = (wp, wc, wn) blend prev wp + cur
// wc where wp != 0, else cur wc + next wn (the plain version's products and
// sum, each rounded once; the sum's order does not change its rounding): cur
// wc + nbr wo, nbr the row at zs * side from cur.
struct Blend {
  float wc, wo;
  int side;
};
__device__ __forceinline__ Blend blend_of(const float* tw, int ph) {
  const float wp = tw[3 * ph];
  return wp != 0.0f ? Blend{tw[3 * ph + 1], wp, -1} : Blend{tw[3 * ph + 1], tw[3 * ph + 2], 1};
}
__device__ __forceinline__ float blend(float cur, float nbr, Blend w, int s) {
  return s == 1 ? cur : __fadd_rn(__fmul_rn(cur, w.wc), __fmul_rn(nbr, w.wo));
}

// A warp stores the run y[0 .. L) at out[i .. i + L): a lane an element
// (fp32), or a lane a bf16 pair (after an unaligned first element), so that
// each warp store writes 128 contiguous bytes
__device__ __forceinline__ void store_run(void* out, long long i, const float* y, int L,
                                          int o_bf) {
  const int lane = threadIdx.x & 31;
  if (!o_bf) {
    for (int e = lane; e < L; e += 32) static_cast<float*>(out)[i + e] = y[e];
    return;
  }
  bf16* o = static_cast<bf16*>(out) + i;
  const int head = min(L, static_cast<int>(reinterpret_cast<uintptr_t>(o) / 2 % 2));
  if (lane < head) o[0] = __float2bfloat16_rn(y[0]);
  for (int e = head + 2 * lane; e + 1 < L; e += 64)
    *reinterpret_cast<uint32_t*>(o + e) = ptx::bf16x2_rn(y[e], y[e + 1]);
  if (lane == 0 && (L - head) % 2) o[L - 1] = __float2bfloat16_rn(y[L - 1]);
}

// A persistent block takes the tiles g = blockIdx.x, + gridDim.x, ... (tile
// g: p.rows z rows of batch element g / tiles, all s phases). Shared memory:
// z's staged rows (rows + 2, zs) in one buffer, or two where Co is one chunk
// (p.bufs: the next tile's rows copied in while the block computes this
// one's), then the phases' weights (s, 3), then each output row's statistics
// at [ph R + tl] (moments, then norm) where Co takes several chunks, then
// (kTile) the output tile. Row stores (channels-last output): lane l holds
// the 4-channel groups l, l + 32, ... of the chunk, zs = cw. Tile (every
// other layout): a row a half warp, lane l of it holding channels l, l + 16,
// ... (zs = cw + 1), writes the normalized row into the tile (cw, L + 1), L
// = R s, at the row's place in its channel's run; then each warp stores one channel's runs, a
// lane an element (bf16: a pair) of each run, so that a warp's store is 128
// contiguous bytes. The odd row strides keep both the writes down the
// channels and the reads along time on distinct banks.
template <int NJ, bool kTile>
__global__ void __launch_bounds__(kThreads, kUpBlocks)
    general_up_kernel(const UpArgs a, const Plan p) {
  constexpr int NV = 4 * NJ;
  constexpr int G = kTile ? 16 : 32, kRowsAWarp = 32 / G;  // a row's lanes
  extern __shared__ __align__(16) unsigned char smem_rows[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = lane / G, gl = lane % G;  // the warp's row, the lane's place in it
  const int cw = p.cw, zs = kTile ? cw + 1 : cw, s = a.s, R = p.rows, lt = R * s + 1;
  const int tiles = (a.T + R - 1) / R, ntiles = a.B * tiles;
  float* zbuf = reinterpret_cast<float*>(smem_rows);
  const int zsize = (R + 2) * zs;  // floats of one z buffer
  float* tw = zbuf + p.bufs * zsize;
  float4* stat = reinterpret_cast<float4*>(smem_rows + p.stat_off);
  float* tile = reinterpret_cast<float*>(smem_rows + p.tile_off);
  const bool norm = a.nw != nullptr;
  const int sweeps = norm && p.nch > 1 ? 2 : 1;
  for (int i = tid; i < 3 * s; i += kThreads) tw[i] = a.taps[i];

  // the copies of tile g's z rows t0 - 1 .. t0 + rows, clamped to [0, T),
  // chunk k, into buffer buf: a warp a row; zero past Co
  auto stage = [&](int g, int k, int buf) {
    const int b = g / tiles, t0 = (g - b * tiles) * R, c0 = k * cw;
    const int staged = min(R, a.T - t0) + 2;
    const float* zb = a.z + static_cast<long long>(b) * a.T * a.Co;
    for (int r = warp; r < staged; r += kWarps) {
      const float* zrow = zb + static_cast<long long>(min(max(t0 - 1 + r, 0), a.T - 1)) * a.Co;
      float* row = zbuf + buf * zsize + r * zs;
      if (!kTile && p.vin) {  // Co % 4 == 0, z 16-byte aligned
        for (int q = lane; q < cw / 4; q += 32) {
          const bool ok = c0 + 4 * q < a.Co;
          ptx::cp_async16(row + 4 * q, ok ? zrow + c0 + 4 * q : a.z, ok ? 16 : 0);
        }
      } else {
        for (int c = lane; c < cw; c += 32) {
          const bool ok = c0 + c < a.Co;
          ptx::cp_async4(row + c, ok ? zrow + c0 + c : a.z, ok ? 4 : 0);
        }
      }
    }
  };
  // tile g, chunk k of sweep `sweep` from buffer buf
  auto compute = [&](int g, int k, int sweep, int buf) {
    const int b = g / tiles, t0 = (g - b * tiles) * R, rows = min(R, a.T - t0);
    const int c0 = k * cw, cn = min(cw, a.Co - c0);
    const float* zt = zbuf + buf * zsize;
    // the tile's lanes: their channels' norm weights, once a chunk
    float wn[kTile ? NV : 1], bn[kTile ? NV : 1];
    if constexpr (kTile) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = c0 + gl + G * i;
        wn[i] = norm && c < a.Co ? __ldg(a.nw + c) : 1.0f;
        bn[i] = norm && c < a.Co ? __ldg(a.nb + c) : 0.0f;
      }
    }
    const int nrows = rows * s;
    for (int r0 = kRowsAWarp * warp; r0 < nrows; r0 += kRowsAWarp * kWarps) {
      // the warp's rows r0 .. (tile: a row each half); a half past the last
      // row repeats it and stores nothing
      const bool live = r0 + half < nrows;
      const int ro = live ? r0 + half : r0;
      const int tl = ro / s, ph = ro - tl * s;
      const Blend w = blend_of(tw, ph);
      const float* zr = zt + (tl + 1) * zs;  // the staged row of t0 + tl
      const float* zn = zr + w.side * zs;    // its neighbour the phase reads
      float v[NV];
      if constexpr (kTile) {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int c = gl + G * i;
          v[i] = c < cn ? blend(zr[c], zn[c], w, s) : 0.0f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = 4 * (lane + 32 * j);
          float cur[4], nbr[4];
          if (c < cn) {
            load_group<float, 4>(zr + c, cur);
            load_group<float, 4>(zn + c, nbr);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[4 * j + e] = c + e < cn ? blend(cur[e], nbr[e], w, s) : 0.0f;
        }
      }
      // lane's value i: chunk channel ch(i)
      auto ch = [&](int i) { return kTile ? gl + G * i : 4 * (lane + 32 * (i / 4)) + i % 4; };
      auto ok = [&](int i) { return ch(i) < cn; };
      float4 nr = make_float4(0.0f, 1.0f, 1.0f, 0.0f);
      if (norm) {
        if (p.nch == 1) {
          nr = row_norm(moments<G>(v, ok, cn), a.Co);
        } else if (sweep == 0) {
          const float2 m = moments<G>(v, ok, cn);
          if (live) merge_row<G>(stat, ph * R + tl, k, cw, m, cn);
          continue;
        } else {
          nr = stat[ph * R + tl];
        }
      }
      if (!live) continue;
      if constexpr (kTile) {
        // the row's place in its channel's run: time-major (channel runs,
        // any strides) or phase-major (phase runs)
        const int e = p.mode == kPhaseRuns ? ph * R + tl : tl * s + ph;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int c = ch(i);
          if (c < cn) tile[c * lt + e] = norm ? normed(v[i], nr, wn[i], bn[i]) : v[i];
        }
      } else {
        const long long o = b * a.ob + (t0 + tl) * a.ot + ph * a.op;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = 4 * (lane + 32 * j);
          if (c >= cn) continue;
          float y[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) y[e] = v[4 * j + e];
          if (norm) {
            float nw4[4], nb4[4];
            load_vec<4>(a.nw + c0 + c, cn - c, p.vpar != 0, nw4);
            load_vec<4>(a.nb + c0 + c, cn - c, p.vpar != 0, nb4);
#pragma unroll
            for (int e = 0; e < 4; ++e) y[e] = normed(y[e], nr, nw4[e], nb4[e]);
          }
          if (p.vout) {
            store_group<4>(a.out, o + c0 + c, y, min(4, cn - c), a.o_bf, true);
          } else {
            for (int e = 0; e < min(4, cn - c); ++e)
              store_one(a.out, o + (c0 + c + e) * a.oc, y[e], a.o_bf);
          }
        }
      }
    }
    if constexpr (kTile) {
      if (sweep == sweeps - 1) {
        __syncthreads();  // the tile
        for (int c = warp; c < cn; c += kWarps) {
          const float* run = tile + c * lt;
          const long long oc = b * a.ob + (c0 + c) * a.oc;
          if (p.mode == kChannelRuns) {
            store_run(a.out, oc + static_cast<long long>(t0) * s, run, rows * s, a.o_bf);
          } else if (p.mode == kPhaseRuns) {
            for (int ph = 0; ph < s; ++ph)
              store_run(a.out, oc + ph * a.op + t0, run + ph * R, rows, a.o_bf);
          } else {
            for (int e = lane; e < rows * s; e += 32) {
              const int tl = e / s, ph = e - tl * s;
              store_one(a.out, oc + (t0 + tl) * a.ot + ph * a.op, run[e], a.o_bf);
            }
          }
        }
      }
    }
  };

  if (p.bufs == 2) {  // one chunk: the next tile's rows in flight
    int g = blockIdx.x, buf = 0;
    stage(g, 0, buf);
    ptx::cp_async_commit();
    for (; g < ntiles; g += gridDim.x, buf ^= 1) {
      ptx::cp_async_wait<0>();
      __syncthreads();  // tile g has landed; the last tile's readers are done
      if (g + static_cast<int>(gridDim.x) < ntiles) stage(g + gridDim.x, 0, buf ^ 1);
      ptx::cp_async_commit();
      compute(g, 0, 0, buf);
    }
    return;
  }
  for (int g = blockIdx.x; g < ntiles; g += gridDim.x) {
    const int rows = min(R, a.T - (g % tiles) * R);
    for (int sweep = 0; sweep < sweeps; ++sweep) {
      for (int k = 0; k < p.nch; ++k) {
        __syncthreads();
        if (sweep == 1 && k == 0) finish_rows(stat, R, rows, s, a.Co);
        stage(g, k, 0);
        ptx::cp_async_commit();
        ptx::cp_async_wait<0>();
        __syncthreads();
        compute(g, k, sweep, 0);
      }
    }
  }
}

// ------------------------------------------------------------ the plans

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }
size_t up16(size_t n) { return (n + 15) / 16 * 16; }

cudaError_t sm_count(int& n) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
}

// The chunks and the tile of a pass whose rows have C values of 16-byte
// groups of V, each row on `lanes` lanes; smem(cw, R, bufs) the bytes of a
// block. One chunk (at most max_nj groups a lane) where its kMinRows-row tile fits a block with two
// buffers, else the fewest chunks whose one-buffer tile fits the budget;
// then the largest R up to kMaxRows that still fits the budget and leaves
// kTilesPerSm tiles an SM.
template <typename Smem>
cudaError_t plan_rows(Plan& p, int B, int T, int C, int V, int lanes, int max_nj, Smem smem) {
  int sms = 0;
  const cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return err;
  p.sms = sms;
  const int groups = (C + V - 1) / V;
  int per = groups, nch = 1;
  p.bufs = 2;
  if (groups > lanes * max_nj || smem(groups * V, kMinRows, 2) > kMaxSmem) {
    p.bufs = 1;
    for (nch = (groups + lanes * max_nj - 1) / (lanes * max_nj);; ++nch) {
      per = (groups + nch - 1) / nch;
      if (smem(per * V, kMinRows, 1) <= kBudget || per == 1) break;
    }
  }
  p.nch = nch;
  p.cw = per * V;
  const int need = (per + lanes - 1) / lanes;
  p.nj = need <= 4 ? need : need <= 6 ? 6 : need <= 8 ? 8 : need <= 10 ? 10 : 12;
  p.rows = kMinRows;
  while (p.rows < kMaxRows && p.rows < T && smem(p.cw, 2 * p.rows, p.bufs) <= kBudget &&
         static_cast<long long>(B) * ((T + 2 * p.rows - 1) / (2 * p.rows)) >= kTilesPerSm * sms)
    p.rows *= 2;
  p.smem = smem(p.cw, p.rows, p.bufs);
  return p.smem <= kMaxSmem ? cudaSuccess : cudaErrorInvalidValue;
}

// a persistent grid: as many blocks as fit the SMs at once, at most one a tile
template <typename K, typename A>
cudaError_t launch(K kernel, const A& a, const Plan& p, long long tiles, cudaStream_t stream,
                   int threads = kThreads) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, p.smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long blocks = std::min<long long>(tiles, static_cast<long long>(per_sm) * p.sms);
  kernel<<<static_cast<unsigned>(blocks), threads, p.smem, stream>>>(a, p);
  return cudaGetLastError();
}

template <bool kBf>
cudaError_t launch_dw(const DwArgs& a, const Plan& p, long long tiles, cudaStream_t s) {
  switch (p.nj) {
    case 1: return launch(general_dw_norm_kernel<kBf, 1>, a, p, tiles, s, kDwThreads);
    case 2: return launch(general_dw_norm_kernel<kBf, 2>, a, p, tiles, s, kDwThreads);
    case 3: return launch(general_dw_norm_kernel<kBf, 3>, a, p, tiles, s, kDwThreads);
    case 4: return launch(general_dw_norm_kernel<kBf, 4>, a, p, tiles, s, kDwThreads);
    case 6: return launch(general_dw_norm_kernel<kBf, 6>, a, p, tiles, s, kDwThreads);
    case 8: return launch(general_dw_norm_kernel<kBf, 8>, a, p, tiles, s, kDwThreads);
    case 10: return launch(general_dw_norm_kernel<kBf, 10>, a, p, tiles, s, kDwThreads);
    default: return launch(general_dw_norm_kernel<kBf, 12>, a, p, tiles, s, kDwThreads);
  }
}

template <bool kTile>
cudaError_t launch_up(const UpArgs& a, const Plan& p, long long tiles, cudaStream_t s) {
  switch (p.nj) {
    case 1: return launch(general_up_kernel<1, kTile>, a, p, tiles, s);
    case 2: return launch(general_up_kernel<2, kTile>, a, p, tiles, s);
    case 3: return launch(general_up_kernel<3, kTile>, a, p, tiles, s);
    case 4: return launch(general_up_kernel<4, kTile>, a, p, tiles, s);
    case 6: return launch(general_up_kernel<6, kTile>, a, p, tiles, s);
    case 8: return launch(general_up_kernel<8, kTile>, a, p, tiles, s);
    case 10: return launch(general_up_kernel<10, kTile>, a, p, tiles, s);
    default: return launch(general_up_kernel<12, kTile>, a, p, tiles, s);
  }
}

}  // namespace

// The ConvUnit's depthwise conv + ChannelNorm into a (B T, C) buffer; see DwArgs.
extern "C" int l3ac_general_dw_norm(const void* x, long long sb, long long st_, long long sc,
                                    int x_bf, int B, int T, int C, int K, int dil,
                                    const float* dw, const float* dw_b, const float* nw,
                                    const float* nb, void* out, int o_bf, void* stream) {
  if (B < 1 || T < 1 || C < 1 || K < 1 || K % 2 == 0 || dil < 1 ||
      (nw == nullptr) != (nb == nullptr) || static_cast<long long>(B) * T > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const DwArgs a{x, sb, st_, sc, B, T, C, K, dil, dw, dw_b, nw, nb, out, o_bf};
  const int es = x_bf ? 2 : 4, V = 16 / es, pad = (K - 1) * dil / 2;
  auto stat_off = [&](int cw, int R, int bufs) {  // the taps, then x's staged rows
    return up16(sizeof(float) * K * cw + static_cast<size_t>(es) * bufs * (R + 2 * pad) * cw);
  };
  Plan p{};
  const cudaError_t err = plan_rows(p, B, T, C, V, 64, kMaxNJ, [&](int cw, int R, int bufs) {
    return stat_off(cw, R, bufs) + (sizeof(float4) + 2 * sizeof(float2)) * R;
  });
  if (err != cudaSuccess) return err;
  p.stat_off = stat_off(p.cw, p.rows, p.bufs);
  p.vin = sc == 1 && C % V == 0 && (st_ * es) % 16 == 0 && (sb * es) % 16 == 0 && aligned16(x);
  p.vout = C % V == 0 && aligned16(out);
  p.vpar = C % 4 == 0 && aligned16(dw_b) && (nw == nullptr || (aligned16(nw) && aligned16(nb)));
  const long long tiles = static_cast<long long>(B) * ((T + p.rows - 1) / p.rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf ? launch_dw<true>(a, p, tiles, s) : launch_dw<false>(a, p, tiles, s);
}

// The up path's blend + ChannelNorm from z = W x + b; see UpArgs.
extern "C" int l3ac_general_up(const float* z, const float* taps, const float* nw,
                               const float* nb, void* out, long long ob, long long oc,
                               long long ot, long long op, int B, int T, int Co, int s, int o_bf,
                               void* stream) {
  if (B < 1 || T < 1 || Co < 1 || s < 1 || (nw == nullptr) != (nb == nullptr) ||
      static_cast<long long>(B) * T * s > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const UpArgs a{z, taps, nw, nb, out, ob, oc, ot, op, B, T, Co, s, o_bf};
  Plan p{};
  p.mode = oc == 1 ? kRowStores : op == 1 && ot == s ? kChannelRuns : ot == 1 ? kPhaseRuns
                                                                            : kAnyRuns;
  const bool tile = p.mode != kRowStores;
  // z's staged rows, the phases' weights, the statistics, then the tile
  auto stat_off = [&](int cw, int R, int bufs) {
    return up16(sizeof(float) * (bufs * (R + 2) * (cw + (tile ? 1 : 0)) + 3 * s));
  };
  auto tile_off = [&](int cw, int R, int bufs) {
    return up16(stat_off(cw, R, bufs) + sizeof(float4) * R * s);
  };
  // the tile's rows take half a warp, its lanes their channels' norm weights
  // too: at most 4 groups
  const cudaError_t err = plan_rows(
      p, B, T, Co, 4, tile ? 16 : 32, tile ? kMaxTileNJ : kMaxNJ, [&](int cw, int R, int bufs) {
        return tile_off(cw, R, bufs) + (tile ? sizeof(float) * cw * (R * s + 1) : 0);
      });
  if (err != cudaSuccess) return err;
  p.stat_off = stat_off(p.cw, p.rows, p.bufs);
  p.tile_off = tile_off(p.cw, p.rows, p.bufs);
  const int es = o_bf ? 2 : 4;
  p.vin = Co % 4 == 0 && aligned16(z);
  p.vout = oc == 1 && Co % 4 == 0 && (ob % 4 | ot % 4 | op % 4) == 0 &&
           reinterpret_cast<uintptr_t>(out) % (4 * es) == 0;
  p.vpar = Co % 4 == 0 && (nw == nullptr || (aligned16(nw) && aligned16(nb)));
  const long long tiles = static_cast<long long>(B) * ((T + p.rows - 1) / p.rows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tile ? launch_up<true>(a, p, tiles, st) : launch_up<false>(a, p, tiles, st);
}
