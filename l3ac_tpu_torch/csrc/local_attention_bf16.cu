// Block-local causal attention with an additive position bias on bf16 q, k,
// v, designed for the H100: TMA and wgmma, a softmax of about six SIMT
// operations per (query, key) pair.
//
// Replaces l3ac_tpu/ops/pallas/local_attention.py:88 local_attention (body
// _attn_kernel, :27-69) on bf16. q, k, v: (B, H, T, D) views whose last dim
// is contiguous, read in place through their B / H / T strides; out: (B, T,
// H, D), so that the caller's (B, T, H * D) is a view. Query i of window w
// attends to key j of [window w-1 | window w] (time (w-1) n + j) iff j <= n
// + i, and in window 0 only to j >= n. Rounds where the plain version does:
// q * scale to bf16 (the scale D^-1/2 rounded to bf16), S and the softmax in
// fp32, P to bf16 for P V, O in fp32 divided by the row sum and rounded once.
// Unlike the fp32 kernel, the softmax is taken in base 2: the score is one
// fma, s log2(e) + tab[n + i - j] with the table prepared in fp32 times
// log2(e), and P = 2^(x - m) on the special-function unit (ex2.approx), which
// moves P by fp32 ulps before its rounding to bf16.
//
// Bound on the H100 (PERF.md §6 row 3b, chip_smoke.py softmax_bound_ms): at D
// = 32 the two products are 128 bf16 MACs a pair, 1/32 clock of an SM's
// tensor cores; the softmax is one exponential a pair on the SFU (16 a clock
// per SM: 4.18e12 /s at 1.98 GHz) and about six other instructions on the
// fp32 pipe (128 a clock per SM). Per 8 x 10 s 1kbps encode / decode (115.6 /
// 220.8 M pairs) the exponentials alone take 0.028 / 0.053 ms, the bytes
// 0.006 / 0.011. So the design spends its SIMT work on the softmax alone:
//   - Work items (128 query rows, window, batch * head) taken by a
//     persistent grid, longest first (windows w >= 1, then window 0, each by
//     query tile from the last), so that a short launch (n = 250) is one
//     balanced wave and a long one has no tail of long items.
//   - A producer warp after the consumers (one thread issues TMA from 4-D tensor maps over the
//     strided (D, T, H, B) head views, 128-, 64- or 32-byte swizzle by the
//     padded head dim) fills a ring of K / V tiles (64 keys) and one Q
//     buffer with full / empty mbarriers; no block barrier inside the walk.
//     Views whose strides or bases are not 16-byte aligned take the cp.async
//     route of the same kernel (the producer warp copies 8-byte pieces into
//     the same swizzled layout, zero-filled past the edges), by the shape rule
//     of ops/kernels/local_attention.py:route_for.
//   - Two consumer warpgroups, the item's rows 0-63 and 64-127, share each K
//     / V tile. Each loads its Q fragments once per item by ldmatrix and
//     scales them in the same pass; S = Q K^T is wgmma m64n64k16 (A from
//     registers, K from swizzled shared memory, D zero-padded to a multiple
//     of 16), P stays in registers as the A operand of O += P V (wgmma
//     m64nDk16, V's B operand MN-major: no transpose, no ldmatrix per MMA).
//     Two blocks per SM up to D = 32: four warpgroups, so one's softmax
//     overlaps another's products and loads.
//   - The softmax: tiles that no row of the warpgroup masks run with no
//     compare and no select; the one or two on the causal diagonal compare
//     n + i - j >= 0. The table column (fp32, times log2 e, zero-padded so
//     that every index a tile forms is in range) is staged per item by its
//     warpgroup; row max and sum reduce once per tile across a quad.
// What still holds it (tools/attention_variants.py --bf16, PERF.md §6): 0.077
// ms at n = 750, 2.8x the exponentials' bound; dropping the exponentials, the
// mask and bias, or three quarters of P V each saves under a tenth, so the
// time is the latency of each warpgroup's S -> softmax -> P V chain, which
// four warpgroups an SM do not hide. At n = 250 (0.017 ms) the prologue and
// the launch are most of it.
// The previous-window operands of JAX's kernel (_attn_kernel's kp, kp0 and
// vp0 refs): window w >= 1 reads its previous half's keys from kp (a view
// like k: the rotary path's keys rotated as previous-window keys), window 0
// from pk / pv, (B, H, n, D) contiguous (sequence parallelism: the left
// shard's last window), unless that half is masked (no pk, or left_edge 1).
// The key tiles stay the contiguous 64-key tiles of [prev | cur], so a
// window reads the same keys in the same tiles as it does without the
// operands (a shard's first window under SP as the single-device run's).
// A tile wholly on one side of key n is one TMA box from that side's tensor;
// the one tile across it, which one box cannot hold, the producer warp's 32
// lanes copy row by row from either source (cp.async, the cp.async route's
// copy), then complete its full barrier with one arrival.
#include <cuda.h>

#include <cstring>

#include "common.cuh"
#include "gemm_sm90.cuh"
#include "ptx.cuh"

namespace {

namespace ptx = l3ac::ptx;
using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                  // warpgroups, 64 query rows each
constexpr int kThreads = 128 * kConsumers + 32;  // the consumers, then the producer warp
constexpr int kProducer = 128 * kConsumers;      // its first thread: warpgroups start at
                                                 // warps that are multiples of 4
constexpr int kQRows = 64 * kConsumers;        // query rows per work item
constexpr int kKeys = 64;                      // keys per tile
constexpr int kTabLo = 128, kTabHi = 64;       // zero pads around the staged table
constexpr float kLog2e = 1.4426950408889634f;

enum BiasMode { kNoBias = 0, kFullBias = 1, kTableBias = 2 };
enum Route { kTma = 0, kCpAsync = 1 };

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* kp;       // the previous-role keys of windows w >= 1, or null (k)
  const bf16* pk;       // (B, H, n, D) window 0's previous keys, or null
  const bf16* pv;       // ... its values
  const bf16* bias;     // (H, n, 2n), kFullBias
  const float* table;   // (H, 2n) fp32 times log2 e, kTableBias
  bf16* out;            // (B, T, H, D) contiguous
  long long qs[3], ks[3], vs[3], kps[3];  // B, H, T strides in elements
  int H, T, n, D;
  int mask_first;       // window 0's previous half masked (no pk, or left_edge)
  float scale;          // D^-1/2 rounded to bf16
  int nq, W, BH, items;  // query tiles per window, windows, B * H, work items
};

// The shared-memory geometry of head dim D padded to 16 kD16: rows of kSpan
// elements (32, 64 or 128 bytes, the swizzle of that width), two such column
// halves at D = 128.
template <int kD16>
struct Geo {
  static constexpr int kDp = 16 * kD16;
  static constexpr int kSpan = kDp < 64 ? kDp : 64;
  static constexpr int kRow = 2 * kSpan;                 // bytes of a swizzled row
  static constexpr int kHalves = kDp / kSpan;
  static constexpr int kLayout = kRow == 128 ? 1 : kRow == 64 ? 2 : 3;
  static constexpr int kSteps = kSpan / 16;              // k16 steps of a row span
  static constexpr int kHalfTile = kKeys * kRow;         // bytes of a K or V tile's half
  static constexpr int kTile = kHalves * kHalfTile;
  static constexpr int kHalfQ = kQRows * kRow;
  static constexpr int kQ = kHalves * kHalfQ;
  static constexpr int kStages = kD16 <= 2 ? 4 : 3;
  // Q's fragments loaded per key tile, not once per item: at 64 columns
  // (kD16 = 4, one half of 128-byte rows) ptxas gave P's A fragments the
  // registers of Q's, so the unmasked branch's table loads and P's packs
  // overwrote Q before the next key tile's S product read it (ROADMAP C4;
  // the other instantiations keep Q in registers across the item)
  static constexpr bool kQPerTile = kD16 == 4;
  static_assert(kD16 == 1 || kD16 == 2 || kD16 == 4 || kD16 == 8, "D padded to 16, 32, 64 or 128");
};

// byte offset of 16-byte chunk c of row r in a swizzled tile of kRow-byte
// rows (TMA's CU_TENSOR_MAP_SWIZZLE_{128,64,32}B, the tile 1024-byte aligned)
template <int kRow>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (kRow == 128) return r * 128 + ((c ^ (r & 7)) << 4);
  else if constexpr (kRow == 64) return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
  else return r * 32 + ((c ^ ((r >> 2) & 1)) << 4);
}

// byte offset of element e (a multiple of 4) of row r in a tile of `rows` rows
template <int kD16>
__device__ __forceinline__ int elem_offset(int r, int e, int rows) {
  using G = Geo<kD16>;
  const int half = e / G::kSpan, w = e - half * G::kSpan;
  return half * rows * G::kRow + swz<G::kRow>(r, w >> 3) + 2 * (w & 7);
}

struct Item {
  int i0, w, b, h;
};

// Work item idx, longest first: windows w >= 1 (n keys more), then window 0,
// each from the last query tile to the first (ops/kernels/local_attention.py:
// work_item is its host twin)
__device__ __forceinline__ Item work_item(const Params& p, int idx) {
  const int rest = (p.W - 1) * p.BH;
  int qt, w, bh;
  if (idx < p.nq * rest) {
    qt = p.nq - 1 - idx / rest;
    const int r = idx - (p.nq - 1 - qt) * rest;
    w = 1 + r / p.BH;
    bh = r - (w - 1) * p.BH;
  } else {
    const int j = idx - p.nq * rest;
    qt = p.nq - 1 - j / p.BH;
    w = 0;
    bh = j - (p.nq - 1 - qt) * p.BH;
  }
  const int b = bh / p.H;
  return {qt * kQRows, w, b, bh - b * p.H};
}

// the first key of item it's tiles: n where window 0's previous half is masked
__device__ __forceinline__ int key_begin(const Params& p, const Item& it) {
  return it.w == 0 && p.mask_first ? p.n : 0;
}

// key tiles of item it: keys key_begin .. n + i0 + rows - 1 (its last row's last key)
__device__ __forceinline__ int key_tiles(const Params& p, const Item& it) {
  const int rows = min(kQRows, p.n - it.i0);
  return (p.n + it.i0 + rows - key_begin(p, it) + kKeys - 1) / kKeys;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t scale_pair(uint32_t x, float s) {
  return ptx::bf16x2_rn(__uint_as_float(x << 16) * s, __uint_as_float(x & 0xffff0000u) * s);
}

// One side of a key tile: rows of one head of a tensor, row r at time t0 + r,
// valid below T.
struct Rows {
  const bf16* src;
  long long st, t0;
  int T;
};

// the cp.async copy: rows [0, rows) of a swizzled tile, 8-byte pieces, row r
// from a for r < split and from b past it, zero outside [0, T) and past D
template <int kD16>
__device__ __forceinline__ void copy_rows2(unsigned char* dst, const Rows& a, const Rows& b,
                                           int split, int rows, int D, int lane) {
  constexpr int kPieces = Geo<kD16>::kDp / 4;
  for (int e = lane; e < rows * kPieces; e += 32) {
    const int r = e / kPieces, c = 4 * (e - r * kPieces);
    const Rows& s = r < split ? a : b;
    const long long t = s.t0 + r;
    const bool ok = t >= 0 && t < s.T && c < D;
    ptx::cp_async8(dst + elem_offset<kD16>(r, c, rows), ok ? s.src + t * s.st + c : s.src,
                   ok ? 8 : 0);
  }
}

// the cp.async route: rows [0, rows) of the (time t0 + r) rows of one head
template <int kD16>
__device__ __forceinline__ void copy_rows(unsigned char* dst, const bf16* src, long long st,
                                          long long t0, int rows, int T, int D, int lane) {
  const Rows a{src, st, t0, T};
  copy_rows2<kD16>(dst, a, a, rows, rows, D, lane);
}

template <int kD16, int kBias, int kRoute>
__global__ void __launch_bounds__(kThreads, kD16 <= 2 ? 2 : 1)
    attention_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_kp,
                          const __grid_constant__ CUtensorMap map_pk,
                          const __grid_constant__ CUtensorMap map_pv, const Params p) {
  using G = Geo<kD16>;
  constexpr int S = G::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - ptx::smem_addr(smem_raw) % 1024) % 1024);
  unsigned char* ring = smem;                        // S x [K tile | V tile]
  unsigned char* qbuf = ring + S * 2 * G::kTile;     // kQRows query rows
  uint64_t* full = reinterpret_cast<uint64_t*>(qbuf + G::kQ);
  uint64_t* empty = full + S;
  uint64_t* q_full = empty + S;
  uint64_t* q_empty = q_full + 1;
  float* tabs = reinterpret_cast<float*>(q_empty + 1);  // per warpgroup: [lo pad | 2n | hi pad]
  const int n = p.n, tab_len = kTabLo + 2 * n + kTabHi;
  constexpr bool kTmaRoute = kRoute == kTma;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      ptx::mbar_init(&full[s], kTmaRoute ? 1 : 32);
      ptx::mbar_init(&empty[s], 128 * kConsumers);
    }
    ptx::mbar_init(q_full, kTmaRoute ? 1 : 32);
    ptx::mbar_init(q_empty, 128 * kConsumers);
    ptx::fence_mbarrier_init();
  }
  if (kBias == kTableBias)  // the pads, never written again
    for (int e = threadIdx.x; e < kConsumers * (kTabLo + kTabHi); e += kThreads) {
      const int wg = e / (kTabLo + kTabHi), u = e - wg * (kTabLo + kTabHi);
      tabs[wg * tab_len + (u < kTabLo ? u : 2 * n + u)] = 0.0f;
    }
  __syncthreads();

  if (threadIdx.x >= kProducer) {  // ---- producer warp ----
    const int lane = threadIdx.x - kProducer;
    // with the previous-window operands the TMA route's lanes copy the tile across key n
    const bool prev_ops = p.kp != nullptr || p.pk != nullptr;
    if (kTmaRoute && lane != 0 && !prev_ops) return;
    int c = 0;
    uint32_t qe = 1;  // a fresh barrier's parity-1 wait passes: no item before the first
    uint64_t* pending = nullptr;  // cp.async: the barrier of the last group, signalled one group late
    auto signal = [&](uint64_t* bar) {
      ptx::cp_async_commit();
      ptx::cp_async_wait<1>();
      ptx::fence_proxy_async();
      if (pending != nullptr) ptx::mbar_arrive(pending);
      pending = bar;
    };
    for (int idx = blockIdx.x; idx < p.items; idx += gridDim.x) {
      const Item it = work_item(p, idx);
      const int j_begin = key_begin(p, it);
      const int ntiles = key_tiles(p, it);
      const int tq = it.w * n + it.i0;  // time of the item's query row 0
      // keys j < n: window 0 from pk / pv (row j), a later window from kp (or
      // k) and v at time (w - 1) n + j; keys j >= n from k and v
      const bool alt = it.w == 0 ? p.pk != nullptr : p.kp != nullptr;
      const long long hb = static_cast<long long>(it.b) * p.H + it.h;
      const Rows kcur{p.k + it.b * p.ks[0] + it.h * p.ks[1], p.ks[2], 0, p.T};
      const Rows vcur{p.v + it.b * p.vs[0] + it.h * p.vs[1], p.vs[2], 0, p.T};
      const Rows kprev = it.w == 0 ? Rows{p.pk + hb * n * p.D, p.D, 0, n}
                         : alt     ? Rows{p.kp + it.b * p.kps[0] + it.h * p.kps[1], p.kps[2], 0,
                                          p.T}
                                   : kcur;
      const Rows vprev = it.w == 0 ? Rows{p.pv + hb * n * p.D, p.D, 0, n} : vcur;
      ptx::mbar_wait(q_empty, qe);
      qe ^= 1;
      if constexpr (kTmaRoute) {
        if (lane == 0) {
          ptx::mbar_arrive_expect_tx(q_full, G::kQ);
          for (int hf = 0; hf < G::kHalves; ++hf)
            ptx::tma_load_4d(qbuf + hf * G::kHalfQ, &map_q, q_full, hf * G::kSpan, tq, it.h,
                             it.b);
        }
      } else {
        copy_rows<kD16>(qbuf, p.q + it.b * p.qs[0] + it.h * p.qs[1], p.qs[2], tq, kQRows, p.T,
                        p.D, lane);
        signal(q_full);
      }
      for (int t = 0; t < ntiles; ++t, ++c) {
        const int s = c % S;
        ptx::mbar_wait(&empty[s], ((c / S) & 1) ^ 1);
        unsigned char* kt = ring + s * 2 * G::kTile;
        const int j0 = j_begin + t * kKeys;
        const int tk = (it.w - 1) * n + j0;  // time of the tile's key 0
        // the tile's first `split` keys are previous-half keys (0 .. 64)
        const int split = alt ? min(max(n - j0, 0), kKeys) : 0;
        // a previous-half row r sits at pk row j0 + r (window 0) or time tk + r
        const long long tp = it.w == 0 ? j0 : tk;
        if (kTmaRoute && (split == 0 || split == kKeys)) {
          if (lane == 0) {
            const bool prev = split == kKeys;
            const CUtensorMap* mk = !prev ? &map_k : it.w == 0 ? &map_pk : &map_kp;
            const CUtensorMap* mv = prev && it.w == 0 ? &map_pv : &map_v;
            const int row = prev ? static_cast<int>(tp) : tk;
            ptx::mbar_arrive_expect_tx(&full[s], 2 * G::kTile);
            for (int hf = 0; hf < G::kHalves; ++hf) {
              ptx::tma_load_4d(kt + hf * G::kHalfTile, mk, &full[s], hf * G::kSpan, row, it.h,
                               it.b);
              ptx::tma_load_4d(kt + G::kTile + hf * G::kHalfTile, mv, &full[s], hf * G::kSpan,
                               row, it.h, it.b);
            }
          }
        } else {
          const Rows ka{kprev.src, kprev.st, tp, kprev.T}, kb{kcur.src, kcur.st, tk, kcur.T};
          const Rows va{vprev.src, vprev.st, tp, vprev.T}, vb{vcur.src, vcur.st, tk, vcur.T};
          copy_rows2<kD16>(kt, ka, kb, split, kKeys, p.D, lane);
          copy_rows2<kD16>(kt + G::kTile, va, vb, split, kKeys, p.D, lane);
          if constexpr (kTmaRoute) {  // the tile across key n: complete it here
            ptx::cp_async_commit();
            ptx::cp_async_wait<0>();
            ptx::fence_proxy_async();
            __syncwarp();
            if (lane == 0) ptx::mbar_arrive(&full[s]);
          } else {
            signal(&full[s]);
          }
        }
      }
    }
    if constexpr (!kTmaRoute) {
      ptx::cp_async_wait<0>();
      ptx::fence_proxy_async();
      if (pending != nullptr) ptx::mbar_arrive(pending);
    }
    return;
  }

  // ---- consumers: warpgroup cw takes rows 64 cw .. 64 cw + 63 of each item ----
  const int cw = threadIdx.x / 128, ct = threadIdx.x % 128;
  const int warp = ct >> 5, lane = ct & 31, g = lane >> 2, t4 = lane & 3;
  const int q8 = lane >> 3, r8 = lane & 7;
  float* tab = tabs + cw * tab_len + kTabLo;  // tab[e], e in [-kTabLo, 2n + kTabHi)
  constexpr int kO = G::kSpan / 2;            // accumulators of one O half
  int c = 0;
  uint32_t qf_par = 0;
  for (int idx = blockIdx.x; idx < p.items; idx += gridDim.x) {
    const Item it = work_item(p, idx);
    const int j_begin = key_begin(p, it);
    const int ntiles = key_tiles(p, it);
    const int i0w = it.i0 + 64 * cw;            // this warpgroup's first row
    const int r_hi = min(i0w + 63, n - 1);      // its last row that is stored
    const int ia = i0w + 16 * warp + g;         // this thread's rows ia, ia + 8
    if constexpr (kBias == kTableBias) {
      ptx::bar_sync(1 + cw, 128);  // the last item's readers are done
      const float* src = p.table + static_cast<long long>(it.h) * 2 * n;
      for (int e = ct; e < 2 * n; e += 128) tab[e] = __ldg(src + e);
      ptx::bar_sync(1 + cw, 128);
    }
    // Q's A fragments, scaled as they load: once per item, or per key tile
    // (kQPerTile), the Q buffer then held until the item's last tile
    ptx::mbar_wait(q_full, qf_par);
    qf_par ^= 1;
    uint32_t qf[kD16][4];
    auto load_q = [&] {
#pragma unroll
      for (int kk = 0; kk < kD16; ++kk) {
        const int chunk = 2 * kk + (q8 >> 1), hf = chunk / (G::kSpan / 8);
        const int r = 64 * cw + 16 * warp + (q8 & 1) * 8 + r8;
        ptx::ldmatrix_x4(qf[kk], qbuf + hf * G::kHalfQ + swz<G::kRow>(r, chunk % (G::kSpan / 8)));
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[kk][e] = scale_pair(qf[kk][e], p.scale);
      }
    };
    if constexpr (!G::kQPerTile) {
      load_q();
      ptx::mbar_arrive(q_empty);
    }

    float o[G::kHalves][kO];
#pragma unroll
    for (int hf = 0; hf < G::kHalves; ++hf)
#pragma unroll
      for (int e = 0; e < kO; ++e) o[hf][e] = 0.0f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;

    for (int t = 0; t < ntiles; ++t, ++c) {
      const int s = c % S;
      const int j0 = j_begin + t * kKeys;
      ptx::mbar_wait(&full[s], (c / S) & 1);
      if (i0w < n && j0 <= n + r_hi) {  // warpgroup-uniform: some key of the tile is kept
        const unsigned char* kt = ring + s * 2 * G::kTile;
        const unsigned char* vt = kt + G::kTile;
        // S = (q scale) K^T: kD16 k16 steps, K K-major in its swizzle
        if constexpr (G::kQPerTile) load_q();
        float sc[32];
#pragma unroll
        for (int kk = 0; kk < kD16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) ptx::fence_operand(qf[kk][e]);
        ptx::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kD16; ++kk) {
          const int hf = kk / G::kSteps;
          ptx::wgmma_bf16_rs<64, 0>(
              sc, qf[kk],
              ptx::wgmma_desc_swz(kt + hf * G::kHalfTile + 32 * (kk % G::kSteps), 16,
                                  8 * G::kRow, G::kLayout),
              kk > 0);
        }
        ptx::wgmma_commit();
        ptx::wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 32; ++e) ptx::fence_operand(sc[e]);

        // x = s log2 e + bias log2 e; sc[4 j + e]: row ia, key j0 + 8 j + 2 t4 + e;
        // sc[4 j + 2 + e]: row ia + 8. Its table index n + i - key is base -
        // 8 j - e (row ia) and base + 8 - 8 j - e (row ia + 8).
        const int base = n + ia - j0 - 2 * t4;
        const bool diag = j0 + kKeys - 1 > n + i0w;  // a key of the tile is masked for some row
        if constexpr (kBias == kTableBias) {
          const float* tp = tab + base;
          float tv[18];
          tv[0] = tp[8];
          tv[1] = tp[7];
#pragma unroll
          for (int j = 0; j < 8; ++j) tv[2 + 2 * j] = tp[-8 * j], tv[3 + 2 * j] = tp[-8 * j - 1];
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              sc[4 * j + e] = fmaf(sc[4 * j + e], kLog2e, tv[2 + 2 * j + e]);
              sc[4 * j + 2 + e] = fmaf(sc[4 * j + 2 + e], kLog2e, tv[2 * j + e]);
            }
        } else if constexpr (kBias == kFullBias) {
          const bf16* bh = p.bias + static_cast<long long>(it.h) * n * 2 * n;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = ia + 8 * (e >> 1), key = j0 + 8 * j + 2 * t4 + (e & 1);
              const float bv = i < n && key < 2 * n
                                   ? __bfloat162float(bh[static_cast<long long>(i) * 2 * n + key])
                                   : 0.0f;
              sc[4 * j + e] = (sc[4 * j + e] + bv) * kLog2e;
            }
        } else {
#pragma unroll
          for (int e = 0; e < 32; ++e) sc[e] *= kLog2e;
        }
        if (diag || kBias == kFullBias) {  // the causal mask: key <= n + i
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (base - 8 * j - e < 0) sc[4 * j + e] = -INFINITY;
              if (base + 8 - 8 * j - e < 0) sc[4 * j + 2 + e] = -INFINITY;
            }
        }
        float mx_a = sc[0], mx_b = sc[2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
        const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
        // a row with no kept key yet keeps the max 0: no -inf - -inf
        const float mu_a = mn_a == -INFINITY ? 0.0f : mn_a;
        const float mu_b = mn_b == -INFINITY ? 0.0f : mn_b;
        const float c_a = ptx::ex2(m_a - mu_a), c_b = ptx::ex2(m_b - mu_b);
        m_a = mn_a;
        m_b = mn_b;
        float ps_a = 0.0f, ps_b = 0.0f;
        uint32_t pf[4][4];  // P's A fragments, k16 step kk: accumulator pairs 8 kk .. 8 kk + 7
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p0 = ptx::ex2(sc[4 * j] - mu_a), p1 = ptx::ex2(sc[4 * j + 1] - mu_a);
          const float p2 = ptx::ex2(sc[4 * j + 2] - mu_b), p3 = ptx::ex2(sc[4 * j + 3] - mu_b);
          ps_a += p0 + p1;
          ps_b += p2 + p3;
          pf[j >> 1][2 * (j & 1)] = ptx::bf16x2_rn(p0, p1);
          pf[j >> 1][2 * (j & 1) + 1] = ptx::bf16x2_rn(p2, p3);
        }
        l_a = l_a * c_a + ps_a;  // per-lane partial sums; the quad adds them at the end
        l_b = l_b * c_b + ps_b;
#pragma unroll
        for (int hf = 0; hf < G::kHalves; ++hf)
#pragma unroll
          for (int e = 0; e < kO; e += 4) {
            o[hf][e] *= c_a;
            o[hf][e + 1] *= c_a;
            o[hf][e + 2] *= c_b;
            o[hf][e + 3] *= c_b;
          }
        // O += bf16(P) V: four k16 steps of 16 keys, V MN-major in its swizzle.
        // The rescaled O and the packed P are pinned above the fence: the
        // compiler must not sink a write of a wgmma operand past it.
#pragma unroll
        for (int hf = 0; hf < G::kHalves; ++hf)
#pragma unroll
          for (int e = 0; e < kO; ++e) ptx::fence_operand(o[hf][e]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) ptx::fence_operand(pf[kk][e]);
        ptx::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int hf = 0; hf < G::kHalves; ++hf)
            ptx::wgmma_bf16_rs<G::kSpan, 1>(
                o[hf], pf[kk],
                ptx::wgmma_desc_swz(vt + hf * G::kHalfTile + kk * 16 * G::kRow, 8 * G::kRow,
                                    8 * G::kRow, G::kLayout),
                1);
        ptx::wgmma_commit();
        ptx::wgmma_wait<0>();
        // O is final, and P's registers, which the wgmma read until now, may
        // be reused: the compiler must not write them before the wait
#pragma unroll
        for (int hf = 0; hf < G::kHalves; ++hf)
#pragma unroll
          for (int e = 0; e < kO; ++e) ptx::fence_operand(o[hf][e]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) ptx::fence_operand(pf[kk][e]);
      }
      // every consumer thread after its own wait: a warp's wgmma_wait covers
      // its own part of the warpgroup's products, not its siblings' reads
      ptx::mbar_arrive(&empty[s]);
    }
    if constexpr (G::kQPerTile) ptx::mbar_arrive(q_empty);

    // out[b, t, h, :] = O / sum: o[hf][4 j + e] is row ia + 8 (e >> 1), column
    // 64 hf + 8 j + 2 t4 + (e & 1)
    const float inv_a = 1.0f / quad_sum(l_a), inv_b = 1.0f / quad_sum(l_b);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = ia + 8 * rr;
      if (i >= n) continue;
      const float inv = rr ? inv_b : inv_a;
      bf16* orow = p.out + ((static_cast<long long>(it.b) * p.T + static_cast<long long>(it.w) * n +
                            i) * p.H + it.h) * p.D;
#pragma unroll
      for (int hf = 0; hf < G::kHalves; ++hf)
#pragma unroll
        for (int j = 0; j < G::kSpan / 8; ++j) {
          const int d = hf * 64 + 8 * j + 2 * t4;
          if (d < p.D)
            *reinterpret_cast<uint32_t*>(orow + d) =
                ptx::bf16x2_rn(o[hf][4 * j + 2 * rr] * inv, o[hf][4 * j + 2 * rr + 1] * inv);
        }
    }
  }
}

// ---- host side ----------------------------------------------------------

// The 4-D map (D, T, H, B) of one operand, boxes of kSpan x rows x 1 x 1 in
// the swizzle of its row width; D is the tensor's extent, so the padded
// columns arrive as zeros.
template <int kD16>
cudaError_t encode_map(CUtensorMap* m, const void* base, int B, int H, int T, int D,
                       const long long* st, int rows) {
  using G = Geo<kD16>;
  const auto fn = l3ac::sm90::encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  // a dim of extent 1 has stride 0 here; any multiple of 16 bytes will do
  auto bytes = [](long long s) { return static_cast<cuuint64_t>(s > 0 ? 2 * s : 16); };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(st[2]), bytes(st[1]), bytes(st[0])};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(G::kSpan), static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = G::kRow == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : G::kRow == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kD16>
size_t smem_bytes(int n, bool table) {
  using G = Geo<kD16>;
  return 1024 + static_cast<size_t>(G::kStages) * 2 * G::kTile + G::kQ +
         8 * (2 * G::kStages + 2) +
         (table ? sizeof(float) * kConsumers * (kTabLo + 2 * n + kTabHi) : 0);
}

template <int kD16, int kBias, int kRoute>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<kD16>(p.n, kBias == kTableBias);
  if (smem > l3ac::sm90::kMaxSmem) return cudaErrorInvalidValue;
  CUtensorMap maps[6];  // q, k, v, kp, pk, pv (the last three where given)
  std::memset(maps, 0, sizeof(maps));
  if constexpr (kRoute == kTma) {
    const long long pst[3] = {static_cast<long long>(p.H) * p.n * p.D,
                              static_cast<long long>(p.n) * p.D, p.D};
    const void* bases[6] = {p.q, p.k, p.v, p.kp, p.pk, p.pv};
    const long long* st[6] = {p.qs, p.ks, p.vs, p.kps, pst, pst};
    for (int i = 0; i < 6; ++i) {
      if (bases[i] == nullptr) continue;
      const cudaError_t err = encode_map<kD16>(&maps[i], bases[i], B, p.H, i >= 4 ? p.n : p.T,
                                               p.D, st[i], i == 0 ? kQRows : kKeys);
      if (err != cudaSuccess) return err;
    }
  }
  auto kernel = attention_bf16_kernel<kD16, kBias, kRoute>;
  // the attribute once, the occupancy once per shared-memory size: both are
  // host calls of microseconds, and the n = 250 launch lasts about fifteen
  static bool attr_set = false;
  static size_t occ_smem = 0;
  static int per_sm = 0;
  cudaError_t err = cudaSuccess;
  if (!attr_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(l3ac::sm90::kMaxSmem));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  if (occ_smem != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    occ_smem = smem;
  }
  if (per_sm < 1) return cudaErrorInvalidValue;
  const int cap = per_sm * l3ac::sm90::sm_count();
  const int grid = p.items < cap ? p.items : cap;
  kernel<<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
                                           p);
  return cudaGetLastError();
}

template <int kD16, int kRoute>
cudaError_t launch_bias(const Params& p, int B, cudaStream_t stream) {
  if (p.table != nullptr) return launch<kD16, kTableBias, kRoute>(p, B, stream);
  if (p.bias != nullptr) return launch<kD16, kFullBias, kRoute>(p, B, stream);
  return launch<kD16, kNoBias, kRoute>(p, B, stream);
}

template <int kD16>
cudaError_t launch_route(const Params& p, int B, int route, cudaStream_t stream) {
  return route == kTma ? launch_bias<kD16, kTma>(p, B, stream)
                       : launch_bias<kD16, kCpAsync>(p, B, stream);
}

bool aligned(const void* ptr, int bytes) { return reinterpret_cast<uintptr_t>(ptr) % bytes == 0; }

}  // namespace

// q, k, v, kp: bf16 (B, H, T, D) with element strides (sB, sH, sT, 1) each
// (0 for a dim of extent 1; kp null: window w >= 1 reads its previous keys
// from k); D a multiple of 4 up to 128; T a multiple of n. pk, pv: bf16 (B,
// H, n, D) contiguous, both or neither; left_edge 1 masks window 0's previous
// half all the same. bias: bf16 (H, n, 2n) contiguous, or table: the
// prepared fp32 (H, 2n) table times log2 e
// (ops/kernels/local_attention.py:prepare_table), or neither (not both).
// out: bf16 (B, T, H, D) contiguous. scale: D^-1/2 rounded to bf16. route 0
// (TMA): every stride (with pk, D too) a multiple of 8 and every operand
// 16-byte aligned; route 1 (cp.async): strides multiples of 4, pointers
// 8-byte aligned. Returns the CUDA error code (invalid value for what it
// does not take).
extern "C" int l3ac_local_attention_bf16(const void* q, const void* k, const void* v,
                                         const void* kp, const void* pk, const void* pv,
                                         const void* bias, const float* table, void* out, int B,
                                         int H, int T, int n, int D, int left_edge,
                                         long long qsB, long long qsH, long long qsT,
                                         long long ksB, long long ksH, long long ksT,
                                         long long vsB, long long vsH, long long vsT,
                                         long long kpsB, long long kpsH, long long kpsT,
                                         float scale, int route, void* stream) {
  const long long strides[13] = {qsB, qsH, qsT, ksB, ksH, ksT, vsB, vsH, vsT,
                                 kp != nullptr ? kpsB : 0, kp != nullptr ? kpsH : 0,
                                 kp != nullptr ? kpsT : 0, pk != nullptr ? D : 0};
  const int align = route == kTma ? 16 : 8;
  bool ok = B >= 1 && H >= 1 && n >= 1 && T >= n && T % n == 0 && D >= 4 && D <= 128 &&
            D % 4 == 0 && (route == kTma || route == kCpAsync) &&
            !(bias != nullptr && table != nullptr) && aligned(q, align) && aligned(k, align) &&
            aligned(v, align) && aligned(kp, align) && aligned(pk, align) &&
            aligned(pv, align) && (pk == nullptr) == (pv == nullptr) && aligned(out, 4);
  for (long long s : strides) ok = ok && s % (align / 2) == 0;
  const long long BH = static_cast<long long>(B) * H, W = T / n, nq = (n + kQRows - 1) / kQRows;
  ok = ok && nq * W * BH <= 0x7fffffffLL;
  if (!ok) return cudaErrorInvalidValue;
  const Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<const bf16*>(kp),
                 static_cast<const bf16*>(pk), static_cast<const bf16*>(pv),
                 static_cast<const bf16*>(bias), table, static_cast<bf16*>(out),
                 {qsB, qsH, qsT}, {ksB, ksH, ksT}, {vsB, vsH, vsT}, {kpsB, kpsH, kpsT},
                 H, T, n, D, pk == nullptr || left_edge != 0 ? 1 : 0, scale,
                 static_cast<int>(nq), static_cast<int>(W), static_cast<int>(BH),
                 static_cast<int>(nq * W * BH)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // k16 steps: 1, 2, 4 or 8, D zero-padded to them
  // (ops/kernels/local_attention.py:instance_for is the host twin)
  const int d16 = (D + 15) / 16;
  if (d16 <= 2) return d16 == 1 ? launch_route<1>(p, B, route, s) : launch_route<2>(p, B, route, s);
  return d16 <= 4 ? launch_route<4>(p, B, route, s) : launch_route<8>(p, B, route, s);
}
