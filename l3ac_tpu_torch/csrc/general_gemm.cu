// The general routes' product on the tensor cores (ROADMAP C3): every
// operand the fast GEMM cores (tc_gemm.cuh, gemm_sm90.cuh) do not read.
//
//   out = act(prologue(A) B^T + bias) (+ residual),
//
// A(m, k) an activation read in place by its strides: m = (b, t) with b = m /
// a_rows, t = m % a_rows; k = (tap, c) with c < C channels and taps 1 or 7,
// tap k reading row t + (k - taps / 2) dil, zero outside [0, a_rows) (a
// SAME-padded k7 conv at any dilation as one product). A may be the pair of
// stride-2 phase arrays of the decoder's last up path: x(t) = x_{t % 2}[t /
// 2]. The prologue is an optional snake, snake(x, alpha[c]). B is (taps, N,
// ldb), tap-major (the caller reorders a k7 conv's (N, C, 7) weight once,
// ops/kernels/legacy_tail.py:prepared_general); fp32 optionally with the
// TF32 lo term of a prepared split (b_lo). The epilogue: bias, snake, exact
// GELU or tanh, a residual read through its own address map (the phase pair
// too) and round_mid (the product + bias rounded to bf16 before the
// residual); bf16 or fp32 operands and output. Replaces no TPU kernel by
// itself: it is the product of the general routes that stand in for
// l3ac_tpu/ops/pallas/legacy_tail.py (every C past the tensor-core tail's
// multiples of 4 up to 64) and l3ac_tpu/ops/pallas/upsample.py:up_fused_ct
// (past 128 channels).
//
// Bound on the H100: the products (at the tail's C = 96: 14.2 GFLOP a
// (2, 96, 16000) call, 0.086 ms as 3 TF32 passes, 0.014 ms in bf16); the
// bytes where K is small (the (B, C, T) up path's 12 -> 200 conv writes a
// (B T, 200) fp32 z). The design (ROADMAP C3):
//
// - One block per tile of 128 time rows of one batch row and one tile of
//   columns sized to N (kN = 16, 32, 64, 96 or 128: N = 96 is one tile, the
//   output conv's N = 1 the narrow 16): bf16 8 warps of 32 x kN / 2 (two
//   blocks an SM), fp32 16 warps of 16 x kN / 2 (one block an SM: the
//   3xTF32 fragments' registers).
// - The block stages A once per chunk of cw channels (all of C where shared
//   memory allows: cw up to 256, one chunk at the tail's widths), as a
//   window of the rows [t0 - 3 dil, t0 + 128 + 3 dil): 16-byte cp.async
//   blocks along the contiguous axis (time in the channels-first layouts
//   and the phase pair, channels in the channels-last one) into a raw
//   buffer, at any element offset (each row's blocks start at the 16-byte
//   boundary below its first element). A fill pass then writes the window
//   as [t][c] rows of cw + 4 fp32 / cw + 8 bf16 (the eight rows of an
//   ldmatrix on distinct banks), zeros outside [0, a_rows) and past C,
//   then the prologue's snake once per element (l3ac::snake in fp32,
//   rounded to bf16 where the activations are bf16), after the zero fill:
//   snake(0) = 0 exactly, so the window is the one a snake before the fill
//   gives, and the fill runs four elements a thread at once with no branch
//   on the edges (each element's chain of a load, sinf, an IEEE division
//   and a rounding is long, the warps few). A layout with neither axis
//   contiguous (a strided view) fills the window by element loads instead
//   (`stage` 0, chosen by the wrapper from the strides and counted in
//   conv_unit.GEMM_STAGING).
// - The k7 conv is seven products on row-shifted views of that one window:
//   tap k's A fragments start k dil rows down. Each A element is read from
//   device memory once per chunk (with the halo rows of the neighbouring
//   tiles), not once per tap. A step is one tap over the chunk's channels:
//   seven steps, a barrier each, at C = 96 (the first design stepped 32
//   channels at a time: 21 steps, each too short to cover the next slice's
//   copy; tools/general_tail_variants.py times both).
// - A's fragments by ldmatrix from the window: bf16 stays bf16 (m16n8k16),
//   fp32 is split into TF32 hi / lo at the fragment (3xTF32 m16n8k8,
//   tc_gemm.cuh's scheme, with its fresh accumulator per K step of 32
//   channels). B streams by cp.async, one (chunk, tap) slice of kN rows x
//   cw a stage, through a 3-stage ring two steps ahead (its stages past the
//   first hold the raw blocks until the window is filled, the first slice
//   loading beside them), its fragments by ldmatrix
//   too (fp32 split at the fragment like A's; with b_lo, the prepared hi
//   and lo as they are).
// - The epilogue adds the bias and the activation to the accumulators,
//   stages the tile in shared memory ([n][t] for a channels-first output,
//   [t][n] for a channels-last one) and stores it in 16-byte pieces along
//   the output's contiguous axis, each with its residual piece.
//
// Rounding: where the bf16 plain versions round (ops/kernels/*.py): bf16
// operands with fp32 sums, the prologue's snake rounded to bf16 as the plain
// version stores it, the product + bias rounded before a residual where
// round_mid, one rounding at the store.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "ptx.cuh"

namespace {

namespace ptx = l3ac::ptx;
using bf16 = __nv_bfloat16;

constexpr int kStageElement = 0;  // A by element loads (no contiguous axis)
constexpr int kStageTime = 1;     // A contiguous along t (channels-first, the phase pair)
constexpr int kStageChannel = 2;  // A contiguous along c (channels-last)

struct GemmArgs {
  const void* a;      // A's storage; with a1 the even phase of the pair
  const void* a1;     // the pair's odd phase: x(t) = (t odd ? a1 : a)[.. + (t / 2) a_st], or null
  long long a_sb, a_st, a_sk;
  int a_rows, C, taps, dil, a_bf;
  const float* pro;   // the prologue snake's alpha (C,), or null
  int stage;          // kStage*
  const void* b;      // (taps, N, ldb) of A's dtype
  const float* b_lo;  // fp32: with b the TF32 hi / lo of a prepared split, or null
  int ldb;
  const float* bias;   // (N,) or null
  const float* alpha;  // (N,) the epilogue's snake, act 1
  int act;             // 0 none, 1 snake, 2 exact GELU, 3 tanh
  const void* res;     // residual, or null; res1: its pair's odd phase
  const void* res1;
  long long r_sb, r_st, r_sn;
  int res_bf, round_mid;
  void* out;
  long long o_sb, o_st, o_sn;
  int o_rows, o_bf;
  long long M;
  int N;
  // set by the launcher
  int tiles;      // kM-row tiles of one batch row
  int cw;         // channels a chunk (a multiple of 32): the window's and a B stage's width
  int ldw;        // a window / B-stage row, elements: cw + 4 (fp32) / + 8 (bf16)
  int win_rows;   // window rows: kM + (taps - 1) dil, rounded up to 8
  int raw_ld;     // raw row length, elements
  int raw_rows;   // raw rows a chunk (kStageTime: cw x phases; kStageChannel: win_rows)
  int raw_blocks; // 16-byte blocks a raw row holds
  int stages;     // B ring stages: 3, or the taps where fewer
  int b_vec;      // B rows by 16-byte cp.async (else element loads)
  int out_cf;     // the epilogue's tile [n][t] (channels-first output) or [t][n]
  int o_vec, r_vec;  // 16-byte output / residual pieces
};

template <bool kBf, int kNT>
struct Tile {
  static constexpr int kWM = kBf ? 4 : 8, kWN = 2;  // warps along M and N
  static constexpr int kThreads = 32 * kWM * kWN;   // 256 bf16 (2 blocks an SM), 512 fp32 (1)
  static constexpr int kMT = kBf ? 2 : 1;      // m16 tiles a warp
  static constexpr int kM = kWM * kMT * 16;    // rows a block: 128
  static constexpr int kN = kWN * kNT * 8;     // columns a block
  static constexpr int kKs = 32;               // K step (fp32: a fresh accumulator each)
  static constexpr int kEs = kBf ? 2 : 4;
  static constexpr int kV = 16 / kEs;          // elements a 16-byte block
  static constexpr int kPad = kBf ? 8 : 4;     // row padding: ldmatrix's 8 rows on distinct banks
  static constexpr int kBRows = kN + 8;        // an x4 ldmatrix reads 16 rows from any n8 tile
  static constexpr int kStages = 3;            // the B ring at most
  static constexpr int kLdoCf = kM + 4;        // epilogue tile [n][t]
  static constexpr int kLdoCl = kN + 8;        // epilogue tile [t][n]
  static constexpr int kBudget = kBf ? 113 * 1024 : 227 * 1024;  // shared memory a block
};

template <bool kBf>
__device__ __forceinline__ float load(const void* p, long long i) {
  if constexpr (kBf) return __bfloat162float(static_cast<const bf16*>(p)[i]);
  else return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float ld(const void* p, long long i, int bf) {
  return bf ? __bfloat162float(static_cast<const bf16*>(p)[i]) : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, long long i, float v, int bf) {
  if (bf)
    static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
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

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return q * b > a ? q - 1 : q;
}

// The element of A at channel c, time t (0 <= t < a_rows) of batch row b.
template <bool kBf>
__device__ __forceinline__ float a_elem(const GemmArgs& g, long long b, int c, long long t) {
  const long long base = b * g.a_sb + c * g.a_sk;
  if (g.a1) return load<kBf>(t & 1 ? g.a1 : g.a, base + (t >> 1) * g.a_st);
  return load<kBf>(g.a, base + t * g.a_st);
}

// The prologue: snake(v, alpha[c]) in fp32, rounded where A is bf16.
template <bool kBf>
__device__ __forceinline__ float prologue(const GemmArgs& g, float v, int c) {
  if (g.pro == nullptr) return v;
  const float s = l3ac::snake(v, g.pro[c]);
  return kBf ? l3ac::round_bf16(s) : s;
}

template <bool kBf, int kNT>
__global__ void __launch_bounds__(Tile<kBf, kNT>::kThreads, kBf ? 2 : 1)
    window_gemm_kernel(const GemmArgs g) {
  using L = Tile<kBf, kNT>;
  using E = std::conditional_t<kBf, bf16, float>;
  extern __shared__ __align__(16) unsigned char smem_gemm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % L::kWM, wn = warp / L::kWM, gq = lane >> 2, tq = lane & 3;
  const long long bb = blockIdx.x / g.tiles;
  const int tile = static_cast<int>(blockIdx.x - bb * g.tiles);
  const long long t0 = static_cast<long long>(tile) * L::kM;
  const long long rows_b = min(static_cast<long long>(g.a_rows), g.M - bb * g.a_rows);
  const int n0 = blockIdx.y * L::kN;
  const int half = (g.taps / 2) * g.dil;           // the window's halo rows a side
  const long long tw0 = t0 - half;                  // time of window row 0
  const int phases = g.a1 ? 2 : 1;
  const int ldw = g.ldw;

  // shared memory: the window, the raw rows' shifts, then the B ring, whose
  // stages past the first also hold a chunk's raw blocks until they are in
  // the window (so the first slice loads beside them); the epilogue's tile
  // over all of it
  E* wnd = reinterpret_cast<E*>(smem_gemm);
  int* shift = reinterpret_cast<int*>(wnd + g.win_rows * ldw);
  const int shift_n = g.stage == kStageElement ? 0 : g.raw_rows;
  E* ring = reinterpret_cast<E*>(shift + ((shift_n + 3) & ~3));
  const int planes = g.b_lo ? 2 : 1;
  const int plane = L::kBRows * ldw;
  E* raw = ring + planes * plane;

  const int C = g.C, nchunks = (C + g.cw - 1) / g.cw, taps = g.taps;

  // ---- staging of A: chunk ch's raw blocks
  auto issue_raw = [&](int ch) {
    if (g.stage == kStageElement) return;
    const int c0 = ch * g.cw;
    const int total = g.raw_rows * g.raw_blocks;
    for (int e = tid; e < total; e += L::kThreads) {
      const int r = e / g.raw_blocks, j = e - r * g.raw_blocks;
      // the elements this row needs: [i_lo, i_hi) along its contiguous axis,
      // from the storage index `base` on
      const void* src;
      long long base, i_lo, i_hi;
      bool live;
      if (g.stage == kStageTime) {
        const int ci = r / phases, q = r - ci * phases, c = c0 + ci;
        const long long lo = max(tw0, 0LL), hi = min(tw0 + g.win_rows, rows_b);
        src = q ? g.a1 : g.a;
        base = bb * g.a_sb + c * g.a_sk;
        // time t of this phase: t = phases i + q
        i_lo = phases == 1 ? lo : floor_div(lo - q + 1, 2);
        i_hi = phases == 1 ? hi : floor_div(hi - q + 1, 2);
        live = c < C && i_lo < i_hi;
      } else {
        const long long t = tw0 + r;
        live = t >= 0 && t < rows_b;
        src = g.a;
        base = bb * g.a_sb + t * g.a_st;
        i_lo = c0;
        i_hi = min(c0 + g.cw, C);
      }
      // block j of the row: from the 16-byte boundary at or below element i_lo
      const uintptr_t first = reinterpret_cast<uintptr_t>(src) + (base + i_lo) * L::kEs;
      const uintptr_t aligned = first & ~static_cast<uintptr_t>(15);
      const uintptr_t end = reinterpret_cast<uintptr_t>(src) + (base + i_hi) * L::kEs;
      if (j == 0)
        shift[r] = live ? static_cast<int>(static_cast<long long>(first - aligned) / L::kEs - i_lo)
                        : 0;
      const uintptr_t blk = aligned + 16 * static_cast<uintptr_t>(j);
      if (live && blk < end)
        ptx::cp_async16(raw + r * g.raw_ld + j * L::kV, reinterpret_cast<const void*>(blk), 16);
    }
  };

  // ---- the window of chunk ch: [t][c] rows, the prologue applied once
  auto fill_window = [&](int ch) {
    const int c0 = ch * g.cw;
    // 32 threads take 8 window rows x 4 channels (bf16: channel pairs), the
    // channels the k steps read
    constexpr int kCw = kBf ? 2 : 1;                 // channels a thread
    constexpr int kStep = kBf ? 16 : 8;              // k of an mma step
    const int groups = (min(g.cw, C - c0) + kStep - 1) / kStep * kStep / (4 * kCw);
    const int total = (g.win_rows / 8) * groups * 32;
    // grp / groups as a multiply-high (exact for grp * groups < 2^32)
    const uint32_t magic = 0xffffffffu / static_cast<uint32_t>(groups) + 1u;
    const int tw = static_cast<int>(tw0), rows = static_cast<int>(rows_b);
    // kIlp elements a thread at once, loads, snakes and stores apart: each
    // element's chain (load, sinf, IEEE division, rounding) is long, and
    // with 16 warps an SM one chain a thread leaves the issue slots idle
    constexpr int kIlp = 4;
    for (int e0 = tid; e0 < total; e0 += kIlp * L::kThreads) {
      float v[kIlp][kCw];
      int dst[kIlp], cs[kIlp];
#pragma unroll
      for (int k = 0; k < kIlp; ++k) {
        const int e = e0 + k * L::kThreads;
        const int grp = e >> 5, l = e & 31;
        const int rg = static_cast<int>(__umulhi(static_cast<uint32_t>(grp), magic));
        const int wr = 8 * rg + (l & 7);
        const int ci = kCw * (4 * (grp - rg * groups) + (l >> 3));
        const int t = tw + wr;
        const bool t_ok = e < total && t >= 0 && t < rows;
        dst[k] = e < total ? wr * ldw + ci : -1;
        cs[k] = c0 + ci;
#pragma unroll
        for (int u = 0; u < kCw; ++u) {
          const int c = c0 + ci + u;
          float x = 0.0f;
          if (t_ok && c < C) {
            if (g.stage == kStageElement) {
              x = a_elem<kBf>(g, bb, c, t);
            } else if (g.stage == kStageTime) {
              const int q = phases == 1 ? 0 : t & 1;
              const int i = phases == 1 ? t : t >> 1;
              const int r = (ci + u) * phases + q;
              x = load<kBf>(raw + r * g.raw_ld, i + shift[r]);
            } else {
              x = load<kBf>(raw + wr * g.raw_ld, c0 + ci + u + shift[wr]);
            }
          }
          v[k][u] = x;
        }
      }
      // the prologue on every value: the zeros outside [0, a_rows) and past
      // C stay zero (snake(0) = 0 for any alpha; the index is clamped)
#pragma unroll
      for (int k = 0; k < kIlp; ++k)
#pragma unroll
        for (int u = 0; u < kCw; ++u) v[k][u] = prologue<kBf>(g, v[k][u], min(cs[k] + u, C - 1));
#pragma unroll
      for (int k = 0; k < kIlp; ++k) {
        if (dst[k] < 0) continue;
        if constexpr (kBf)
          *reinterpret_cast<uint32_t*>(wnd + dst[k]) = ptx::bf16x2_rn(v[k][0], v[k][1]);
        else
          wnd[dst[k]] = v[k][0];
      }
    }
  };

  // ---- B: slice (chunk, tap) of step s (its cw channels) into ring stage k
  auto issue_b = [&](int s, int k) {
    const int ch = s / taps, tap = s - ch * taps, c0 = ch * g.cw;
    E* stg = ring + k * planes * plane;
    const int blocks = g.cw / L::kV;  // 16-byte blocks of a row
    const int total = planes * L::kN * blocks;
    for (int e = tid; e < total; e += L::kThreads) {
      const int p = e / (L::kN * blocks), rest = e - p * (L::kN * blocks);
      const int n = rest / blocks, j = rest - n * blocks;
      const int gn = n0 + n, c = c0 + j * L::kV;
      const void* src = p ? static_cast<const void*>(g.b_lo) : g.b;
      const long long off = (static_cast<long long>(tap) * g.N + gn) * g.ldb + c;
      E* dst = stg + p * plane + n * ldw + j * L::kV;
      const int valid = gn < g.N ? max(0, min(L::kV, C - c)) : 0;  // zero past N and C
      if (g.b_vec && (valid == L::kV || valid == 0)) {
        ptx::cp_async16(dst, valid ? static_cast<const char*>(src) + off * L::kEs : src,
                        valid * L::kEs);
      } else {
#pragma unroll
        for (int i = 0; i < L::kV; ++i) {
          if constexpr (kBf)
            dst[i] = i < valid ? static_cast<const bf16*>(src)[off + i] : __float2bfloat16_rn(0.0f);
          else
            dst[i] = i < valid ? static_cast<const float*>(src)[off + i] : 0.0f;
        }
      }
    }
  };

  // ---- the products
  const int r0 = wm * L::kMT * 16, nw0 = wn * kNT * 8;  // the warp's first row and column
  const bool warp_live = n0 + nw0 < g.N;
  float sum[L::kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < L::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[mt][nt][i] = 0.0f;
  // ldmatrix row addresses: lanes 8q .. 8q + 7 give the rows of matrix q
  const int q = lane >> 3;
  const int a_row = (q & 1) * 8 + (lane & 7), a_col = (q >> 1) * (kBf ? 8 : 4);
  const int b_row = (q >> 1) * 8 + (lane & 7), b_col = (q & 1) * (kBf ? 8 : 4);

  // step s = (chunk, tap) from ring stage k: the chunk's channels in K steps
  // of 32 (fp32: each into a fresh accumulator, added to the sum)
  auto compute = [&](int s, int k) {
    const int ch = s / taps, tap = s - ch * taps;
    const int kn = min(g.cw, C - ch * g.cw);   // channels with data
    const E* wa = wnd + (r0 + tap * g.dil + a_row) * ldw + a_col;
    const E* wb = ring + k * planes * plane + (nw0 + b_row) * ldw + b_col;
    if constexpr (kBf) {
      for (int k0 = 0; k0 < kn; k0 += 16) {
        uint32_t af[L::kMT][4];
#pragma unroll
        for (int mt = 0; mt < L::kMT; ++mt) ptx::ldmatrix_x4(af[mt], wa + mt * 16 * ldw + k0);
#pragma unroll
        for (int np = 0; np < (kNT + 1) / 2; ++np) {
          uint32_t br[4];
          ptx::ldmatrix_x4(br, wb + np * 16 * ldw + k0);
          const uint32_t b0[2] = {br[0], br[1]}, b1[2] = {br[2], br[3]};
#pragma unroll
          for (int mt = 0; mt < L::kMT; ++mt) {
            ptx::mma_bf16(sum[mt][2 * np], af[mt], b0);
            if (2 * np + 1 < kNT) ptx::mma_bf16(sum[mt][2 * np + 1], af[mt], b1);
          }
        }
      }
    } else {
      for (int ks = 0; ks < kn; ks += L::kKs) {
        float acc[L::kMT][kNT][4];
#pragma unroll
        for (int mt = 0; mt < L::kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
        const int kend = min(ks + L::kKs, kn);
        for (int k0 = ks; k0 < kend; k0 += 8) {
          uint32_t ah[L::kMT][4], al[L::kMT][4];
#pragma unroll
          for (int mt = 0; mt < L::kMT; ++mt) {
            uint32_t r[4];
            ptx::ldmatrix_x4(r, wa + mt * 16 * ldw + k0);
            const float x[4] = {__uint_as_float(r[0]), __uint_as_float(r[1]),
                                __uint_as_float(r[2]), __uint_as_float(r[3])};
            split(x, ah[mt], al[mt]);
          }
#pragma unroll
          for (int np = 0; np < (kNT + 1) / 2; ++np) {
            uint32_t bh[4], bl[4];
            ptx::ldmatrix_x4(bh, wb + np * 16 * ldw + k0);
            if (planes == 2) {  // a prepared split: TF32 hi and lo as they are
              ptx::ldmatrix_x4(bl, wb + plane + np * 16 * ldw + k0);
            } else {
              const float y[4] = {__uint_as_float(bh[0]), __uint_as_float(bh[1]),
                                  __uint_as_float(bh[2]), __uint_as_float(bh[3])};
              split(y, bh, bl);
            }
            const uint32_t bh0[2] = {bh[0], bh[1]}, bl0[2] = {bl[0], bl[1]};
            const uint32_t bh1[2] = {bh[2], bh[3]}, bl1[2] = {bl[2], bl[3]};
#pragma unroll
            for (int mt = 0; mt < L::kMT; ++mt) {
              mma3(acc[mt][2 * np], ah[mt], al[mt], bh0, bl0);
              if (2 * np + 1 < kNT) mma3(acc[mt][2 * np + 1], ah[mt], al[mt], bh1, bl1);
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < L::kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) sum[mt][nt][i] += acc[mt][nt][i];
      }
    }
  };

  // ---- the pipeline, a chunk of cw channels at a time (one chunk where C
  // fits): its raw blocks into the ring's memory, the window filled from
  // them, then a step a tap, B's slices through the ring two steps ahead
  for (int ch = 0; ch < nchunks; ++ch) {
    const int s0 = ch * taps;
    issue_raw(ch);
    issue_b(s0, 0);
    ptx::cp_async_commit();
    ptx::cp_async_wait<0>();
    __syncthreads();  // the raw blocks and the first slice have landed
    fill_window(ch);
    __syncthreads();  // the window is whole; the raw blocks are spent
    if (g.stages > 1 && taps > 1) issue_b(s0 + 1, 1);
    ptx::cp_async_commit();
    for (int tap = 0; tap < taps; ++tap) {
      ptx::cp_async_wait<1>();
      __syncthreads();  // slice tap has landed; every warp is done with tap - 1
      if (tap + 2 < taps) issue_b(s0 + tap + 2, (tap + 2) % g.stages);
      ptx::cp_async_commit();
      if (warp_live) compute(s0 + tap, tap % g.stages);
    }
    ptx::cp_async_wait<0>();
    __syncthreads();  // the window and the ring are free for the next chunk
  }

  // tile row r as the output's (batch row, time): the tile's first row
  // divided once, then stepped (a tile spans more than one output batch
  // row only where o_rows < 128)
  const long long m0 = bb * g.a_rows + t0;
  const long long bo0 = m0 / g.o_rows, to0 = m0 - bo0 * g.o_rows;
  auto row_of = [&](int r, long long& bo, long long& to) {
    bo = bo0;
    to = to0 + r;
    while (to >= g.o_rows) {
      to -= g.o_rows;
      ++bo;
    }
  };
  // residual storage index of (batch row, time, column) and its array
  auto res_at = [&](long long bo, long long to, int gn, const void*& arr) -> long long {
    arr = g.res;
    if (g.res1) {
      arr = to & 1 ? g.res1 : g.res;
      return bo * g.r_sb + (to >> 1) * g.r_st + gn * g.r_sn;
    }
    return bo * g.r_sb + to * g.r_st + gn * g.r_sn;
  };
  // the value of output column gn from the sum: bias and activation
  auto epilogue = [&](float x, int gn) {
    if (g.bias) x += g.bias[gn];
    if (g.act == 1)
      x = l3ac::snake(x, g.alpha[gn]);
    else if (g.act == 2)
      x = l3ac::gelu(x);
    else if (g.act == 3)
      x = tanhf(x);
    return x;
  };
  const int rows = static_cast<int>(min(static_cast<long long>(L::kM), rows_b - t0));

  // ---- the epilogue: bias and activation into the staged tile, then the
  // stores with the residual in 16-byte pieces along the contiguous axis
  float* os = reinterpret_cast<float*>(smem_gemm);
  const int ldo = g.out_cf ? L::kLdoCf : L::kLdoCl;
  if (warp_live) {
#pragma unroll
    for (int mt = 0; mt < L::kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 16 * mt + gq + 8 * h;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          float v[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = nw0 + 8 * nt + 2 * tq + j, gn = n0 + n;
            const float x = sum[mt][nt][2 * h + j];
            v[j] = gn < g.N ? epilogue(x, gn) : x;
          }
          const int n = nw0 + 8 * nt + 2 * tq;
          if (g.out_cf) {
            os[n * ldo + r] = v[0];
            os[(n + 1) * ldo + r] = v[1];
          } else {
            *reinterpret_cast<float2*>(os + r * ldo + n) = make_float2(v[0], v[1]);
          }
        }
      }
  }
  __syncthreads();

  const int P = g.o_bf ? 8 : 4;  // elements a 16-byte piece of the output
  const int cols = min(L::kN, g.N - n0);
  // pieces of P elements along the contiguous axis: t (cf) or n (cl)
  const int run = g.out_cf ? L::kM : L::kN, other = g.out_cf ? cols : rows;
  const int pieces = run / P;
  const uint32_t pmagic = 0xffffffffu / static_cast<uint32_t>(pieces) + 1u;  // e / pieces
  for (int e = tid; e < other * pieces; e += L::kThreads) {
    const int o = static_cast<int>(__umulhi(static_cast<uint32_t>(e), pmagic)), p = e - o * pieces;
    const int k0 = p * P;  // first t (cf) or n (cl) of the piece
    const int lim = g.out_cf ? rows : cols;
    if (k0 >= lim) continue;
    const int r_first = g.out_cf ? k0 : o, n_first = g.out_cf ? o : k0;
    long long bo, to;
    row_of(r_first, bo, to);
    const long long oi = bo * g.o_sb + to * g.o_st + (n0 + n_first) * g.o_sn;
    const float* src = os + (g.out_cf ? n_first * ldo + r_first : r_first * ldo + n_first);
    if (g.o_vec && k0 + P <= lim) {
      float v[8];  // the piece from the staged tile: 16-byte aligned (ldo and P multiples of 4)
      const float4 v0 = *reinterpret_cast<const float4*>(src);
      const float4 v1 = P == 8 ? *reinterpret_cast<const float4*>(src + 4) : make_float4(0, 0, 0, 0);
      v[0] = v0.x;
      v[1] = v0.y;
      v[2] = v0.z;
      v[3] = v0.w;
      v[4] = v1.x;
      v[5] = v1.y;
      v[6] = v1.z;
      v[7] = v1.w;
      if (g.res) {
        if (g.r_vec) {  // one 16-byte piece of the residual's dtype (= the output's)
          const void* arr;
          const long long ri = res_at(bo, to, n0 + n_first, arr);
          float r[8];
          if (g.res_bf) {
            const uint4 w = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(arr) + ri);
            const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              r[2 * i] = __uint_as_float(u[i] << 16);
              r[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
            }
          } else {
            const float4 w = *reinterpret_cast<const float4*>(static_cast<const float*>(arr) + ri);
            r[0] = w.x;
            r[1] = w.y;
            r[2] = w.z;
            r[3] = w.w;
            r[4] = r[5] = r[6] = r[7] = 0.0f;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float x = v[i];
            if (g.round_mid) x = l3ac::round_bf16(x);
            v[i] = x + r[i];
          }
        } else {
          for (int i = 0; i < P; ++i) {
            const void* arr;
            long long bi = bo, ti = to;
            if (g.out_cf) row_of(r_first + i, bi, ti);
            const long long ri = res_at(bi, ti, n0 + n_first + (g.out_cf ? 0 : i), arr);
            float x = v[i];
            if (g.round_mid) x = l3ac::round_bf16(x);
            v[i] = x + ld(arr, ri, g.res_bf);
          }
        }
      }
      if (g.o_bf) {
        uint4 w;
        w.x = ptx::bf16x2_rn(v[0], v[1]);
        w.y = ptx::bf16x2_rn(v[2], v[3]);
        w.z = ptx::bf16x2_rn(v[4], v[5]);
        w.w = ptx::bf16x2_rn(v[6], v[7]);
        *reinterpret_cast<uint4*>(static_cast<bf16*>(g.out) + oi) = w;
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(g.out) + oi) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
      for (int i = 0; i < P && k0 + i < lim; ++i) {
        const int r = g.out_cf ? k0 + i : o, n = g.out_cf ? o : k0 + i;
        long long bi, ti;
        row_of(r, bi, ti);
        float v = src[i];  // t (cf) or n (cl) runs along the staged row
        if (g.res) {
          const void* arr;
          const long long ri = res_at(bi, ti, n0 + n, arr);
          if (g.round_mid) v = l3ac::round_bf16(v);
          v += ld(arr, ri, g.res_bf);
        }
        st(g.out, bi * g.o_sb + ti * g.o_st + (n0 + n) * g.o_sn, v, g.o_bf);
      }
    }
  }
}

bool aligned_to(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <bool kBf, int kNT>
cudaError_t launch_as(GemmArgs g, cudaStream_t stream) {
  using L = Tile<kBf, kNT>;
  const int es = L::kEs;
  g.tiles = l3ac::ceil_div(g.a_rows, L::kM);
  g.win_rows = (L::kM + (g.taps - 1) * g.dil + 7) / 8 * 8;
  g.stages = g.taps < L::kStages ? g.taps : L::kStages;
  const int phases = g.a1 ? 2 : 1, planes = g.b_lo ? 2 : 1;
  // the shared memory of a chunk width cw: the window, the shifts, the B
  // ring's first stage, then the larger of the raw blocks and the rest of
  // the ring; the epilogue's tile over them
  auto layout = [&](int cw) -> size_t {
    g.cw = cw;
    g.ldw = cw + L::kPad;
    if (g.stage == kStageTime) {
      const int elems = phases == 1 ? g.win_rows : g.win_rows / 2 + 1;  // along the row
      g.raw_blocks = (elems * es + 15) / 16 + 1;
      g.raw_rows = cw * phases;
      g.raw_ld = g.raw_blocks * L::kV;
      while (g.raw_ld % 32 != 8) g.raw_ld += L::kV;  // the fill's 8 rows x 4 channels
    } else if (g.stage == kStageChannel) {
      g.raw_blocks = cw * es / 16 + 1;
      g.raw_rows = g.win_rows;
      g.raw_ld = g.raw_blocks * L::kV;
      while (g.raw_ld % 32 != (kBf ? 8 : 4)) g.raw_ld += L::kV;
    } else {
      g.raw_blocks = g.raw_rows = g.raw_ld = 0;
    }
    const size_t raw = static_cast<size_t>(es) * g.raw_rows * g.raw_ld;
    const size_t stage = static_cast<size_t>(es) * planes * L::kBRows * g.ldw;
    const size_t rest = (g.stages - 1) * stage;  // the ring past its first stage
    const size_t main = static_cast<size_t>(es) * g.win_rows * g.ldw +
                        sizeof(int) * ((g.raw_rows + 3) / 4 * 4) + stage +
                        (raw > rest ? raw : rest);
    const size_t epi = sizeof(float) * (g.out_cf ? static_cast<size_t>(L::kN) * L::kLdoCf
                                                 : static_cast<size_t>(L::kM) * L::kLdoCl);
    return main > epi ? main : epi;
  };
  // the widest chunk (at most 256 channels) within the block's budget
  int cw = (g.C + 31) / 32 * 32;
  if (cw > 256) cw = 256;
  size_t smem = layout(cw);
  while (smem > L::kBudget && cw > 32) smem = layout(cw -= 32);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;  // a dilation past the window's budget
  auto kernel = window_gemm_kernel<kBf, kNT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long batches = (g.M + g.a_rows - 1) / g.a_rows;
  const long long blocks = batches * g.tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), l3ac::ceil_div(g.N, L::kN));
  kernel<<<grid, L::kThreads, smem, stream>>>(g);
  return cudaGetLastError();
}

template <bool kBf>
cudaError_t launch_dtype(const GemmArgs& g, cudaStream_t stream) {
  // the column tile sized to N: 16 (the output conv's N = 1), 32, 64, 96, or
  // tiles of 128
  if (g.N <= 16) return launch_as<kBf, 1>(g, stream);
  if (g.N <= 32) return launch_as<kBf, 2>(g, stream);
  if (g.N <= 64) return launch_as<kBf, 4>(g, stream);
  if (g.N <= 96) return launch_as<kBf, 6>(g, stream);
  return launch_as<kBf, 8>(g, stream);
}

}  // namespace

// The general routes' product (see GemmArgs); a_bf: A and B bf16; out, res
// of their own dtypes. stage: the wrapper's choice from A's strides
// (ops/kernels/conv_unit.py:gemm_staging). Returns a CUDA error code.
extern "C" int l3ac_general_gemm(const void* a, const void* a1, long long a_sb, long long a_st,
                                 long long a_sk, int a_rows, int C, int taps, int dil, int a_bf,
                                 const float* pro, int stage, const void* b, const float* b_lo,
                                 int ldb, const float* bias, const float* alpha, int act,
                                 const void* res, const void* res1, long long r_sb,
                                 long long r_st, long long r_sn, int res_bf, int round_mid,
                                 void* out, long long o_sb, long long o_st, long long o_sn,
                                 int o_rows, int o_bf, long long M, int N, void* stream) {
  if (M < 1 || N < 1 || C < 1 || a_rows < 1 || o_rows < 1 || dil < 1 || ldb < C ||
      (taps != 1 && taps != 7) || (a_bf && b_lo) || (act == 1 && !alpha) || (act < 0 || act > 3) ||
      (stage == kStageTime && a_st != 1) ||
      (stage == kStageChannel && (a_sk != 1 || a1 != nullptr)) || stage < 0 || stage > 2 ||
      l3ac::ceil_div(N, 16) > 65535)
    return cudaErrorInvalidValue;
  GemmArgs g{};
  g.a = a;
  g.a1 = a1;
  g.a_sb = a_sb;
  g.a_st = a_st;
  g.a_sk = a_sk;
  g.a_rows = a_rows;
  g.C = C;
  g.taps = taps;
  g.dil = dil;
  g.a_bf = a_bf;
  g.pro = pro;
  g.stage = stage;
  g.b = b;
  g.b_lo = b_lo;
  g.ldb = ldb;
  g.bias = bias;
  g.alpha = alpha;
  g.act = act;
  g.res = res;
  g.res1 = res1;
  g.r_sb = r_sb;
  g.r_st = r_st;
  g.r_sn = r_sn;
  g.res_bf = res_bf;
  g.round_mid = round_mid;
  g.out = out;
  g.o_sb = o_sb;
  g.o_st = o_st;
  g.o_sn = o_sn;
  g.o_rows = o_rows;
  g.o_bf = o_bf;
  g.M = M;
  g.N = N;
  const int es = a_bf ? 2 : 4, oes = o_bf ? 2 : 4, P = 16 / oes;
  g.b_vec = aligned_to(b, 16) && (b_lo == nullptr || aligned_to(b_lo, 16)) && (ldb * es) % 16 == 0;
  // the epilogue's tile: [n][t] where the output runs along t in A's rows
  g.out_cf = o_st == 1 && o_rows == a_rows;
  const long long along_o = g.out_cf ? o_sn : o_st;  // the stride between pieces' rows
  g.o_vec = aligned_to(out, 16) && (g.out_cf ? o_st == 1 : o_sn == 1) && o_sb % P == 0 &&
            along_o % P == 0;
  const long long along_r = g.out_cf ? r_sn : r_st;
  g.r_vec = res != nullptr && res1 == nullptr && res_bf == o_bf && aligned_to(res, 16) &&
            (g.out_cf ? r_st == 1 : r_sn == 1) && r_sb % P == 0 && along_r % P == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a_bf ? launch_dtype<true>(g, s) : launch_dtype<false>(g, s);
}
