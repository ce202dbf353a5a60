// Decoder up path on bf16 (B, C, T), designed for the H100: 1x1 conv Ci ->
// Co, linear upsample x s (align_corners=False edges), ChannelNorm over Co
// (eps 1e-8 inside the sqrt) and its affine, interleaved (B, Co, T s) or as s
// phase arrays (phase_split), with z never leaving registers.
//
// Replaces l3ac_tpu/ops/pallas/upsample.py:129 up_fused_ct (body _kernel_ct,
// :57-88) on bf16, rounding where that body does: the bf16 values multiplied
// with fp32 sums, the bias, the blend and the norm in fp32, one rounding of
// the output to bf16. The (B, T, C) input at stream shapes stays on the bf16
// instance of up_fused.cu (ops/kernels/up_fused.py:route_for).
//
// Bound on the H100: 2 Ci bytes read and 2 s Co written per input column;
// 2 Ci Co operations of the conv (a 28th of the bf16 rate's time at the 1kbps
// widths) and about 8 fp32 operations per output. Per 8 x 10 s 1kbps decode
// the two launches (96 -> 48 s3, 48 -> 24 s2 phase_split) move 102.5 + 123.0
// MB: 0.031 + 0.037 ms at 3.35 TB/s; their SIMT work is about half that. So
// every byte moves once, in 16-byte pieces, with the loads ahead of the
// compute, and the SIMT work stays short:
//   - Tiles: a persistent grid, a block per SM of up to 16 warps (as many as
//     the shared memory holds), walks (batch, warps x 14 columns) tiles.
//     Each warp computes its own window of two n8 column tiles and owns all
//     its columns but the first and last (the blend's neighbours): a
//     one-column overlap between windows. Three block barriers a tile: the
//     staged window, and around the writes of the block's output tile.
//   - x in bf16: the 16-byte aligned pieces that hold each row of the block
//     tile's window, one contiguous run a row (cp.async by all the block's
//     threads; T is odd at every 1kbps shape, so a row starts anywhere in
//     its first piece; zero past the tensor's ends), in a ring of two
//     windows: the next tile's in flight while this one computes. Each
//     warp realigns its own columns into rows of its own (byte permutes;
//     columns outside [0, T) take the edge column, the align_corners=False
//     rule), so that ldmatrix.trans gives the B fragments with no
//     conversion.
//   - W resident in bf16, in the A-fragment order of mma.sync m16n8k16
//     (ops/kernels/up_fused.py:prepare_up, route buffer "stream_bf16"), one
//     16-byte load per fragment; K = Ci padded to 16, channels as M.
//   - z = W x + b stays in the accumulators: a warp holds all Co of its
//     columns. Each column's mean, centred sum of squares and cross sum with
//     the next column reduce across the 8 lanes that hold its channels (three
//     shuffles); the neighbours' z and statistics come by shuffles within the
//     quad. A phase blending columns a, b with taps w_a, w_b has the mean
//     w_a m_a + w_b m_b and the sum of squares w_a^2 D_a + w_b^2 D_b + 2 w_a
//     w_b C_ab, exact identities of the centred sums (as up_fused.cu).
//   - The only shared-memory round trip of the results is the block's
//     output tile, its rows placed at their destination's offset mod 16
//     bytes: a row's aligned middle goes out by one bulk copy
//     (cp.async.bulk, the copy engine reading the tile while the warps
//     compute the next one), its ends by element.
//   - The statistics' divisions by Co are multiplications by its reciprocal
//     and the standard deviation's reciprocal is rsqrtf (2 ulp): IEEE
//     division and square root per column and phase cost a quarter of the
//     48 -> 24 launch.
// What still holds it (tools/up_variants.py --bf16, PERF.md §6): 0.105 /
// 0.149 ms, 3.4 / 4.1x the bytes; x in and out alone take about half of
// that (the staged rows reach ~1.2 TB/s), the blend and the output tile's
// writes most of the rest; deeper x rings and two blocks per SM did not help.
#include "common.cuh"
#include "ptx.cuh"

namespace {

namespace ptx = l3ac::ptx;
using bf16 = __nv_bfloat16;

constexpr int kMaxWarps = 16;
constexpr int kBlocksPerSm = 1;  // two blocks of 8 warps measured 15 % slower (PERF.md §6)
constexpr int kMaxScale = 16;
constexpr int kMaxC = 128;
constexpr float kNormEps = 1e-8f;
constexpr size_t kSmemMax = 227 * 1024;

struct Args {
  const bf16* x;    // (B, Ci, T) contiguous, at any element offset
  const uint4* pk;  // the "stream_bf16" buffer: W fragments, then b, norm_w, norm_b (bf16, Mp each)
  bf16* out;        // (B, Co, T s), or (s, B, Co, T) with split
  int B, Ci, Co, T, s, norm, split;
  int ks;           // k16 steps: Ci rounded up to 16, over 16
  int row;          // elements of a warp's realigned row: its window and one 16-byte
                    // piece, an odd number of pieces (conflict-free ldmatrix)
  int row_b;        // elements of a row of the block's staged window
  int out_row;      // elements of an output-tile row
  int ot_bytes;     // bytes of the block's output tile
  int region;       // bytes of a warp's realigned window
  float taps[kMaxScale][3];  // per phase: w_prev, w_cur, w_next
};

// n8 column tiles of a warp's window: 16 columns, 14 owned (four cost half
// the warps an SM holds in registers)
constexpr int kTiles = 2;
constexpr int kStages = 2;  // x windows per block: this tile's and the next one in flight

// kS: the scale where it is fixed at compile time (2 and 3, the 1kbps up
// paths': the phase loop unrolled, the taps in registers), else 0
template <int kMT, int kS>
__global__ void __launch_bounds__(32 * kMaxWarps, kBlocksPerSm) up_bf16_kernel(const Args a) {
  constexpr int R = kTiles;
  constexpr int NW = 8 * R;    // window columns: input columns t0 - 1 .. t0 + NW - 2
  constexpr int OWN = NW - 2;  // columns a tile stores
  constexpr int kMp = 16 * kMT;
  extern __shared__ __align__(16) uint4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int warps = blockDim.x >> 5;
  const int Ci = a.Ci, Co = a.Co, T = a.T, s = kS > 0 ? kS : a.s, KS = a.ks;
  const int nfrag = kMT * KS * 32;
  uint4* wf = smem;                                          // W's A fragments
  float* vec = reinterpret_cast<float*>(smem + nfrag);      // b, norm_w, norm_b (kMp each)
  float* taps = vec + 3 * kMp;                               // s x 3
  unsigned char* base = reinterpret_cast<unsigned char*>(smem + nfrag + (3 * kMp + 3 * kMaxScale) / 4);
  bf16* ot = reinterpret_cast<bf16*>(base);  // the block's output tile
  // the block's ring of kStages x windows, (Ci, row_b) each, as they land
  bf16* ring = reinterpret_cast<bf16*>(base + a.ot_bytes);
  const int stage_elems = Ci * a.row_b;
  // this warp's realigned window, (Kp, row)
  bf16* xs = ring + kStages * stage_elems + static_cast<size_t>(warp) * (a.region / 2);
  const int Kp = 16 * KS;

  // x's 16-byte aligned base and the flat index of x[0] from it
  const int mis_x = static_cast<int>((reinterpret_cast<uintptr_t>(a.x) >> 1) & 7);
  const bf16* xb = a.x - mis_x;
  const long long n_all = mis_x + static_cast<long long>(a.B) * Ci * T;
  const int nb = warps * OWN;          // columns of a block tile: warp w owns OWN from w OWN
  const int tpr = (T + nb - 1) / nb;   // block tiles per batch row
  const int tiles = a.B * tpr;
  const int pieces = a.row_b / 8;

  // the block tile's x columns [tb - 1, tb + nb + 1) of every channel into
  // ring buffer i, by all its threads: row c at c row_b, its first column at
  // element (flat index of it) mod 8, so that each row is one contiguous run
  // of 16-byte pieces; one cp.async group per thread and call
  auto stage = [&](int tile, int i) {
    if (tile < tiles) {
      const int b = tile / tpr, ws = (tile - b * tpr) * nb - 1;
      bf16* dst = ring + i * stage_elems;
      for (int e = threadIdx.x; e < Ci * pieces; e += blockDim.x) {
        const int c = e / pieces, k = e - c * pieces;
        const long long f = mis_x + (static_cast<long long>(b) * Ci + c) * T + ws;
        const long long start = (f & ~7LL) + 8 * k, left = n_all - start;
        const int n = start < 0 || left <= 0 ? 0 : (left < 8 ? static_cast<int>(left) : 8);
        ptx::cp_async16(dst + c * a.row_b + 8 * k, n > 0 ? xb + start : xb, 2 * n);
      }
    }
    ptx::cp_async_commit();
  };

  int tile = blockIdx.x;
  for (int i = 0; i + 1 < kStages; ++i) stage(tile + i * gridDim.x, i);
  for (int e = threadIdx.x; e < nfrag; e += blockDim.x) wf[e] = a.pk[e];
  {
    const bf16* v16 = reinterpret_cast<const bf16*>(a.pk + nfrag);
    for (int e = threadIdx.x; e < 3 * kMp; e += blockDim.x) vec[e] = __bfloat162float(v16[e]);
  }
  if (threadIdx.x == 0) {  // constant indices: the parameter array is never indexed at run time
#pragma unroll
    for (int e = 0; e < kMaxScale * 3; ++e) taps[e] = a.taps[e / 3][e % 3];
  }
  for (int e = lane; e < (Kp - Ci) * a.row; e += 32)  // the K padding rows, zero
    xs[Ci * a.row + e] = __float2bfloat16_rn(0.0f);
  __syncthreads();
  const float* bias = vec;
  const float* nw = vec + kMp;
  const float* nbv = vec + 2 * kMp;
  const bool norm = a.norm != 0;
  const float inv_co = 1.0f / Co;
  const int q8 = lane >> 3, r8 = lane & 7;
  const int phase_step = static_cast<int>((static_cast<long long>(a.B) * Co * T) & 7);
  float tap[kS > 0 ? kS : 1][3];  // a fixed scale's taps in registers
#pragma unroll
  for (int p = 0; p < (kS > 0 ? kS : 1); ++p)
#pragma unroll
    for (int e = 0; e < 3; ++e) tap[p][e] = taps[3 * p + e];

  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const int b = tile / tpr, tb = (tile - b * tpr) * nb;  // the block tile's first column
    const int t0 = tb + warp * OWN, ws = t0 - 1;           // this warp's
    const int own = T - t0 < OWN ? T - t0 : OWN;           // columns it stores (none: <= 0)
    const int own_b = T - tb < nb ? T - tb : nb;           // the block's
    const long long Ts = static_cast<long long>(T) * s;
    auto row_flat = [&](int p, int ch) {  // flat index of the row's first output of the tile
      return a.split ? ((static_cast<long long>(p) * a.B + b) * Co + ch) * T + tb
                     : (static_cast<long long>(b) * Co + ch) * Ts + static_cast<long long>(tb) * s;
    };
    const bf16* st = ring + (it % kStages) * stage_elems;
    stage(tile + (kStages - 1) * gridDim.x, (it + kStages - 1) % kStages);  // ahead
    ptx::cp_async_wait<kStages - 1>();  // this thread's pieces of this tile have landed
    __syncthreads();                    // and every thread's
    if (own > 0) {  // warp-uniform
      // realign this warp's window: xs[c][j] = x[b, c, ws + j], from the
      // block's row c at its offset, by byte permutes
      for (int e = lane; e < Ci * R; e += 32) {
        const int c = e / R, m = e - c * R;
        const long long f = mis_x + (static_cast<long long>(b) * Ci + c) * T + tb - 1;
        const int idx = static_cast<int>(f & 7) + warp * OWN + 8 * m;
        const uint32_t* w = reinterpret_cast<const uint32_t*>(st + c * a.row_b) + (idx >> 1);
        const uint32_t sel = (idx & 1) ? 0x5432u : 0x3210u;
        const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3], w4 = w[4];
        *reinterpret_cast<uint4*>(xs + c * a.row + 8 * m) =
            make_uint4(__byte_perm(w0, w1, sel), __byte_perm(w1, w2, sel), __byte_perm(w2, w3, sel),
                       __byte_perm(w3, w4, sel));
      }
      __syncwarp();
      if (ws < 0 || ws + NW > T) {  // warp-uniform: the edge column outside [0, T)
        for (int e = lane; e < Ci * NW; e += 32) {
          const int c = e / NW, j = e - c * NW, tt = ws + j;
          if (tt < 0 || tt >= T) xs[c * a.row + j] = xs[c * a.row + (tt < 0 ? 0 : T - 1) - ws];
        }
      }
    }
    __syncwarp();

    // z = W x + b: channels as M (W's fragments), columns as N (ldmatrix.trans).
    // A warp past the row's end computes on stale rows and stores nothing.
    float z[R][kMT][4];
#pragma unroll
    for (int u = 0; u < R; ++u)
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[u][mt][e] = 0.0f;
#pragma unroll 2
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t bfr[R][2];
#pragma unroll
      for (int up = 0; up < R / 2; ++up) {
        uint32_t r[4];
        ptx::ldmatrix_x4_trans(r, xs + (16 * ks + (q8 & 1) * 8 + r8) * a.row + 16 * up +
                                      (q8 >> 1) * 8);
        bfr[2 * up][0] = r[0], bfr[2 * up][1] = r[1], bfr[2 * up + 1][0] = r[2],
        bfr[2 * up + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const uint4 w = wf[(mt * KS + ks) * 32 + lane];
        const uint32_t af[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int u = 0; u < R; ++u) ptx::mma_bf16(z[u][mt], af, bfr[u]);
      }
    }

    // z[u][mt][e]: channel 16 mt + g + 8 (e >> 1), window column 8 u + 2 t4 + (e & 1)
    bool ok[kMT][2];
    float zb[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ch = 16 * mt + g + 8 * h;
        ok[mt][h] = ch < Co;
        zb[mt][h] = bias[ch];
      }
#pragma unroll
    for (int u = 0; u < R; ++u)
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[u][mt][e] += zb[mt][e >> 1];

    // lanes of this quad's neighbours: the next column pair (t4 + 1, or
    // lane t4 = 0 of the next n8 tile) and the previous one
    const int nxt = (lane & ~3) | ((t4 + 1) & 3), prv = (lane & ~3) | ((t4 + 3) & 3);
    auto from_next = [&](const float* v, int u) {  // the value of lane nxt for tile u
      const float send = t4 == 0 ? v[u + 1 < R ? u + 1 : u] : v[u];
      return __shfl_sync(0xffffffffu, send, nxt);
    };
    auto from_prev = [&](const float* v, int u) {
      const float send = t4 == 3 ? v[u > 0 ? u - 1 : 0] : v[u];
      return __shfl_sync(0xffffffffu, send, prv);
    };
    auto sum8 = [](float v) {  // over the 8 lanes of one t4: a column's channels
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      return v + __shfl_xor_sync(0xffffffffu, v, 16);
    };

    float m0[R], m1[R], mn[R], d0[R], d1[R], x01[R], x1n[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) s0 += z[u][mt][0] + z[u][mt][2], s1 += z[u][mt][1] + z[u][mt][3];
      m0[u] = sum8(s0) * inv_co;
      m1[u] = sum8(s1) * inv_co;
    }
    // z of the column after this lane's pair and before it, per channel
    float zn[R][kMT][2], zp[R][kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float c0[R], c1[R];
#pragma unroll
        for (int u = 0; u < R; ++u) c0[u] = z[u][mt][2 * h], c1[u] = z[u][mt][2 * h + 1];
#pragma unroll
        for (int u = 0; u < R; ++u) {
          zn[u][mt][h] = from_next(c0, u);
          zp[u][mt][h] = from_prev(c1, u);
        }
      }
#pragma unroll
    for (int u = 0; u < R; ++u) mn[u] = from_next(m0, u);
#pragma unroll
    for (int u = 0; u < R; ++u) {
      float a0 = 0.0f, a1 = 0.0f, c01 = 0.0f, c1n = 0.0f;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float u0 = ok[mt][h] ? z[u][mt][2 * h] - m0[u] : 0.0f;
          const float u1 = ok[mt][h] ? z[u][mt][2 * h + 1] - m1[u] : 0.0f;
          a0 = fmaf(u0, u0, a0);
          a1 = fmaf(u1, u1, a1);
          c01 = fmaf(u0, u1, c01);
          c1n = fmaf(u1, zn[u][mt][h] - mn[u], c1n);
        }
      d0[u] = sum8(a0);
      d1[u] = sum8(a1);
      x01[u] = sum8(c01);
      x1n[u] = sum8(c1n);
    }

    // the output tile is free once this warp's copies of the last tile have
    // read it (every warp waits for its own, then the barrier)
    if (lane == 0) ptx::bulk_wait_read<0>();
    __syncthreads();
    // the output tile: rows (channel) or (phase, channel), each at its
    // destination's offset mod 8 elements; this warp's columns from warp OWN.
    // rb: the tile row of each of this lane's channels, its offset in ot at
    // phase 0 (row ch, or (0, ch) with split); with split the offset mod 8
    // moves by phase_step from one phase's row to the next
    int rb[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ch = 16 * mt + g + 8 * h < Co ? 16 * mt + g + 8 * h : 0;
        rb[mt][h] = ch * a.out_row + static_cast<int>(row_flat(0, ch) & 7);
      }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const float mp = from_prev(m1, u), dp = from_prev(d1, u), xp = from_prev(x1n, u);
      const float dn = from_next(d0, u);
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int wc_col = 8 * u + 2 * t4 + cc;  // window column; owned: 1 .. NW - 2
        const int oc = wc_col - 1, occ = warp * OWN + oc;  // its column in the block tile
        if (wc_col < 1 || wc_col > NW - 2 || oc >= own) continue;
        const float mc = cc ? m1[u] : m0[u], dc = cc ? d1[u] : d0[u];
#pragma unroll
        for (int p = 0; p < (kS > 0 ? kS : s); ++p) {
          const float wp = kS > 0 ? tap[kS > 0 ? p : 0][0] : taps[3 * p];
          const float wcur = kS > 0 ? tap[kS > 0 ? p : 0][1] : taps[3 * p + 1];
          const float wx = kS > 0 ? tap[kS > 0 ? p : 0][2] : taps[3 * p + 2];
          // this phase's element of the tile rows: interleaved oc s + p; split
          // the row of phase p, its offset mod 8 moved by p phase_step
          const int shift = a.split ? p * Co * a.out_row + occ : occ * s + p;
          const int pmis = a.split ? p * phase_step : 0;
          const bool prev = wp != 0.0f;
          const float wo = prev ? wp : wx;
          // the other column's mean, sum of squares and cross sum with this one
          const float mo = prev ? (cc ? m0[u] : mp) : (cc ? mn[u] : m1[u]);
          const float dq = prev ? (cc ? d0[u] : dp) : (cc ? dn : d1[u]);
          const float xc = prev ? (cc ? x01[u] : xp) : (cc ? x1n[u] : x01[u]);
          float mu = 0.0f, rsd = 1.0f;
          if (norm) {
            const float qs = fmaf(wo * wo, dq, fmaf(wcur * wcur, dc, 2.0f * wo * wcur * xc));
            mu = fmaf(mc, wcur, mo * wo);
            rsd = rsqrtf(fmaf(fmaxf(qs, 0.0f), inv_co, kNormEps));
          }
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int ch = 16 * mt + g + 8 * h;
              if (!ok[mt][h]) continue;
              const float zc = z[u][mt][2 * h + cc];
              const float zo = prev ? (cc ? z[u][mt][2 * h] : zp[u][mt][h])
                                    : (cc ? zn[u][mt][h] : z[u][mt][2 * h + 1]);
              float y = fmaf(zc, wcur, zo * wo);
              if (norm) y = fmaf((y - mu) * rsd, nw[ch], nbv[ch]);
              const int m0r = rb[mt][h] & 7;  // the phase-0 row's offset mod 8 (out_row % 8 == 0)
              ot[rb[mt][h] - m0r + ((m0r + pmis) & 7) + shift] = __float2bfloat16_rn(y);
            }
        }
      }
    }
    ptx::fence_proxy_async();  // the tile's writes, before the bulk copies read them
    __syncthreads();

    // store the tile, a warp per row: the row's 16-byte aligned middle by one
    // bulk copy (the copy engine reads the tile while the next one computes),
    // its ends by element
    const int rows = a.split ? s * Co : Co, len = a.split ? own_b : own_b * s;
    for (int r = warp; r < rows; r += warps) {
      const int p = a.split ? r / Co : 0, ch = r - p * Co;
      const long long f = row_flat(p, ch);
      const int mis = static_cast<int>(f & 7);
      const int lo = (mis + 7) & ~7, hi = (mis + len) & ~7;  // the aligned middle [lo, hi)
      bf16* dst = a.out + (f - mis);
      const bf16* src = ot + r * a.out_row;
      if (lo < hi) {
        if (lane == 0) ptx::bulk_store(dst + lo, src + lo, 2 * (hi - lo));
        for (int k = mis + lane; k < lo; k += 32) dst[k] = src[k];
        for (int k = hi + lane; k < mis + len; k += 32) dst[k] = src[k];
      } else {
        for (int k = mis + lane; k < mis + len; k += 32) dst[k] = src[k];
      }
    }
    if (lane == 0) ptx::bulk_commit();
  }
  if (lane == 0) ptx::bulk_wait<0>();
}

// The shared memory of a block of `warps` warps: the weights, the output
// tile, then per warp its staged and realigned x rows; and the row lengths
// of Args.
struct Layout {
  int row, row_b, out_row, ot_bytes, region;
  size_t smem;
};

Layout layout(int Ci, int Co, int s, bool split, int warps) {
  const int kMT = (Co + 15) / 16, NW = 8 * kTiles, nb = warps * (NW - 2);
  const int Kp = (Ci + 15) / 16 * 16;
  Layout L;
  L.row = NW + 8;  // R even: an odd number of 16-byte pieces
  L.row_b = 8 * ((nb + 16) / 8);  // the block's nb + 2 columns from any offset in [0, 8)
  L.out_row = ((split ? nb : nb * s) + 7) / 8 * 8 + 8;
  L.ot_bytes = 2 * (split ? s * Co : Co) * L.out_row;
  L.region = 2 * Kp * L.row;
  L.smem = 16 * (static_cast<size_t>(kMT) * (Kp / 16) * 32) + 4 * (3 * 16 * kMT + 3 * kMaxScale) +
           L.ot_bytes + 2 * static_cast<size_t>(kStages) * Ci * L.row_b +
           static_cast<size_t>(warps) * L.region;
  return L;
}

template <int kMT, int kS>
cudaError_t launch(Args a, cudaStream_t stream) {
  // as many warps as the shared memory of kBlocksPerSm blocks holds, else
  // as many as one block's does
  auto most = [&](size_t budget) {
    int w = kMaxWarps;
    while (w > 1 && layout(a.Ci, a.Co, a.s, a.split != 0, w).smem > budget) --w;
    return w;
  };
  const size_t share = (kSmemMax + 1024) / kBlocksPerSm - 1024;  // 1 KB a block is the system's
  int warps = most(share);
  if (layout(a.Ci, a.Co, a.s, a.split != 0, warps).smem > share) warps = most(kSmemMax);
  const Layout L = layout(a.Ci, a.Co, a.s, a.split != 0, warps);
  if (L.smem > kSmemMax) return cudaErrorInvalidValue;
  a.row = L.row, a.row_b = L.row_b, a.out_row = L.out_row, a.ot_bytes = L.ot_bytes;
  a.region = L.region;
  const size_t smem = L.smem;
  auto kernel = up_bf16_kernel<kMT, kS>;
  // the attribute once, the occupancy and the SM count once per launch
  // shape: host calls of microseconds each
  static bool attr_set = false;
  static size_t occ_smem = 0;
  static int occ_warps = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaSuccess;
  if (!attr_set) {
    int dev = 0;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(kSmemMax))) != cudaSuccess ||
        (err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    attr_set = true;
  }
  if (occ_smem != smem || occ_warps != warps) {
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * warps, smem)) !=
        cudaSuccess)
      return err;
    occ_smem = smem, occ_warps = warps;
  }
  if (per_sm < 1) return cudaErrorInvalidValue;
  const int nb = warps * (8 * kTiles - 2);
  const long long tiles = static_cast<long long>(a.B) * ((a.T + nb - 1) / nb);
  const long long cap = static_cast<long long>(per_sm) * sms;
  const int grid = static_cast<int>(tiles < cap ? tiles : cap);
  kernel<<<grid, 32 * warps, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: bf16 (B, Ci, T) contiguous (any element offset); pk: the "stream_bf16"
// buffer of ops/kernels/up_fused.py:prepare_up (W zero-padded to Co
// rounded up to 16 by Ci rounded up to 16, in mma.sync m16n8k16 A-fragment
// order; then b, norm_w and norm_b, each zero-padded to the same Co, all
// bf16), 16-byte aligned; out: bf16 (B, Co, T s) or, with split, (s, B, Co,
// T), contiguous and 16-byte aligned. 1 <= Ci, Co <= 128, 1 <= s <= 16.
// Returns the CUDA error code (invalid value for a shape it does not take).
extern "C" int l3ac_up_fused_ct_bf16(const void* x, const void* pk, void* out, int norm, int B,
                                     int Ci, int Co, int T, int s, int split, void* stream) {
  if (B < 1 || Ci < 1 || Ci > kMaxC || Co < 1 || Co > kMaxC || T < 1 || s < 1 ||
      s > kMaxScale || reinterpret_cast<uintptr_t>(x) % 2 != 0 ||
      reinterpret_cast<uintptr_t>(pk) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      static_cast<long long>(B) * ((T + 5) / 6) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  Args a{};
  a.x = static_cast<const bf16*>(x);
  a.pk = static_cast<const uint4*>(pk);
  a.out = static_cast<bf16*>(out);
  a.B = B, a.Ci = Ci, a.Co = Co, a.T = T, a.s = s, a.norm = norm != 0, a.split = split != 0;
  a.ks = (Ci + 15) / 16;
  for (int p = 0; p < s; ++p) {  // ops/resample.py:phase_weights, in double
    const double d = (p + 0.5) / s - 0.5;
    const double wt = 1.0 + d;
    a.taps[p][0] = d >= 0.0 ? 0.0f : static_cast<float>(1.0 - wt);
    a.taps[p][1] = d >= 0.0 ? static_cast<float>(1.0 - d) : static_cast<float>(wt);
    a.taps[p][2] = d >= 0.0 ? static_cast<float>(d) : 0.0f;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((Co + 15) / 16) {
    case 1: return launch<1, 0>(a, st);
    case 2: return s == 2 ? launch<2, 2>(a, st) : s == 3 ? launch<2, 3>(a, st) : launch<2, 0>(a, st);
    case 3: return s == 2 ? launch<3, 2>(a, st) : s == 3 ? launch<3, 3>(a, st) : launch<3, 0>(a, st);
    case 4: return launch<4, 0>(a, st);
    case 5: return launch<5, 0>(a, st);
    case 6: return launch<6, 0>(a, st);
    case 7: return launch<7, 0>(a, st);
    case 8: return launch<8, 0>(a, st);
    default: return cudaErrorInvalidValue;
  }
}
