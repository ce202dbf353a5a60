// Decoder up path on bf16 (B, T, C), designed for the H100: TMA, wgmma and a
// persistent grid whose producer warp loads the next tile while the
// consumers normalize and store this one.
//   z = W x + b (1x1 conv Ci -> Co) -> linear upsample x s with torch's
//   align_corners=False edge rule -> ChannelNorm over Co (eps 1e-8 inside the
//   sqrt) -> affine; out (B, T s, Co), channels-last and interleaved.
//
// Replaces l3ac_tpu/ops/pallas/upsample.py:207 up_fused (body _kernel,
// :91-118) on bf16 where Ci % 8 == 0, Ci <= 1024 and Co a multiple of 32 up
// to 256 (ops/kernels/up_fused.py:route_for, route "wgmma"); other bf16
// (B, T, C) shapes run the bf16 instance of up_fused_tc.cu (route "tc").
// Rounds where upsample.py:_kernel does: z, the bias, the blend and the
// norm in fp32 from the bf16 values, one rounding at the store.
//
// Bound on the H100: 2 Ci Co bf16 operations per input row against 2 Ci
// bytes read and 2 s Co written, so bytes: 0.015 + 0.023 ms for the 1kbps
// pair at B = 8 ((8, 1779, 512) -> 256 s5, (8, 8895, 256) -> 96 s3).
//
// Design (the hopper-kernels guide's shape):
//   - Work items are 64-row tiles of one batch row, z rows t0 - 1 .. t0 + 62,
//     of which the 62 between the halo rows are stored; a persistent grid
//     walks them in order.
//   - A producer warp (after the two consumer warpgroups: a warpgroup starts
//     at a warp index that is a multiple of 4) issues TMA for each K step of
//     64 columns: the x tile (64 rows x 128 bytes, from a (Ci, T, B) map, so
//     rows before 0 and past T arrive as zeros) and the W tile (Co rows x
//     128 bytes), both in the 128-byte swizzle, into a ring of full / empty
//     mbarriers; it fills the ring with the next tile while the consumers
//     run this one's epilogue. W is streamed with x (L2-resident, 256 KB at
//     Ci 512 x Co 256); kept resident in shared memory at the 96-column stage
//     it was no faster (PERF.md §6).
//   - Two consumer warpgroups split Co: each runs wgmma m64nNk16 with both
//     operands from shared memory on its half of W's rows (N = Co / 2, in
//     chunks of 128 / 64 / 32 / 16), one accumulator across K.
//   - Epilogue, both warpgroups: z + b in the accumulators and into shared
//     memory (fp32); the halo row before t = 0 and the one past T - 1 take
//     the edge row's values (the edge rule, as up_fused_tc.cu's clamped loads
//     give it). The row statistics come from the accumulators: a row's
//     columns of one warpgroup lie in one quad of one warp, so two quad
//     shuffles and one exchange of the two warpgroups' partial sums through
//     shared memory give each row's mean m, then likewise its sum of squares
//     about the mean D and the cross sum C with the next row (read from
//     shared memory at the lane's own columns); the halo rows take the edge
//     row's statistics. Each (row, phase) blends two rows, so its mean is
//     w_a m_a + w_b m_b and its sum of squares w_a^2 D_a + w_b^2 D_b + 2 w_a
//     w_b C_a, exact identities of the centred sums (up_fused_tc.cu's
//     scheme), folded with the blend into three coefficients (w_c / sd,
//     w_o / sd, -mean / sd); then a warp per owned row writes each phase's
//     Co channels as two fmas and the affine's third, 8-byte pieces at the
//     interleaved address (a warp's store covers 256 contiguous bytes).
//     Measured slower and dropped (tools/up_variants.py --bf16, PERF.md
//     §6): the statistics from z in shared memory, a warp per pair of rows;
//     the rows staged in shared memory and sent out by bulk copies
//     (cp.async.bulk), a whole tile per copy or a row per copy from each
//     warp, which cost the staging writes the lane stores cost and, at Co =
//     96, the third block per SM.
//   - Blocks per SM: kSmallBlocks (three) at Co <= 128, with rings of two
//     stages, two at wider Co where a ring of two stages and z fit, else
//     one; the ring as deep as the share allows.
//   - The shared-memory attribute and the occupancy are queried once per
//     instantiation and ring depth.
#include <cuda.h>

#include <cstring>

#include "common.cuh"
#include "gemm_sm90.cuh"
#include "ptx.cuh"

namespace {

namespace ptx = l3ac::ptx;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                       // z rows per item: wgmma's M
constexpr int kOwn = kRows - 2;                 // rows an item stores
constexpr int kBK = 64;                         // K per stage: one 128-byte swizzle row
constexpr int kConsumers = 2;                   // warpgroups, Co / 2 columns each
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 32;  // the consumers, then the producer warp
constexpr int kProducer = kConsumerThreads;      // the producer's first thread
constexpr int kWarps = 4 * kConsumers;          // consumer warps
constexpr int kMaxScale = 16;
constexpr int kMaxStages = 8;
constexpr int kSmallBlocks = 3;                 // blocks per SM at Co <= 128
constexpr float kNormEps = 1e-8f;

struct Args {
  const bf16* bias;     // (Co)
  const bf16* norm_w;   // (Co) or null: no norm
  const bf16* norm_b;   // (Co) or null
  bf16* out;            // (B, T s, Co)
  int Ci, Co, T, s, B;
  int tiles, items;     // tiles per batch row, B tiles
  int stages;           // ring depth
  float taps[kMaxScale][3];  // per phase: w_prev, w_cur, w_next
};

// Geometry of Co = kCo.
template <int kCo>
struct Geo {
  static constexpr int kHalf = kCo / 2;             // columns of one warpgroup
  static constexpr int kXBytes = kRows * 128;       // an x tile
  static constexpr int kWBytes = kCo * 128;         // a W tile (one K step)
  static constexpr int kZS = kCo + 4;               // z row stride (floats)
  static constexpr int kSlots = (kCo + 127) / 128;  // 4-channel slots per lane in a row
  static_assert(kCo % 32 == 0 && kCo <= 256, "Co a multiple of 32 up to 256");
};

// The shared-memory plan, in bytes from the 1024-aligned base: the ring
// (stages of an x tile and a W tile), z, the row statistics (the two
// warpgroups' partial sums, squares about the mean and cross sums of each
// row), the phase parameters (three coefficients per owned row and phase),
// the taps, then the barriers (full, empty per stage).
template <int kCo>
struct Plan {
  int ring, stage, z, stats, prm, taps, bars, total;
  __host__ __device__ Plan(int stages, int s) {
    using G = Geo<kCo>;
    ring = 0;
    stage = G::kXBytes + G::kWBytes;
    z = ring + stages * stage;
    stats = z + 4 * kRows * G::kZS;
    prm = stats + 4 * 6 * kRows;
    taps = prm + 4 * 3 * kOwn * s;
    bars = (taps + 4 * 3 * kMaxScale + 7) / 8 * 8;
    total = 1024 + bars + 8 * 2 * stages;
  }
};

// acc[kOff / 2 ..] += A (64 x 16) W[rows n0 + kOff ..]^T over kN columns, in
// chunks of 128 / 64 / 32 / 16: chunk c's accumulators follow the previous
// chunk's, so acc[4 j + i] is column 8 j + 2 t + i % 2 of the whole half
template <int kN, int kOff = 0>
__device__ __forceinline__ void mma_half(float* acc, uint64_t da, const unsigned char* w,
                                         int scale_d) {
  if constexpr (kN > 0) {
    constexpr int kC = kN >= 128 ? 128 : kN >= 64 ? 64 : kN >= 32 ? 32 : 16;
    ptx::wgmma_bf16<kC>(*reinterpret_cast<float(*)[kC / 2]>(acc + kOff / 2), da,
                        ptx::wgmma_desc_sw128(w + kOff * 128), scale_d);
    mma_half<kN - kC, kOff + kC>(acc, da, w, scale_d);
  }
}

// a z row as lane `lane` holds it: slots of channels 4 lane + 128 k (zero past Co)
template <int kCo>
__device__ __forceinline__ void load_row(float4 (&v)[Geo<kCo>::kSlots], const float* zs, int r,
                                         int lane) {
#pragma unroll
  for (int k = 0; k < Geo<kCo>::kSlots; ++k) {
    const int o = 4 * lane + 128 * k;
    v[k] = o < kCo ? *reinterpret_cast<const float4*>(zs + r * Geo<kCo>::kZS + o)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

// The statistics of the item's rows from z + b in the accumulators (acc[4 j +
// 2 h + e]: row r_h = 16 warp4 + g + 8 h, column kHalf cw + 8 j + 2 t4 + e)
// and the next rows in zs: each warpgroup's partial sums of every row into
// stats (sums, then D and C, [2][kRows] each). Consumer threads; named
// barrier 1; zs holds the edge rows already.
template <int kCo>
__device__ __forceinline__ void row_stats(const float* acc, const float* zs, float* stats,
                                          int r_last, int ct) {
  using G = Geo<kCo>;
  const int cw = ct / 128, warp4 = (ct % 128) >> 5, lane = ct & 31, g = lane >> 2, t4 = lane & 3;
  float* ps = stats;                 // row sums, by warpgroup
  float* pd = stats + 2 * kRows;     // sums of squares about the mean
  float* pc = stats + 4 * kRows;     // cross sums with the next row
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < G::kHalf / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) sum[h] += acc[4 * j + 2 * h] + acc[4 * j + 2 * h + 1];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    if (t4 == 0) ps[cw * kRows + 16 * warp4 + g + 8 * h] = sum[h];
  }
  ptx::bar_sync(1, kConsumerThreads);
  float m[2], mn[2], d2[2] = {0.0f, 0.0f}, cx[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp4 + g + 8 * h;
    // the row after the edge row is its copy: its mean is the edge row's
    const int rn = r == r_last || r == kRows - 1 ? r : r + 1;
    m[h] = (ps[r] + ps[kRows + r]) / kCo;
    mn[h] = (ps[rn] + ps[kRows + rn]) / kCo;
  }
#pragma unroll
  for (int j = 0; j < G::kHalf / 8; ++j) {
    const int o = cw * G::kHalf + 8 * j + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp4 + g + 8 * h;
      const float2 zn = r < kRows - 1 ? *reinterpret_cast<const float2*>(zs + (r + 1) * G::kZS + o)
                                      : make_float2(0.0f, 0.0f);
      const float u0 = acc[4 * j + 2 * h] - m[h], u1 = acc[4 * j + 2 * h + 1] - m[h];
      d2[h] = fmaf(u1, u1, fmaf(u0, u0, d2[h]));
      cx[h] = fmaf(u1, zn.y - mn[h], fmaf(u0, zn.x - mn[h], cx[h]));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      d2[h] += __shfl_xor_sync(0xffffffffu, d2[h], x);
      cx[h] += __shfl_xor_sync(0xffffffffu, cx[h], x);
    }
    if (t4 == 0) {
      const int r = cw * kRows + 16 * warp4 + g + 8 * h;
      pd[r] = d2[h], pc[r] = cx[h];
    }
  }
  ptx::bar_sync(1, kConsumerThreads);
}

// The epilogue of the item whose z + b is in zs (rows t0 - 1 + i) and in
// acc: the statistics, the phase parameters, the blended, normalized rows
// out. Consumer threads only (ct < 256); named barrier 1.
template <int kCo>
__device__ __forceinline__ void epilogue(const float* acc, float* zs, float* stats, float* prm,
                                         const float* taps, const Args& a, int b, int t0,
                                         int ct) {
  using G = Geo<kCo>;
  const int lane = ct & 31, warp = ct >> 5;
  const int T = a.T, s = a.s;
  // the edge rule: z row -1 is z row 0, z row T is z row T - 1
  const int r_last = T - t0;            // the local row of time T - 1
  const bool first = t0 == 0, last = r_last < kRows - 1;
  if (first || last) {
    for (int o = ct; o < kCo; o += kConsumerThreads) {
      if (first) zs[o] = zs[G::kZS + o];
      if (last) zs[(r_last + 1) * G::kZS + o] = zs[r_last * G::kZS + o];
    }
    ptx::bar_sync(1, kConsumerThreads);
  }
  const bool norm = a.norm_w != nullptr;
  if (norm) {
    row_stats<kCo>(acc, zs, stats, r_last, ct);
    // row r's mean, sum of squares and cross sum with row r + 1, from the
    // two warpgroups' partial sums; a halo row's are its edge row's
    auto edge = [&](int r) { return first && r == 0 ? 1 : last && r == r_last + 1 ? r_last : r; };
    auto mean = [&](int r) { return (stats[edge(r)] + stats[kRows + edge(r)]) / kCo; };
    auto dsum = [&](int r) { return stats[2 * kRows + edge(r)] + stats[3 * kRows + edge(r)]; };
    auto csum = [&](int r) {
      return first && r == 0 ? dsum(1) : stats[4 * kRows + r] + stats[5 * kRows + r];
    };
    for (int e = ct; e < kOwn * s; e += kConsumerThreads) {
      const int i = 1 + e / s, p = e - (i - 1) * s;
      const float wp = taps[3 * p], wc = taps[3 * p + 1], wx = taps[3 * p + 2];
      const bool prev = wp != 0.0f;
      const float wo = prev ? wp : wx;
      const int ro = prev ? i - 1 : i + 1;
      const float q = fmaf(wo * wo, dsum(ro), fmaf(wc * wc, dsum(i),
                                                   2.0f * wo * wc * csum(prev ? i - 1 : i)));
      const float mu = fmaf(mean(i), wc, mean(ro) * wo);
      const float rsd = 1.0f / sqrtf(fmaxf(q, 0.0f) / kCo + kNormEps);
      // (w_c z_c + w_o z_o - mu) rsd = z_c (w_c rsd) + z_o (w_o rsd) - mu rsd
      prm[3 * e] = wc * rsd, prm[3 * e + 1] = wo * rsd, prm[3 * e + 2] = -mu * rsd;
    }
    ptx::bar_sync(1, kConsumerThreads);
  }
  float4 nw[G::kSlots], nb[G::kSlots];
#pragma unroll
  for (int k = 0; k < G::kSlots; ++k) {
    const int o = 4 * lane + 128 * k;
    nw[k] = nb[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (norm && o < kCo) nw[k] = ld4(a.norm_w + o), nb[k] = ld4(a.norm_b + o);
  }
  // a warp per owned row i (time t0 - 1 + i), each phase's Co channels as
  // 8-byte pieces at the interleaved address
  for (int i = 1 + warp; i < kRows - 1; i += kWarps) {
    const int t = t0 - 1 + i;
    if (t >= T) break;
    float4 zp[G::kSlots], zc[G::kSlots], zn[G::kSlots];
    load_row<kCo>(zp, zs, i - 1, lane);
    load_row<kCo>(zc, zs, i, lane);
    load_row<kCo>(zn, zs, i + 1, lane);
    bf16* orow = a.out + ((static_cast<long long>(b) * T + t) * s) * kCo;
    for (int p = 0; p < s; ++p) {
      const float wp = taps[3 * p], wc = taps[3 * p + 1], wx = taps[3 * p + 2];
      const bool prev = wp != 0.0f;
      // the blend and the normalization as two fmas of the row's
      // coefficients, then the affine as a third
      const float* pr = prm + 3 * ((i - 1) * s + p);
      const float ca = norm ? pr[0] : wc, cb = norm ? pr[1] : (prev ? wp : wx);
      const float cc = norm ? pr[2] : 0.0f;
#pragma unroll
      for (int k = 0; k < G::kSlots; ++k) {
        const int o = 4 * lane + 128 * k;
        if (o >= kCo) continue;
        const float4 zo = prev ? zp[k] : zn[k];
        float4 v = make_float4(fmaf(zc[k].x, ca, fmaf(zo.x, cb, cc)),
                               fmaf(zc[k].y, ca, fmaf(zo.y, cb, cc)),
                               fmaf(zc[k].z, ca, fmaf(zo.z, cb, cc)),
                               fmaf(zc[k].w, ca, fmaf(zo.w, cb, cc)));
        if (norm)
          v = make_float4(fmaf(v.x, nw[k].x, nb[k].x), fmaf(v.y, nw[k].y, nb[k].y),
                          fmaf(v.z, nw[k].z, nb[k].z), fmaf(v.w, nw[k].w, nb[k].w));
        *reinterpret_cast<uint2*>(orow + p * kCo + o) =
            make_uint2(ptx::bf16x2_rn(v.x, v.y), ptx::bf16x2_rn(v.z, v.w));
      }
    }
  }
}

// registers for kSmallBlocks blocks per SM up to Co = 128
template <int kCo>
__global__ void __launch_bounds__(kThreads, kCo <= 128 ? kSmallBlocks : 1)
    up_fused_tc_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                            const __grid_constant__ CUtensorMap map_w, const Args a) {
  using G = Geo<kCo>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - ptx::smem_addr(smem_raw) % 1024) % 1024);
  const int S = a.stages;
  const int ksteps = (a.Ci + kBK - 1) / kBK;
  const Plan<kCo> P(S, a.s);
  unsigned char* ring = base + P.ring;
  float* zs = reinterpret_cast<float*>(base + P.z);
  float* stats = reinterpret_cast<float*>(base + P.stats);
  float* prm = reinterpret_cast<float*>(base + P.prm);
  float* taps = reinterpret_cast<float*>(base + P.taps);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + P.bars);
  uint64_t* empty = full + S;
  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      ptx::mbar_init(&full[st], 1);
      ptx::mbar_init(&empty[st], kConsumerThreads);
    }
    ptx::fence_mbarrier_init();
  }
  if (threadIdx.x < 3 * kMaxScale) {  // constant indices: the parameter array is not indexed
#pragma unroll
    for (int e = 0; e < 3 * kMaxScale; ++e)
      if (e == static_cast<int>(threadIdx.x)) taps[e] = a.taps[e / 3][e % 3];
  }
  __syncthreads();

  if (threadIdx.x >= kProducer) {  // ---- producer warp: one thread issues TMA ----
    if (threadIdx.x != kProducer) return;
    int st = 0;
    uint32_t ph = 0;
    for (int idx = blockIdx.x; idx < a.items; idx += gridDim.x) {
      const int b = idx / a.tiles, t0 = (idx - b * a.tiles) * kOwn;
      for (int k = 0; k < ksteps; ++k) {
        ptx::mbar_wait(&empty[st], ph ^ 1);
        unsigned char* dst = ring + static_cast<size_t>(st) * P.stage;
        ptx::mbar_arrive_expect_tx(&full[st], P.stage);
        ptx::tma_load_4d(dst, &map_x, &full[st], k * kBK, t0 - 1, b, 0);
        ptx::tma_load_2d(dst + G::kXBytes, &map_w, &full[st], k * kBK, 0);
        if (++st == S) st = 0, ph ^= 1;
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw computes columns kHalf cw .. of each item ----
  const int ct = threadIdx.x, cw = ct / 128;
  const int warp4 = (ct % 128) >> 5, lane = ct & 31, g = lane >> 2, t4 = lane & 3;
  int st = 0;
  uint32_t ph = 0;
  for (int idx = blockIdx.x; idx < a.items; idx += gridDim.x) {
    const int b = idx / a.tiles, t0 = (idx - b * a.tiles) * kOwn;
    float acc[G::kHalf / 2];
#pragma unroll
    for (int e = 0; e < G::kHalf / 2; ++e) acc[e] = 0.0f;
    for (int k = 0; k < ksteps; ++k) {
      ptx::mbar_wait(&full[st], ph);
      const unsigned char* xt = ring + static_cast<size_t>(st) * P.stage;
      const unsigned char* wt = xt + G::kXBytes + cw * G::kHalf * 128;
#pragma unroll
      for (int e = 0; e < G::kHalf / 2; ++e) ptx::fence_operand(acc[e]);
      ptx::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        mma_half<G::kHalf>(acc, ptx::wgmma_desc_sw128(xt) + 2 * kk, wt + 32 * kk, 1);
      ptx::wgmma_commit();
      ptx::wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < G::kHalf / 2; ++e) ptx::fence_operand(acc[e]);
      ptx::mbar_arrive(&empty[st]);  // every consumer thread, after its own wait
      if (++st == S) st = 0, ph ^= 1;
    }
    // z + b in the accumulators and into shared memory once the last item's
    // epilogue has read it: acc[4 j + i] is row 16 warp4 + g + 8 (i / 2),
    // column kHalf cw + 8 j + 2 t4 + i % 2
    ptx::bar_sync(1, kConsumerThreads);
#pragma unroll
    for (int j = 0; j < G::kHalf / 8; ++j) {
      const int o = cw * G::kHalf + 8 * j + 2 * t4;
      const float2 bias = make_float2(__bfloat162float(a.bias[o]), __bfloat162float(a.bias[o + 1]));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[4 * j + 2 * h] += bias.x, acc[4 * j + 2 * h + 1] += bias.y;
        *reinterpret_cast<float2*>(zs + (16 * warp4 + g + 8 * h) * G::kZS + o) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    ptx::bar_sync(1, kConsumerThreads);
    epilogue<kCo>(acc, zs, stats, prm, taps, a, b, t0, ct);
  }
}

// ---- host side ----------------------------------------------------------

template <int kCo>
cudaError_t launch(const bf16* x, const bf16* w, Args a, cudaStream_t stream) {
  const auto fn = l3ac::sm90::encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  // kBlocks blocks per SM where a ring of two stages (three with two blocks)
  // fits their share of the shared memory, else one; the ring as deep as
  // the share allows, up to kMaxStages
  constexpr int kPerSm = 233472;   // 228 KB an SM, 1 KB of it reserved per block
  constexpr int kBlocks = kCo <= 128 ? kSmallBlocks : 2;
  auto total = [&](int stages) { return Plan<kCo>(stages, a.s).total; };
  int budget = kPerSm / kBlocks - 1024;
  if (total(kBlocks > 2 ? 2 : 3) > budget) budget = static_cast<int>(l3ac::sm90::kMaxSmem);
  if (total(2) > budget) return cudaErrorInvalidValue;
  a.stages = 2;
  while (a.stages < kMaxStages && total(a.stages + 1) <= budget) ++a.stages;
  const size_t smem = total(a.stages);
  CUtensorMap mx, mw;
  std::memset(&mx, 0, sizeof(mx));
  std::memset(&mw, 0, sizeof(mw));
  {  // x: (Ci, T, B, 1), boxes of 64 columns x 64 rows
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(a.Ci), static_cast<cuuint64_t>(a.T),
                                static_cast<cuuint64_t>(a.B), 1};
    const cuuint64_t row = 2ull * a.Ci;
    const cuuint64_t strides[3] = {row, row * a.T, row * a.T * a.B};
    const cuuint32_t box[4] = {kBK, kRows, 1, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    if (fn(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(x), dims, strides, box,
           elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  {  // W: (Ci, Co), boxes of 64 columns x Co rows
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.Ci), static_cast<cuuint64_t>(kCo)};
    const cuuint64_t strides[1] = {2ull * a.Ci};
    const cuuint32_t box[2] = {kBK, kCo};
    const cuuint32_t elem[2] = {1, 1};
    if (fn(&mw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(w), dims, strides, box,
           elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  auto kernel = up_fused_tc_bf16_kernel<kCo>;
  // the attribute once, the occupancy once per shared-memory size
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
  const int grid = a.items < cap ? a.items : cap;
  kernel<<<grid, kThreads, smem, stream>>>(mx, mw, a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x: (B, T, Ci) bf16, Ci % 8 == 0 and <= 1024, 16-byte aligned; w: (Co, Ci)
// bf16, 16-byte aligned (up_fused.py:prepare_up's "tc" buffer: at Co % 32 ==
// 0 and Ci % 8 == 0 it is W as it is); bias (Co), norm_w / norm_b (Co), both
// null for no norm, 8-byte aligned; out: (B, T s, Co) bf16, 8-byte aligned;
// Co a multiple of 32 up to 256; 1 <= s <= 16. All contiguous. Returns the
// CUDA error code (invalid value for a shape it does not take).
extern "C" int l3ac_up_fused_wgmma_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                        const __nv_bfloat16* bias, const __nv_bfloat16* norm_w,
                                        const __nv_bfloat16* norm_b, __nv_bfloat16* out, int B,
                                        int Ci, int Co, int T, int s, void* stream) {
  auto al8 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; };
  if (B < 1 || T < 1 || Ci < 8 || Ci > 1024 || Ci % 8 != 0 || Co < 32 || Co > 256 ||
      Co % 32 != 0 || s < 1 || s > kMaxScale || !aligned16(x) || !aligned16(w) || !al8(out) ||
      (norm_w == nullptr) != (norm_b == nullptr) ||
      (norm_w != nullptr && (!al8(norm_w) || !al8(norm_b))) ||
      static_cast<long long>(B) * ((T + kOwn - 1) / kOwn) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  Args a{bias, norm_w, norm_b, out, Ci, Co, T, s, B, (T + kOwn - 1) / kOwn, 0, 0, {}};
  a.items = B * a.tiles;
  for (int p = 0; p < s; ++p) {  // ops/resample.py:phase_weights, in double
    const double d = (p + 0.5) / s - 0.5;
    const double wt = 1.0 + d;
    a.taps[p][0] = d >= 0.0 ? 0.0f : static_cast<float>(1.0 - wt);
    a.taps[p][1] = d >= 0.0 ? static_cast<float>(1.0 - d) : static_cast<float>(wt);
    a.taps[p][2] = d >= 0.0 ? static_cast<float>(d) : 0.0f;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Co / 32) {
    case 1: return launch<32>(x, w, a, st);
    case 2: return launch<64>(x, w, a, st);
    case 3: return launch<96>(x, w, a, st);
    case 4: return launch<128>(x, w, a, st);
    case 5: return launch<160>(x, w, a, st);
    case 6: return launch<192>(x, w, a, st);
    case 7: return launch<224>(x, w, a, st);
    default: return launch<256>(x, w, a, st);
  }
}
