// Decoder up path as a streaming pass, for the narrow stages (B, C, T) and
// any shape the tensor-core kernel of the wide stages (up_fused_tc.cu) does
// not take:
//   z = W x + b (1x1 conv Ci -> Co) -> linear upsample x s with torch's
//   align_corners=False edge rule -> ChannelNorm over Co (eps 1e-8 inside the
//   sqrt) -> affine
//
// Replaces l3ac_tpu/ops/pallas/upsample.py:up_fused_ct (body _kernel_ct,
// (B, C, T), with phase_split), and :up_fused (body _kernel, (B, T, C)) at the
// shapes up_fused_tc.cu does not serve. The input and output strides are
// arguments: the input is (B, C, T) or (B, T, C), the output the interleaved
// (.., T s, ..) array of either layout or s phase arrays.
//
// Bound on the H100: 4 Ci bytes read and 4 s Co written per input column
// against 2 Ci Co operations for the conv and about 8 s Co for blend and norm.
// The 1kbps narrow pair (96 -> 48 s3, 48 -> 24 s2 at B = 8) moves 451 MB, 0.135
// ms, and its fp32 work is about 0.063 ms: bound by bytes, so the block's
// work has to be short beside its memory traffic, and every byte moves once.
// Design: one block of 8 warps per (batch, tile of S = 128 input columns;
// fewer where a large scale needs the shared memory), 2-4 blocks per SM.
//   1. W (prepared once by the caller, zero-padded) and x for columns t0 - 4
//      .. t0 + S + 3 go to shared memory by cp.async (x: 16-byte copies along
//      T where T % 4 == 0, else 4-byte copies, each coalesced; column
//      indices clamped into [0, T), which is the align_corners=False rule).
//   2. z on the tensor cores, 3xTF32 mma.sync with the GEMM core's accuracy
//      rules (tc_gemm.cuh): output channels as the M axis, so W is the
//      K-major A operand (ldmatrix) and x, time-contiguous in shared memory,
//      gives the B fragments by plain conflict-free loads, with no transpose
//      (fp32 has no ldmatrix.trans, which time as the M axis, as in
//      conv_unit_narrow.cu, would need). The first design, a SIMT conv
//      with register blocking, spent most of the pass in the conv.
//   3. The statistics of each z column over Co, one thread per column: the
//      mean m, then the sum of squares about it D and the cross sum with the
//      next column C. A phase p blends two columns a, b with taps w_a, w_b:
//      its mean is w_a m_a + w_b m_b and its sum of squares w_a^2 D_a +
//      w_b^2 D_b + 2 w_a w_b C_a, exact identities of the centred sums, so no
//      phase needs a reduction of its own.
//   4. Each (column, phase) belongs to a pair of lanes over the channels:
//      blend, one reciprocal of the standard deviation, the affine, written
//      to an output tile in shared memory laid out in the output's order. No
//      per-element division and no double arithmetic: the phase taps are
//      floats computed once on the host in double, as
//      ops/resample.py:phase_weights does.
//   5. The tile is copied out, one warp per run (an output row, a phase row,
//      or for channels-last one row of Co): 16-byte stores wherever the
//      destination quad is whole, so an output row whose start is not
//      16-byte aligned (T s is odd at 1kbps) still goes out in 16-byte
//      stores between its ends.
// Widths: Ci <= 128 and Co <= 128. ChannelNorm reduces over Co at each
// position, so a block holds all Co rows of z for its columns and
// normalizes in one pass: at Co = 128 z takes 128 x (S + 8) floats (74 KB at
// S = 128), and where W, x, z and the output tile do not fit the 227 KB the
// tile halves (S = 64 at 128 -> 128, s = 3). A second pass over Co tiles with
// the statistics summed across them would write z to device memory and read
// it back, more bytes for a kernel that is bound by its bytes. Above Co = 64
// a warp computes one n8 tile of columns at a time (the accumulators of 8
// m16 tiles).
// bf16 (x and out bf16, the bf16 weights' values in the same fp32 buffer):
// one bf16 tensor-core pass, mma.sync m16n8k8, whose k pairs are taken as the
// fp32 kernel's ldmatrix words t and t + 4 (a permutation of K applied to W
// and x alike, so the product is unchanged); the k8 shape keeps K = Ci
// rounded up to 8, as the fp32 path stages it. z, the bias, the blend and the
// norm stay fp32 and the store rounds once, as upsample.py:_kernel_ct does.
// x is staged by plain loads, converted to fp32 in shared memory: on (B, C,
// T) a warp per channel row, its lanes along time, five loads in flight.
#include <type_traits>

#include "common.cuh"
#include "ptx.cuh"

namespace {

namespace ptx = l3ac::ptx;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxS = 128;         // input columns per block
constexpr int kBK = 32;            // K step of the conv, one fresh accumulator each
// n8 tiles of time columns a warp computes at once: two from kPairFromMT m16
// tiles of channels on (Co = 48 measured 7 % faster with two, Co = 24 4 %
// slower: the registers of the second tile cost it a block per SM), up to
// four m16 tiles
constexpr int kPairFromMT = 3;
constexpr int kMaxScale = 16;
constexpr float kNormEps = 1e-8f;
enum Order { kTimeFastest = 0, kChannelFastest = 1, kPhaseFastest = 2 };

struct Args {
  const void* x;        // float or bf16
  const float* w;       // the prepared buffer: W (Mp, Kp + 4) zero-padded, b, norm_w, norm_b
  void* out;            // x's type
  int Ci, Co, T, s, S;
  int norm;
  long long xB, xC, xT;      // input strides
  long long oB, oC, oT, oP;  // output strides of batch, channel, input column, phase
  int order;
  int x_vec;                 // (B, C, T) rows 16-byte aligned: 16-byte copies
  float taps[kMaxScale][3];  // per phase: w_prev, w_cur, w_next
};

// Shared-memory regions in floats; the same on the host and the card. The
// column index j of x, z and the statistics is input column t0 - 4 + j.
struct Geometry {
  int kp;    // K = Ci rounded up to 8 (rows of x past Ci are zero)
  int mp;    // M = Co rounded up to 16 (rows of W past Co are zero)
  int wsr;   // row stride of W: kp + 4, 4 mod 8 words, so ldmatrix rows hit distinct banks
  int xs;    // row stride of x: S + 8 columns, 8 mod 32 (the B fragments' loads)
  int zs;    // row stride of z: S + 8 columns padded to 16 mod 32 (the epilogue's loads)
  int os;    // row stride of the output tile (a run)
  int runs;  // runs in the output tile
  int w_floats, x_floats, o_floats, z_floats, big, total;
  __host__ __device__ Geometry(int Ci, int Co, int s, int S, int order) {
    kp = (Ci + 7) / 8 * 8;
    mp = (Co + 15) / 16 * 16;
    wsr = kp + 4;
    xs = S + 8;
    zs = S + 8 + (((16 - (S + 8)) % 32) + 32) % 32;
    if (order == kTimeFastest) {
      os = S * s + 16, runs = Co;
    } else if (order == kPhaseFastest) {
      os = S + 16, runs = s * Co;
    } else {
      os = Co + 1, runs = S * s;
    }
    w_floats = mp * wsr;
    x_floats = kp * xs;
    o_floats = runs * os;
    z_floats = Co * zs;
    // [W, x | the output tile over both] [z] [m, D, C per column] [norm_w, norm_b]
    const int in = w_floats + x_floats;
    big = ((in > o_floats ? in : o_floats) + 3) / 4 * 4;
    total = big + z_floats + 3 * xs + 2 * Co;
  }
};

__device__ __forceinline__ void split(uint32_t raw, uint32_t& hi, uint32_t& lo) {
  const float v = __uint_as_float(raw);
  hi = ptx::tf32_rna(v);
  lo = ptx::tf32_rna(v - __uint_as_float(hi));
}

using bf16 = __nv_bfloat16;
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
// four consecutive outputs at an address aligned to four of them
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(ptx::bf16x2_rn(v[0], v[1]), ptx::bf16x2_rn(v[2], v[3]));
}

// TX: the type of x and out (float or bf16); kMT: m16 tiles of output
// channels, Co rounded up to 16, over 16
template <typename TX, int kMT>
__global__ void __launch_bounds__(kThreads) up_fused_stream_kernel(const Args a) {
  constexpr bool kBf16 = std::is_same_v<TX, bf16>;
  extern __shared__ __align__(16) float smem[];
  __shared__ float taps[kMaxScale * 3];
  const int Ci = a.Ci, Co = a.Co, T = a.T, s = a.s, S = a.S;
  const Geometry g(Ci, Co, s, S, a.order);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * S;
  const long long b = blockIdx.y;
  const TX* xb = static_cast<const TX*>(a.x) + b * a.xB;
  float* ws = smem;                                  // (mp, wsr) W
  float* xs = ws + g.w_floats;                       // (kp, xs) x
  float* os = smem;                                  // the output tile, over W and x
  float* zs = smem + g.big;                          // (Co, zs) z
  float* st_m = zs + g.z_floats;                     // per column: mean,
  float* st_d = st_m + g.xs;                         // sum of squares about it,
  float* st_c = st_d + g.xs;                         // cross sum with the next column
  float* nwb = st_c + g.xs;                          // norm_w, norm_b
  if (tid == 0) {  // constant indices: the parameter array is never indexed at run time
#pragma unroll
    for (int e = 0; e < kMaxScale * 3; ++e) taps[e] = a.taps[e / 3][e % 3];
  }

  // 1. stage W, x (columns t0 - 4 .. t0 + S + 3, clamped into [0, T); rows
  //    Ci .. kp zero) and the norm's affine
  for (int e = 4 * tid; e < g.w_floats; e += 4 * kThreads) ptx::cp_async16(ws + e, a.w + e, 16);
  const int qx = g.xs / 4;  // quads of a staged row
  if constexpr (kBf16) {    // plain loads, converted to fp32
    constexpr int kPerLane = (kMaxS + 8 + 31) / 32;
    if (a.xT == 1) {        // (B, C, T): a warp per row, its lanes along T
      for (int c = warp; c < Ci; c += kWarps) {
        const TX* row = xb + c * a.xC;
        float v[kPerLane];
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int j = lane + 32 * k;
          const int t = t0 - 4 + j < 0 ? 0 : (t0 - 4 + j >= T ? T - 1 : t0 - 4 + j);
          v[k] = j < g.xs ? to_float(row[t]) : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < kPerLane; ++k)
          if (lane + 32 * k < g.xs) xs[c * g.xs + lane + 32 * k] = v[k];
      }
    } else {                // (B, T, C): along C
      for (int e = tid; e < Ci * g.xs; e += kThreads) {
        const int j = e / Ci, c = e - j * Ci;
        const int t = t0 - 4 + j < 0 ? 0 : (t0 - 4 + j >= T ? T - 1 : t0 - 4 + j);
        xs[c * g.xs + j] = to_float(xb[c * a.xC + t * a.xT]);
      }
    }
  } else if (a.xT == 1) {   // (B, C, T): along T
    for (int e = tid; e < Ci * qx; e += kThreads) {
      const int c = e / qx, u = e - c * qx, t = t0 - 4 + 4 * u;
      float* dst = xs + c * g.xs + 4 * u;
      const float* row = xb + c * a.xC;
      if (a.x_vec && t >= 0 && t + 4 <= T) {
        ptx::cp_async16(dst, row + t, 16);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int tt = t + k < 0 ? 0 : (t + k >= T ? T - 1 : t + k);
          ptx::cp_async4(dst + k, row + tt, 4);
        }
      }
    }
  } else {  // (B, T, C): along C, transposed into (kp, xs)
    for (int e = tid; e < Ci * g.xs; e += kThreads) {
      const int j = e / Ci, c = e - j * Ci;
      const int t = t0 - 4 + j < 0 ? 0 : (t0 - 4 + j >= T ? T - 1 : t0 - 4 + j);
      ptx::cp_async4(xs + c * g.xs + j, xb + t * a.xT + c * a.xC, 4);
    }
  }
  for (int e = Ci * g.xs + tid; e < g.x_floats; e += kThreads) xs[e] = 0.0f;
  if (a.norm) {
    const float* src = a.w + g.w_floats + Co;
    for (int e = tid; e < 2 * Co; e += kThreads) nwb[e] = __ldg(src + e);
  }
  ptx::cp_async_commit();
  ptx::cp_async_wait<0>();
  __syncthreads();

  // 2. z = W x + b on the tensor cores: M = output channels (W from shared
  //    memory by ldmatrix), N = time columns (each warp its n8 tiles of the
  //    S + 8 staged columns), K = Ci; 3xTF32 as in tc_gemm.cuh, both
  //    operands split at fragment load, a fresh accumulator per K step of 32
  {
    constexpr int kTilesPerPass = kMT >= kPairFromMT && kMT <= 4 ? 2 : 1;
    const int q = lane >> 3, r = lane & 7, gq = lane >> 2, tq = lane & 3;
    const float* pa = ws + ((q & 1) * 8 + r) * g.wsr + (q >> 1) * 4;
    const int n_tiles = g.xs / 8;
    for (int nt0 = kTilesPerPass * warp; nt0 < n_tiles; nt0 += kTilesPerPass * kWarps) {
      float sum[kTilesPerPass][kMT][4];
#pragma unroll
      for (int u = 0; u < kTilesPerPass; ++u)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) sum[u][mt][i] = 0.0f;
      for (int k0 = 0; k0 < g.kp; k0 += kBK) {
        float acc[kTilesPerPass][kMT][4];
#pragma unroll
        for (int u = 0; u < kTilesPerPass; ++u)
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[u][mt][i] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 8) {
          const int k8 = k0 + kk;
          if (k8 >= g.kp) break;
          if constexpr (kBf16) {
            // one bf16 pass: the pairs (column t, column t + 4) of W's rows g,
            // g + 8 and of x's column n, exact bf16 values in fp32
            uint32_t bb[kTilesPerPass];
#pragma unroll
            for (int u = 0; u < kTilesPerPass; ++u) {
              const int n = nt0 + u < n_tiles ? 8 * (nt0 + u) + gq : g.xs - 1;
              bb[u] = ptx::bf16x2_rn(xs[(k8 + tq) * g.xs + n], xs[(k8 + tq + 4) * g.xs + n]);
            }
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
              uint32_t raw[4];
              ptx::ldmatrix_x4(raw, pa + mt * 16 * g.wsr + k8);
              const uint32_t af[2] = {
                  ptx::bf16x2_rn(__uint_as_float(raw[0]), __uint_as_float(raw[2])),
                  ptx::bf16x2_rn(__uint_as_float(raw[1]), __uint_as_float(raw[3]))};
#pragma unroll
              for (int u = 0; u < kTilesPerPass; ++u) ptx::mma_bf16_k8(acc[u][mt], af, bb[u]);
            }
            continue;
          }
          // x[k8 + t][n + g], x[k8 + t + 4][n + g] of each tile; a tile past
          // the last (an odd count) reads the last column, and is not stored
          uint32_t bh[kTilesPerPass][2], bl[kTilesPerPass][2];
#pragma unroll
          for (int u = 0; u < kTilesPerPass; ++u) {
            const int n = nt0 + u < n_tiles ? 8 * (nt0 + u) + gq : g.xs - 1;
            split(__float_as_uint(xs[(k8 + tq) * g.xs + n]), bh[u][0], bl[u][0]);
            split(__float_as_uint(xs[(k8 + tq + 4) * g.xs + n]), bh[u][1], bl[u][1]);
          }
          uint32_t hi[kMT][4], lo[kMT][4];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            uint32_t raw[4];
            ptx::ldmatrix_x4(raw, pa + mt * 16 * g.wsr + k8);
#pragma unroll
            for (int i = 0; i < 4; ++i) split(raw[i], hi[mt][i], lo[mt][i]);
          }
          // small terms first; pass by pass, so that consecutive mma feed
          // independent accumulators
#pragma unroll
          for (int u = 0; u < kTilesPerPass; ++u)
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) ptx::mma_tf32(acc[u][mt], lo[mt], bh[u]);
#pragma unroll
          for (int u = 0; u < kTilesPerPass; ++u)
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) ptx::mma_tf32(acc[u][mt], hi[mt], bl[u]);
#pragma unroll
          for (int u = 0; u < kTilesPerPass; ++u)
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) ptx::mma_tf32(acc[u][mt], hi[mt], bh[u]);
        }
#pragma unroll
        for (int u = 0; u < kTilesPerPass; ++u)
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int i = 0; i < 4; ++i) sum[u][mt][i] += acc[u][mt][i];
      }
      // lane (gq, tq) holds channels gq and gq + 8, columns 2 tq and 2 tq + 1
#pragma unroll
      for (int u = 0; u < kTilesPerPass; ++u) {
        if (nt0 + u >= n_tiles) break;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int o = mt * 16 + gq + 8 * h;
            if (o < Co) {
              const float bo = __ldg(a.w + g.w_floats + o);
              *reinterpret_cast<float2*>(zs + o * g.zs + 8 * (nt0 + u) + 2 * tq) =
                  make_float2(sum[u][mt][2 * h] + bo, sum[u][mt][2 * h + 1] + bo);
            }
          }
      }
    }
  }
  __syncthreads();  // W and x are dead: the output tile takes their place

  // 3. the statistics of columns t0 - 1 .. t0 + S (j = 3 .. S + 4), one
  //    thread each: the mean m over Co, then the sum of squares about it D
  //    and the cross sum with the next column C. A phase blends two columns
  //    a, b with taps w_a, w_b: its mean is w_a m_a + w_b m_b and its sum of
  //    squares w_a^2 D_a + w_b^2 D_b + 2 w_a w_b C_a, so no phase needs a
  //    reduction of its own.
  const bool norm = a.norm != 0;
  if (norm) {
    const int j = 3 + tid;
    if (tid < S + 2) {
      float su = 0.0f;
#pragma unroll 4
      for (int o = 0; o < Co; ++o) su += zs[o * g.zs + j];
      st_m[j] = su / Co;
    }
    __syncthreads();
    if (tid < S + 2) {
      const float m = st_m[j], mn = tid < S + 1 ? st_m[j + 1] : 0.0f;
      float d = 0.0f, c = 0.0f;
#pragma unroll 4
      for (int o = 0; o < Co; ++o) {
        const float u = zs[o * g.zs + j] - m;
        d = fmaf(u, u, d);
        c = fmaf(u, zs[o * g.zs + j + 1] - mn, c);
      }
      st_d[j] = d;
      st_c[j] = c;
    }
    __syncthreads();
  }

  // 4. per (column, phase), a pair of lanes over the channels o = h mod 2:
  //    blend, normalize with one reciprocal of the standard deviation, write
  //    the output tile in the output's order
  const int cols = T - t0 < S ? T - t0 : S;
  {
    const int jt = tid >> 1, h = tid & 1, jc = 4 + jt;
    if (jt < cols) {
      for (int p = 0; p < s; ++p) {
        const float wp = taps[3 * p], wc = taps[3 * p + 1], wx = taps[3 * p + 2];
        const bool prev = wp != 0.0f;
        const float wo = prev ? wp : wx;
        const int jo = prev ? jc - 1 : jc + 1;
        float mu = 0.0f, rsd = 1.0f;
        if (norm) {
          const float qs = fmaf(wo * wo, st_d[jo],
                                fmaf(wc * wc, st_d[jc], 2.0f * wo * wc * st_c[prev ? jo : jc]));
          mu = fmaf(st_m[jc], wc, st_m[jo] * wo);
          rsd = 1.0f / sqrtf(fmaxf(qs, 0.0f) / Co + kNormEps);
        }
        // the tile index of (o, jt, p) is base + o * ostep
        int base, ostep;
        if (a.order == kTimeFastest) base = jt * s + p, ostep = g.os;
        else if (a.order == kPhaseFastest) base = p * Co * g.os + jt, ostep = g.os;
        else base = (jt * s + p) * g.os, ostep = 1;
#pragma unroll 4
        for (int o = h; o < Co; o += 2) {
          float y = fmaf(zs[o * g.zs + jc], wc, zs[o * g.zs + jo] * wo);
          if (norm) y = fmaf((y - mu) * rsd, nwb[o], nwb[Co + o]);
          os[base + o * ostep] = y;
        }
      }
    }
  }
  __syncthreads();

  // 5. copy the tile out, one warp per run, a vector of four outputs (16
  //    bytes fp32, 8 bf16) wherever the destination quad is whole
  int runs = g.runs, len;
  if (a.order == kTimeFastest) len = cols * s;
  else if (a.order == kPhaseFastest) len = cols;
  else len = Co, runs = cols * s;
  for (int r = warp; r < runs; r += kWarps) {
    TX* dst = static_cast<TX*>(a.out) + b * a.oB + static_cast<long long>(t0) * a.oT;
    if (a.order == kTimeFastest) dst += r * a.oC;
    else if (a.order == kPhaseFastest) dst += (r % Co) * a.oC + (r / Co) * a.oP;
    else dst += r * a.oP;
    const float* src = os + r * g.os;
    const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(dst) / sizeof(TX)) & 3);
    for (int e0 = 4 * lane - mis; e0 < len; e0 += 128) {  // e0: run element at a quad's start
      if (e0 >= 0 && e0 + 4 <= len) {
        store4(dst + e0, src + e0);
      } else {
        for (int u = e0 < 0 ? 0 : e0; u < e0 + 4 && u < len; ++u) store1(dst + u, src[u]);
      }
    }
  }
}

template <typename TX, int kMT>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const Geometry g(a.Ci, a.Co, a.s, a.S, a.order);
  const size_t smem = sizeof(float) * static_cast<size_t>(g.total);
  cudaError_t err = cudaFuncSetAttribute(up_fused_stream_kernel<TX, kMT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(l3ac::ceil_div(a.T, a.S), B);
  up_fused_stream_kernel<TX, kMT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename TX>
int run(const TX* x, const float* w, TX* out, int norm, int B, int Ci, int Co, int T, int s,
        long long xB, long long xC, long long xT, long long oB, long long oC, long long oT,
        long long oP, int order, void* stream) {
  if (B < 1 || B > 65535 || Ci < 1 || Ci > 128 || Co < 1 || Co > 128 || T < 1 || s < 1 ||
      s > kMaxScale || order < 0 || order > 2 || !aligned16(w))
    return cudaErrorInvalidValue;
  Args a{x, w, out, Ci, Co, T, s, kMaxS, norm != 0, xB, xC, xT, oB, oC, oT, oP, order,
         std::is_same_v<TX, float> && xT == 1 && T % 4 == 0 && aligned16(x) && xB % 4 == 0 &&
             xC % 4 == 0,
         {}};
  // the widest tile (a multiple of 32 columns) whose shared memory fits
  auto fits = [&](int S) {
    return sizeof(float) * static_cast<size_t>(Geometry(Ci, Co, s, S, order).total) <=
           227 * 1024;
  };
  while (a.S > 32 && !fits(a.S)) a.S /= 2;
  if (!fits(a.S)) return cudaErrorInvalidValue;
  for (int p = 0; p < s; ++p) {  // ops/resample.py:phase_weights, in double
    const double d = (p + 0.5) / s - 0.5;
    const double wt = 1.0 + d;
    a.taps[p][0] = d >= 0.0 ? 0.0f : static_cast<float>(1.0 - wt);
    a.taps[p][1] = d >= 0.0 ? static_cast<float>(1.0 - d) : static_cast<float>(wt);
    a.taps[p][2] = d >= 0.0 ? static_cast<float>(d) : 0.0f;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((Co + 15) / 16) {
    case 1: return launch<TX, 1>(a, B, st);
    case 2: return launch<TX, 2>(a, B, st);
    case 3: return launch<TX, 3>(a, B, st);
    case 4: return launch<TX, 4>(a, B, st);
    case 5: return launch<TX, 5>(a, B, st);
    case 6: return launch<TX, 6>(a, B, st);
    case 7: return launch<TX, 7>(a, B, st);
    case 8: return launch<TX, 8>(a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (B, Ci, T) with (xC, xT) = (T, 1), or (B, T, Ci) with (xC, xT) = (1, Ci);
// w: the prepared buffer (ops/kernels/up_fused.py:prepare_up): W as (Mp, Kp +
// 4), Mp = Co rounded up to 16, Kp = Ci rounded up to 8, zero-padded, then b,
// and norm_w, norm_b when norm is set; fp32 (a bf16 weight set's values),
// 16-byte aligned. out[b oB + o oC + t oT + p oP] receives phase p of input
// column t; order names the output's fastest axis (0 time, 1 channel, 2 time
// within a phase array) and must match the strides. x and out fp32
// (l3ac_up_fused) or bf16 (l3ac_up_fused_bf16), contiguous; 1 <= Ci <= 128,
// 1 <= Co <= 128, 1 <= s <= 16. Returns the CUDA error code (invalid value
// for a shape it does not take).
extern "C" int l3ac_up_fused(const float* x, const float* w, float* out, int norm, int B,
                             int Ci, int Co, int T, int s, long long xB, long long xC,
                             long long xT, long long oB, long long oC, long long oT,
                             long long oP, int order, void* stream) {
  return run(x, w, out, norm, B, Ci, Co, T, s, xB, xC, xT, oB, oC, oT, oP, order, stream);
}

extern "C" int l3ac_up_fused_bf16(const __nv_bfloat16* x, const float* w, __nv_bfloat16* out,
                                  int norm, int B, int Ci, int Co, int T, int s, long long xB,
                                  long long xC, long long xT, long long oB, long long oC,
                                  long long oT, long long oP, int order, void* stream) {
  return run(x, w, out, norm, B, Ci, Co, T, s, xB, xC, xT, oB, oC, oT, oP, order, stream);
}
