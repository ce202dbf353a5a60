// Decoder up path on (B, T, C), the wide stages (Ci = 512 -> 256, 256 -> 96),
// with the 1x1 conv on the tensor cores:
//   z = W x + b (1x1 conv Ci -> Co) -> linear upsample x s with torch's
//   align_corners=False edge rule -> ChannelNorm over Co (eps 1e-8 inside the
//   sqrt) -> affine; the output is channels-last and interleaved, (B, T s, Co).
//
// Replaces l3ac_tpu/ops/pallas/upsample.py:up_fused (body _kernel) on every
// (B, T, C) shape with Ci up to 1024 and Co up to 512; up_fused.cu (the
// streaming kernel) takes the (B, C, T) shapes.
// Widths: the weight buffer (up_fused.py:prepare_up) holds W, b and the norm
// with Co zero-padded to Cp, a multiple of 32, and W's rows to a multiple of
// 4 floats; the padded columns of z are zero, the statistics skip them and
// divide by the real Co, and only the real Co columns are stored. Ci % 4 != 0
// loads x in 4-byte pieces. Above Co = 256 a block owns 30 rows (32 z rows)
// and the ring has 2 stages, so that a 512-column W tile fits.
//
// Bound on the H100: 2 Ci Co operations per input row against 4 Ci bytes
// read and 4 s Co written. On the fp32 pipe that is bound by operations
// (0.108 ms for the 1kbps pair at B = 8); as 3xTF32 products at 495 TFLOP/s
// it is 0.044 ms, and the pair is bound by its bytes (0.077 ms).
//
// Design: the conv is the GEMM (rows of x) . W^T with time as the M axis, on
// the GEMM core's scheme (tc_gemm.cuh): mma.sync m16n8k8 TF32 with 3 passes
// (A_lo B_hi + A_hi B_lo + A_hi B_hi, tf32_rna hi / lo splits), K in steps of
// 32 through a 3-stage cp.async ring, and a fresh accumulator per K step added
// to the block's fp32 sum with an ordinary rounded add (the tensor core's own
// adds truncate). W is read in place in its nn.Linear (Co, Ci) layout and
// split into hi / lo as its fragments are loaded (kPreSplit = false); a
// pre-split hi / lo pair is the alternative.
//   - One block owns all Co columns of kRows = 64 z rows (the norm reduces
//     over Co): rows t0 - 1 .. t0 + 62, clamped into [0, T) as they are
//     loaded, so the halo row on each side repeats the edge frame at the ends
//     of the sequence, which is torch's align_corners=False rule. Blocks
//     overlap by 2 rows and own the 62 rows between their halos (3 % of the
//     products recomputed).
//   - Warps of 32 x 32 output tiles: 2 x (Co / 32) of them, 512 threads at
//     Co = 256, 192 at Co = 96.
//   - Epilogue: z + b goes from the accumulators to shared memory. One warp
//     per pair of z rows reduces, with shuffles, each row's mean m, its sum
//     of squares about the mean D and the cross sum C with the next row. A phase p of row t
//     blends two rows, v = w_a z_a + w_b z_b, so its mean is w_a m_a + w_b m_b
//     and its sum of squares w_a^2 D_a + w_b^2 D_b + 2 w_a w_b C_a: exact
//     identities of the centred sums, so no phase needs a reduction of its
//     own (a reduction per (row, phase) left the shuffles' latency exposed
//     in few warps); one thread per (row, phase) turns them into the mean
//     and one reciprocal of the standard deviation. Then one warp per owned
//     row blends each phase, normalizes, and stores the row of Co floats at
//     its final interleaved address, out[b, t s + p], with 16-byte stores
//     (lane l: channels 4 l + 128 k).
//     The phase taps are floats computed once on the host in double, as
//     ops/resample.py:phase_weights computes them.
// Tiling, measured on the card against its alternatives with
// l3ac_tpu_torch/tools/up_variants.py (PERF.md): 64-row tiles against 128
// (at Co <= 128 only: 32 x 32 warp tiles with a fresh accumulator need about
// 128 registers a thread, so a 128 x 256 tile does not fit), W split at
// fragment load against pre-split hi / lo (kPreSplit), the mma issued pass
// by pass or per accumulator: all within 1-5 % or slower. The products run at about a quarter of the TF32 rate, no faster
// than cuBLAS's fp32 conv of the same shapes; the same structure on wgmma
// (tools/up_fused_wgmma.cu) was right and slower.
// bf16 (l3ac_up_fused_tc_bf16: x, out and the prepared buffer bf16, W's rows
// padded to Ci8 = Ci rounded up to 8): one bf16 tensor-core pass, mma.sync
// m16n8k16, the ring's tiles bf16 in rows of 40 (80 bytes, so ldmatrix's
// eight rows hit distinct banks), both fragments by ldmatrix in the mma's
// natural k order, as tc_gemm.cuh's bf16 GEMM. x by 16-byte copies where
// Ci % 8 == 0, else by plain loads with zero fill. z, the bias, the blend
// and the norm are fp32 from the bf16 values, and the store rounds once, as
// upsample.py:_kernel does. The bound halves (bf16 bytes): 0.038 ms for the
// 1kbps pair at B = 8.
#include <type_traits>

#include "common.cuh"
#include "ptx.cuh"

namespace {

namespace ptx = l3ac::ptx;

constexpr int kBK = 32;               // K step, one fresh accumulator each
constexpr int kRow = kBK + 4;         // shared row stride of the ring tiles
constexpr int kStages = 3;            // cp.async ring
constexpr bool kPreSplit = false;     // W as TF32 hi / lo prepared by the caller
constexpr bool kTallTiles = false;    // 128-row tiles where Co <= 128
constexpr int kMaxScale = 16;
constexpr float kNormEps = 1e-8f;

// Pointers of the kernel's element type: fp32, or bf16 throughout (x, out,
// W and the vectors) in the bf16 kernel.
struct Args {
  const void* x;        // (B, T, Ci)
  const void* w_hi;     // (Cp, CiR): W, or its TF32 hi when pre-split
  const void* w_lo;     // (Cp, CiR): the TF32 lo when pre-split, else unused
  const void* bias;     // (Cp)
  const void* norm_w;   // (Cp) or null: no norm
  const void* norm_b;   // (Cp) or null
  void* out;            // (B, T s, Co)
  int Ci, Co, T, s;
  int Ci4;              // W's row stride CiR: Ci rounded up to 4 (fp32) or 8 (bf16)
  int x_vec;            // Ci % 4 == 0 (bf16: % 8) and x aligned: 16-byte copies of x
  int o_vec;            // Co % 4 == 0 and out 16 (bf16: 8)-byte aligned: vector stores
  float taps[kMaxScale][3];  // per phase: w_prev, w_cur, w_next
};

template <int kMW, int kNW, bool kBf16 = false>
struct Tile {
  static constexpr int kRows = 32 * kMW;        // z rows per block
  static constexpr int kOwn = kRows - 2;        // rows it stores
  static constexpr int kCo = 32 * kNW;
  static constexpr int kThreads = 32 * kMW * kNW;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kZS = kCo + 4;           // row stride of z in shared memory
  static constexpr int kSlots = (kCo + 127) / 128;  // float4 slots per lane in a row
  static constexpr int kRowB = kBK + 8;         // bf16 row stride of the ring tiles
  // floats of one ring stage: x rows and W rows, fp32 (W hi and lo when
  // pre-split) or bf16
  static constexpr int kStage = kBf16 ? (kRows + kCo) * kRowB / 2
                                      : (kRows + (kPreSplit ? 2 : 1) * kCo) * kRow;
  static constexpr int kRingStages = kCo > 256 ? 2 : kStages;  // a 512-column W tile: 2
  static constexpr int kRing = kRingStages * kStage;
  // z, the row statistics, the phase parameters
  static constexpr int kEpi = kRows * kZS + 3 * kRows + 2 * kOwn * kMaxScale;
  static constexpr int kFloats = kRing > kEpi ? kRing : kEpi;
};

// N sums at once, so that the shuffles' latencies overlap
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N]) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    float x[N];
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = __shfl_xor_sync(0xffffffffu, v[j], m);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] += x[j];
  }
}

// A z row as each lane holds it: kSlots float4 of channels 4 lane + 128 k
// (zero where that is past Co), and the lane's part of its sum and of a dot
// product, slot by slot.
template <int kSlots, int kCo, int kZS>
__device__ __forceinline__ void load_row(float4 (&v)[kSlots], const float* zs, int r, int lane) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int o = 4 * lane + 128 * k;
    v[k] = o < kCo ? *reinterpret_cast<const float4*>(zs + r * kZS + o)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// v - m on the real channels (o < Co), zero on the padded ones (kExact: none)
template <int kSlots, bool kExact>
__device__ __forceinline__ void center(float4 (&v)[kSlots], float m, int lane, int Co) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if constexpr (kExact) {
      v[k] = make_float4(v[k].x - m, v[k].y - m, v[k].z - m, v[k].w - m);
      continue;
    }
    const int o = 4 * lane + 128 * k;
    v[k] = make_float4(o < Co ? v[k].x - m : 0.0f, o + 1 < Co ? v[k].y - m : 0.0f,
                       o + 2 < Co ? v[k].z - m : 0.0f, o + 3 < Co ? v[k].w - m : 0.0f);
  }
}

template <int kSlots>
__device__ __forceinline__ void zero_row(float4 (&v)[kSlots]) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) v[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

template <int kSlots, int kCo>
__device__ __forceinline__ float row_sum(const float4 (&v)[kSlots], int lane) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
    if (4 * lane + 128 * k < kCo) s += ((v[k].x + v[k].y) + v[k].z) + v[k].w;
  return s;
}

template <int kSlots, int kCo>
__device__ __forceinline__ float row_dot(const float4 (&u)[kSlots], const float4 (&w)[kSlots],
                                         int lane) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
    if (4 * lane + 128 * k < kCo)
      s += fmaf(u[k].w, w[k].w, fmaf(u[k].z, w[k].z, fmaf(u[k].y, w[k].y, u[k].x * w[k].x)));
  return s;
}

__device__ __forceinline__ void split(uint32_t raw, uint32_t& hi, uint32_t& lo) {
  const float v = __uint_as_float(raw);
  hi = ptx::tf32_rna(v);
  lo = ptx::tf32_rna(v - __uint_as_float(hi));
}

using bf16 = __nv_bfloat16;
__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}
__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(ptx::bf16x2_rn(v.x, v.y), ptx::bf16x2_rn(v.z, v.w));
}

// kExact: Co == kCo, Ci % 4 == 0 and 16-byte aligned x and out (every released
// config's shapes): Co and the vector paths are compile-time facts, the code
// the kernel was tuned as; otherwise the padded, masked, 4-byte paths.
// kBf16: x, out and the buffer bf16, one bf16 pass (see the head note).
template <int kMW, int kNW, bool kExact, bool kBf16>
__global__ void __launch_bounds__(Tile<kMW, kNW, kBf16>::kThreads, 1)
    up_fused_tc_kernel(const Args a) {
  using G = Tile<kMW, kNW, kBf16>;
  using TX = std::conditional_t<kBf16, bf16, float>;
  const int Co = kExact ? G::kCo : a.Co;
  const bool x_vec = kExact || a.x_vec, o_vec = kExact || a.o_vec;
  extern __shared__ __align__(16) float smem[];
  __shared__ float taps[kMaxScale * 3];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kNW, wn = warp % kNW;
  if (tid == 0) {  // constant indices: the parameter array is never indexed at run time
#pragma unroll
    for (int e = 0; e < kMaxScale * 3; ++e) taps[e] = a.taps[e / 3][e % 3];
  }
  const int Ci = a.Ci, T = a.T;
  const int t0 = blockIdx.x * G::kOwn;  // first owned row; z row i is t0 - 1 + i
  const long long b = blockIdx.y;
  const TX* xb = static_cast<const TX*>(a.x) + b * T * static_cast<long long>(Ci);
  const int steps = (Ci + kBK - 1) / kBK;

  // rows of x (clamped into [0, T)) and W, K columns [32 s, 32 s + 32), into stage s
  constexpr int kRing = G::kRingStages;
  auto stage_in_bf16 = [&](int s, int k0) {
    bf16* st = reinterpret_cast<bf16*>(smem + (s % kRing) * G::kStage);
    const bf16* x0 = static_cast<const bf16*>(a.x);
    for (int e = tid; e < G::kRows * (kBK / 8); e += G::kThreads) {
      const int row = e / (kBK / 8), col = (e % (kBK / 8)) * 8;
      int t = t0 - 1 + row;
      t = t < 0 ? 0 : (t >= T ? T - 1 : t);
      const bf16* xr = reinterpret_cast<const bf16*>(xb) + static_cast<long long>(t) * Ci + k0 + col;
      if (x_vec) {
        const bool ok = k0 + col < Ci;
        ptx::cp_async16(st + row * G::kRowB + col, ok ? xr : x0, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u)
          st[row * G::kRowB + col + u] = k0 + col + u < Ci ? xr[u] : __float2bfloat16_rn(0.0f);
      }
    }
    const bf16* w = static_cast<const bf16*>(a.w_hi);
    for (int e = tid; e < G::kCo * (kBK / 8); e += G::kThreads) {
      const int row = e / (kBK / 8), col = (e % (kBK / 8)) * 8;
      const bool ok = k0 + col < a.Ci4;
      ptx::cp_async16(st + (G::kRows + row) * G::kRowB + col,
                      ok ? w + static_cast<long long>(row) * a.Ci4 + k0 + col : w, ok ? 16 : 0);
    }
  };
  auto stage_in = [&](int s) {
    const int k0 = s * kBK;
    if constexpr (kBf16) {
      stage_in_bf16(s, k0);
      return;
    }
    float* st = smem + (s % kRing) * G::kStage;
    for (int e = tid; e < G::kRows * (kBK / 4); e += G::kThreads) {
      const int row = e / (kBK / 4), col = (e % (kBK / 4)) * 4;
      int t = t0 - 1 + row;
      t = t < 0 ? 0 : (t >= T ? T - 1 : t);
      const float* xr = reinterpret_cast<const float*>(xb) + static_cast<long long>(t) * Ci + k0 + col;
      const float* x0 = static_cast<const float*>(a.x);
      if (x_vec) {
        const bool ok = k0 + col < Ci;
        ptx::cp_async16(st + row * kRow + col, ok ? xr : x0, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = k0 + col + u < Ci;
          ptx::cp_async4(st + row * kRow + col + u, ok ? xr + u : x0, ok ? 4 : 0);
        }
      }
    }
    for (int e = tid; e < (kPreSplit ? 2 : 1) * G::kCo * (kBK / 4); e += G::kThreads) {
      const int hl = e / (G::kCo * (kBK / 4)), rem = e % (G::kCo * (kBK / 4));
      const int row = rem / (kBK / 4), col = (rem % (kBK / 4)) * 4;
      const bool ok = k0 + col < a.Ci4;
      const float* src = static_cast<const float*>(hl ? a.w_lo : a.w_hi);
      ptx::cp_async16(st + (G::kRows + hl * G::kCo + row) * kRow + col,
                      ok ? src + static_cast<long long>(row) * a.Ci4 + k0 + col : src, ok ? 16 : 0);
    }
  };

  for (int s = 0; s < kRing - 1; ++s) {
    if (s < steps) stage_in(s);
    ptx::cp_async_commit();
  }

  float sum[2][4][4], acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[mt][nt][i] = 0.0f;

  // ldmatrix rows: A tiles q = (rows 0-7 | 8-15) x (k 0-3 | 4-7), q & 1 the
  // row half; W pairs of n8 tiles, q >> 1 the tile, q & 1 the k half
  const int q = lane >> 3, r = lane & 7;
  const int oa = (wm * 32 + (q & 1) * 8 + r) * kRow + (q >> 1) * 4;
  const int ob = (G::kRows + wn * 32 + (q >> 1) * 8 + r) * kRow + (q & 1) * 4;

  for (int s = 0; s < steps; ++s) {
    ptx::cp_async_wait<kRing - 2>();    // step s has landed
    __syncthreads();                    // ... for every thread; stage (s - 1) is free
    if (s + kRing - 1 < steps) stage_in(s + kRing - 1);
    ptx::cp_async_commit();

#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    const float* st = smem + (s % kRing) * G::kStage;
    if constexpr (kBf16) {
      // one bf16 pass per k16 step; ldmatrix rows as tc_gemm.cuh's bf16 GEMM
      const bf16* sb = reinterpret_cast<const bf16*>(st);
      const int oa16 = (wm * 32 + (q & 1) * 8 + r) * G::kRowB + (q >> 1) * 8;
      const int ob16 = (G::kRows + wn * 32 + (q >> 1) * 8 + r) * G::kRowB + (q & 1) * 8;
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        uint32_t bf[4][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t t4[4];
          ptx::ldmatrix_x4(t4, sb + ob16 + j * 16 * G::kRowB + ks * 16);
          bf[2 * j][0] = t4[0], bf[2 * j][1] = t4[1], bf[2 * j + 1][0] = t4[2],
          bf[2 * j + 1][1] = t4[3];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t af[4];
          ptx::ldmatrix_x4(af, sb + oa16 + mt * 16 * G::kRowB + ks * 16);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) ptx::mma_bf16(acc[mt][nt], af, bf[nt]);
        }
      }
    }
#pragma unroll
    for (int ks = 0; ks < (kBf16 ? 0 : kBK / 8); ++ks) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t t4[4];
        ptx::ldmatrix_x4(t4, st + ob + j * 16 * kRow + ks * 8);
        if constexpr (kPreSplit) {
          uint32_t l4[4];
          ptx::ldmatrix_x4(l4, st + ob + (G::kCo + j * 16) * kRow + ks * 8);
          bh[2 * j][0] = t4[0], bh[2 * j][1] = t4[1], bh[2 * j + 1][0] = t4[2],
          bh[2 * j + 1][1] = t4[3];
          bl[2 * j][0] = l4[0], bl[2 * j][1] = l4[1], bl[2 * j + 1][0] = l4[2],
          bl[2 * j + 1][1] = l4[3];
        } else {
          split(t4[0], bh[2 * j][0], bl[2 * j][0]);
          split(t4[1], bh[2 * j][1], bl[2 * j][1]);
          split(t4[2], bh[2 * j + 1][0], bl[2 * j + 1][0]);
          split(t4[3], bh[2 * j + 1][1], bl[2 * j + 1][1]);
        }
      }
      // A fragments of both m16 tiles (hi / lo), then the products of the
      // step, small terms first and pass by pass, so that consecutive mma
      // feed independent accumulators
      uint32_t hi[2][4], lo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t raw[4];
        ptx::ldmatrix_x4(raw, st + oa + mt * 16 * kRow + ks * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) split(raw[i], hi[mt][i], lo[mt][i]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) ptx::mma_tf32(acc[mt][nt], lo[mt], bh[nt]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) ptx::mma_tf32(acc[mt][nt], hi[mt], bl[nt]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) ptx::mma_tf32(acc[mt][nt], hi[mt], bh[nt]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[mt][nt][i] += acc[mt][nt][i];
  }
  ptx::cp_async_wait<0>();
  __syncthreads();  // the ring is dead: z takes its place

  // z + b into shared memory, (kRows, kZS); lane (g, t) holds rows g and
  // g + 8, columns 2t and 2t + 1 of each m16 x n8 tile
  float* zs = smem;
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int o = wn * 32 + nt * 8 + 2 * t;
      const TX* bias = static_cast<const TX*>(a.bias);
      const float b0 = ld1(bias + o), b1 = ld1(bias + o + 1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(zs + (wm * 32 + mt * 16 + g + 8 * h) * G::kZS + o) =
              make_float2(sum[mt][nt][2 * h] + b0, sum[mt][nt][2 * h + 1] + b1);
    }
  }
  __syncthreads();

  // the statistics of every z row r over Co: its mean m, the sum of squares
  // about it D, and the cross sum with the next row C = sum (z_r - m_r)
  // (z_r+1 - m_r+1); one warp per pair of rows, two rounds of shuffles with
  // three and four sums in flight
  const bool norm = a.norm_w != nullptr;
  float* stats = zs + G::kRows * G::kZS;  // m, D, C: kRows floats each
  float* prm = stats + 3 * G::kRows;      // per (owned row, phase): mean, 1 / sd
  if (norm) {  // the statistics of every z row
    for (int r = 2 * warp; r < G::kRows; r += 2 * G::kWarps) {
      float4 z0[G::kSlots], z1[G::kSlots], z2[G::kSlots];
      load_row<G::kSlots, G::kCo, G::kZS>(z0, zs, r, lane);
      load_row<G::kSlots, G::kCo, G::kZS>(z1, zs, r + 1, lane);
      if (r + 2 < G::kRows) load_row<G::kSlots, G::kCo, G::kZS>(z2, zs, r + 2, lane);
      else zero_row(z2);
      float m[3] = {row_sum<G::kSlots, G::kCo>(z0, lane), row_sum<G::kSlots, G::kCo>(z1, lane),
                    row_sum<G::kSlots, G::kCo>(z2, lane)};
      warp_sums(m);
#pragma unroll
      for (int j = 0; j < 3; ++j) m[j] /= Co;  // the padded columns are zero
      center<G::kSlots, kExact>(z0, m[0], lane, Co);
      center<G::kSlots, kExact>(z1, m[1], lane, Co);
      center<G::kSlots, kExact>(z2, m[2], lane, Co);
      float dc[4] = {row_dot<G::kSlots, G::kCo>(z0, z0, lane),
                     row_dot<G::kSlots, G::kCo>(z0, z1, lane),
                     row_dot<G::kSlots, G::kCo>(z1, z1, lane),
                     row_dot<G::kSlots, G::kCo>(z1, z2, lane)};
      warp_sums(dc);
      if (lane == 0) {
        stats[r] = m[0], stats[G::kRows + r] = dc[0], stats[2 * G::kRows + r] = dc[1];
        stats[r + 1] = m[1], stats[G::kRows + r + 1] = dc[2], stats[2 * G::kRows + r + 1] = dc[3];
      }
    }
    __syncthreads();
    // for each (owned row i, phase p), one thread: the blend of z rows a, b
    // with taps w_a, w_b has the mean w_a m_a + w_b m_b and the sum of
    // squares w_a^2 D_a + w_b^2 D_b + 2 w_a w_b C_a, so no phase needs a
    // reduction of its own
    for (int e = tid; e < G::kOwn * a.s; e += G::kThreads) {
      const int i = 1 + e / a.s, p = e - (i - 1) * a.s;
      const float wp = taps[3 * p], wc = taps[3 * p + 1], wx = taps[3 * p + 2];
      const bool prev = wp != 0.0f;
      const float wo = prev ? wp : wx;
      const int ro = prev ? i - 1 : i + 1;
      const float q = fmaf(wo * wo, stats[G::kRows + ro],
                           fmaf(wc * wc, stats[G::kRows + i],
                                2.0f * wo * wc * stats[2 * G::kRows + (prev ? i - 1 : i)]));
      prm[2 * e] = fmaf(stats[i], wc, stats[ro] * wo);
      prm[2 * e + 1] = 1.0f / sqrtf(fmaxf(q, 0.0f) / Co + kNormEps);
    }
  }
  __syncthreads();

  // one warp per owned row: for each phase the blend, the affine of the
  // normalized value, and 16-byte stores at the interleaved address
  float4 nw[G::kSlots], nb[G::kSlots];
#pragma unroll
  for (int k = 0; k < G::kSlots; ++k) {
    const int o = 4 * lane + 128 * k;
    nw[k] = nb[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (norm && o < G::kCo) {
      nw[k] = ld4(static_cast<const TX*>(a.norm_w) + o);
      nb[k] = ld4(static_cast<const TX*>(a.norm_b) + o);
    }
  }
  for (int i = 1 + warp; i < G::kRows - 1; i += G::kWarps) {
    const int t = t0 - 1 + i;
    if (t >= T) break;
    float4 zp[G::kSlots], zc[G::kSlots], zn[G::kSlots];
    load_row<G::kSlots, G::kCo, G::kZS>(zp, zs, i - 1, lane);
    load_row<G::kSlots, G::kCo, G::kZS>(zc, zs, i, lane);
    load_row<G::kSlots, G::kCo, G::kZS>(zn, zs, i + 1, lane);
    TX* orow = static_cast<TX*>(a.out) + ((b * T + t) * a.s) * static_cast<long long>(Co);
    for (int p = 0; p < a.s; ++p) {
      const float wp = taps[3 * p], wc = taps[3 * p + 1], wx = taps[3 * p + 2];
      const bool prev = wp != 0.0f;
      const float wo = prev ? wp : wx;
      const float mu = norm ? prm[2 * ((i - 1) * a.s + p)] : 0.0f;
      const float rsd = norm ? prm[2 * ((i - 1) * a.s + p) + 1] : 1.0f;
#pragma unroll
      for (int k = 0; k < G::kSlots; ++k) {
        const float4 zo = prev ? zp[k] : zn[k];
        float4 v = make_float4(fmaf(zc[k].x, wc, zo.x * wo), fmaf(zc[k].y, wc, zo.y * wo),
                               fmaf(zc[k].z, wc, zo.z * wo), fmaf(zc[k].w, wc, zo.w * wo));
        if (norm)
          v = make_float4(fmaf((v.x - mu) * rsd, nw[k].x, nb[k].x),
                          fmaf((v.y - mu) * rsd, nw[k].y, nb[k].y),
                          fmaf((v.z - mu) * rsd, nw[k].z, nb[k].z),
                          fmaf((v.w - mu) * rsd, nw[k].w, nb[k].w));
        const int o = 4 * lane + 128 * k;
        TX* op = orow + p * Co + o;
        if (o_vec) {
          if (o < Co) st4(op, v);
        } else {
          const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (o + u < Co) st1(op + u, vv[u]);
        }
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int kNW, bool kBf16>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int kMW = kNW > 8 ? 1 : (kTallTiles && kNW <= 4) ? 4 : 2;
  using G = Tile<kMW, kNW, kBf16>;
  constexpr size_t smem = sizeof(float) * static_cast<size_t>(G::kFloats);
  static_assert(smem <= 227 * 1024, "shared memory");
  const bool exact = kNW <= 8 && a.Co == G::kCo && a.x_vec && a.o_vec;
  auto kernel = exact ? up_fused_tc_kernel<kMW, kNW, kNW <= 8, kBf16>
                      : up_fused_tc_kernel<kMW, kNW, false, kBf16>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(l3ac::ceil_div(a.T, G::kOwn), B);
  kernel<<<grid, G::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kBf16>
int run(Args a, int B, void* stream) {
  const int Ci = a.Ci, Co = a.Co, s = a.s;
  const int es = kBf16 ? 2 : 4;  // element bytes
  if (B < 1 || B > 65535 || Ci < 1 || Ci > 1024 || Co < 1 || Co > 512 || a.T < 1 || s < 1 ||
      s > kMaxScale || !aligned16(a.w_hi) ||
      (!kBf16 && kPreSplit && (a.w_lo == nullptr || !aligned16(a.w_lo))) ||
      (a.norm_w == nullptr) != (a.norm_b == nullptr) ||
      (a.norm_w != nullptr && (reinterpret_cast<uintptr_t>(a.norm_w) % (4 * es) != 0 ||
                               reinterpret_cast<uintptr_t>(a.norm_b) % (4 * es) != 0)) ||
      static_cast<long long>(a.T) * s * Co >= (1LL << 40))
    return cudaErrorInvalidValue;
  a.Ci4 = kBf16 ? (Ci + 7) / 8 * 8 : (Ci + 3) / 4 * 4;
  a.x_vec = Ci % (16 / es) == 0 && aligned16(a.x);
  a.o_vec = Co % 4 == 0 && reinterpret_cast<uintptr_t>(a.out) % (4 * es) == 0;
  for (int p = 0; p < s; ++p) {  // ops/resample.py:phase_weights, in double
    const double d = (p + 0.5) / s - 0.5;
    const double w = 1.0 + d;
    a.taps[p][0] = d >= 0.0 ? 0.0f : static_cast<float>(1.0 - w);
    a.taps[p][1] = d >= 0.0 ? static_cast<float>(1.0 - d) : static_cast<float>(w);
    a.taps[p][2] = d >= 0.0 ? static_cast<float>(d) : 0.0f;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((Co + 31) / 32) {
    case 1: return launch<1, kBf16>(a, B, st);
    case 2: return launch<2, kBf16>(a, B, st);
    case 3: return launch<3, kBf16>(a, B, st);
    case 4: return launch<4, kBf16>(a, B, st);
    case 5: return launch<5, kBf16>(a, B, st);
    case 6: return launch<6, kBf16>(a, B, st);
    case 7: return launch<7, kBf16>(a, B, st);
    case 8: return launch<8, kBf16>(a, B, st);
    case 9: case 10: return launch<10, kBf16>(a, B, st);    // 320
    case 11: case 12: return launch<12, kBf16>(a, B, st);   // 384
    case 13: case 14: return launch<14, kBf16>(a, B, st);   // 448
    default: return launch<16, kBf16>(a, B, st);            // 512
  }
}

}  // namespace

// x: (B, T, Ci), 1 <= Ci <= 1024; w_hi: (Cp, Ci4), the conv weight in its
// nn.Linear layout with Co zero-padded to Cp = Co rounded up to 32 and rows
// to Ci4 = Ci rounded up to 4 (w_lo: null, or its TF32 lo when the kernel is
// built pre-split); bias: (Cp); norm_w / norm_b: (Cp), both null for no
// norm, padded with zeros; out: (B, T s, Co), 1 <= Co <= 512. All fp32 and
// contiguous, w and the norm 16-byte aligned; 1 <= s <= 16. Returns the CUDA
// error code (invalid value for a shape it does not take).
extern "C" int l3ac_up_fused_tc(const float* x, const float* w_hi, const float* w_lo,
                                const float* bias, const float* norm_w, const float* norm_b,
                                float* out, int B, int Ci, int Co, int T, int s, void* stream) {
  return run<false>(Args{x, w_hi, w_lo, bias, norm_w, norm_b, out, Ci, Co, T, s, 0, 0, 0, {}},
                    B, stream);
}

// The same in bf16: x, out, w (Cp, Ci8 = Ci rounded up to 8), bias and the
// norm bf16 (up_fused.py:prepare_up of a bf16 weight set); w 16-byte and the
// norm 8-byte aligned.
extern "C" int l3ac_up_fused_tc_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                     const __nv_bfloat16* bias, const __nv_bfloat16* norm_w,
                                     const __nv_bfloat16* norm_b, __nv_bfloat16* out, int B,
                                     int Ci, int Co, int T, int s, void* stream) {
  return run<true>(Args{x, w, nullptr, bias, norm_w, norm_b, out, Ci, Co, T, s, 0, 0, 0, {}},
                   B, stream);
}
