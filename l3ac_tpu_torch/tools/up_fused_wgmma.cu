// A second design of csrc/up_fused_tc.cu, kept for measurement only: the same
// up path with the 1x1 conv on Hopper's warpgroup mma (wgmma m64nNk8 TF32,
// asynchronous, 3 passes) instead of mma.sync. x is A, loaded by ldmatrix
// into each warp's registers and split into TF32 hi / lo there; W, split
// once into hi and lo by the caller (w_hi, w_lo: tc_gemm.py:split_tf32 of the
// (Co, Ci) weight), is B, read by the wgmma from shared memory through
// descriptors (K-major core matrices of 8 rows x 16 bytes, no swizzle). One
// block of 64 z rows and all Co columns, Co / 128 warpgroups (at least one)
// splitting the columns; each K step of 32 is one group of 12 wgmma into a
// fresh accumulator, waited for before its sum. The epilogue is the
// kernel's. It is right on the card and slower than the mma.sync kernel
// (PERF.md); l3ac_tpu_torch/tools/up_variants.py builds and times it, the
// codec does not build or call it. Co: 32, 64, 96, 128, 192, 256.
#include "common.cuh"
#include "ptx.cuh"

namespace {

namespace ptx = l3ac::ptx;

constexpr int kBK = 32;               // K step, one fresh accumulator each
constexpr int kRow = kBK + 4;         // shared row stride of the x tiles
constexpr int kStages = 3;            // cp.async ring
constexpr int kMaxScale = 16;
constexpr float kNormEps = 1e-8f;

struct Args {
  const float* x;       // (B, T, Ci)
  const float* w_hi;    // (Co, Ci): W's TF32 hi
  const float* w_lo;    // (Co, Ci): W's TF32 lo
  const float* bias;    // (Co)
  const float* norm_w;  // (Co) or null: no norm
  const float* norm_b;  // (Co) or null
  float* out;           // (B, T s, Co)
  int Ci, Co, T, s;
  float taps[kMaxScale][3];  // per phase: w_prev, w_cur, w_next
};

// kWG warpgroups of N columns each: Co = kWG N
template <int kWG, int kN>
struct Tile {
  static constexpr int kCo = kWG * kN;
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kRows = 64;              // z rows per block: one warpgroup's M
  static constexpr int kOwn = kRows - 2;        // rows it stores
  static constexpr int kZS = kCo + 4;           // row stride of z in shared memory
  static constexpr int kSlots = (kCo + 127) / 128;  // float4 slots per lane in a row
  // a ring stage: x (kRows rows of kRow floats), then W hi and lo, each as
  // (kCo / 8) x (kBK / 4) core matrices of 8 rows x 4 floats
  static constexpr int kW = kCo * kBK;
  static constexpr int kStage = kRows * kRow + 2 * kW;
  static constexpr int kRing = kStages * kStage;
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

template <int kSlots>
__device__ __forceinline__ void center(float4 (&v)[kSlots], float m) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) v[k] = make_float4(v[k].x - m, v[k].y - m, v[k].z - m, v[k].w - m);
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

template <int kWG, int kN>
__global__ void __launch_bounds__(Tile<kWG, kN>::kThreads, 1) up_fused_tc_kernel(const Args a) {
  using G = Tile<kWG, kN>;
  extern __shared__ __align__(16) float smem[];
  __shared__ float taps[kMaxScale * 3];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wr = warp & 3;  // warpgroup (column block), 16-row slice
  if (tid == 0) {  // constant indices: the parameter array is never indexed at run time
#pragma unroll
    for (int e = 0; e < kMaxScale * 3; ++e) taps[e] = a.taps[e / 3][e % 3];
  }
  const int Ci = a.Ci, T = a.T;
  const int t0 = blockIdx.x * G::kOwn;  // first owned row; z row i is t0 - 1 + i
  const long long b = blockIdx.y;
  const float* xb = a.x + b * T * static_cast<long long>(Ci);
  const int steps = (Ci + kBK - 1) / kBK;

  // rows of x (clamped into [0, T)) and W hi / lo, K columns [32 s, 32 s + 32),
  // into stage s; a 16-byte piece of W row o, columns 4 j .. 4 j + 3 is row
  // o % 8 of core matrix (o / 8, j)
  auto stage_in = [&](int s) {
    float* st = smem + (s % kStages) * G::kStage;
    const int k0 = s * kBK;
    for (int e = tid; e < G::kRows * (kBK / 4); e += G::kThreads) {
      const int row = e / (kBK / 4), col = (e % (kBK / 4)) * 4;
      int t = t0 - 1 + row;
      t = t < 0 ? 0 : (t >= T ? T - 1 : t);
      const bool ok = k0 + col < Ci;
      ptx::cp_async16(st + row * kRow + col,
                      ok ? xb + static_cast<long long>(t) * Ci + k0 + col : a.x, ok ? 16 : 0);
    }
    for (int e = tid; e < 2 * G::kCo * (kBK / 4); e += G::kThreads) {
      const int hl = e / (G::kCo * (kBK / 4)), rem = e % (G::kCo * (kBK / 4));
      const int o = rem / (kBK / 4), j = rem % (kBK / 4);
      const bool ok = k0 + 4 * j < Ci;
      const float* src = hl ? a.w_lo : a.w_hi;
      ptx::cp_async16(st + G::kRows * kRow + hl * G::kW + ((o >> 3) * (kBK / 4) + j) * 32 +
                          (o & 7) * 4,
                      ok ? src + static_cast<long long>(o) * Ci + k0 + 4 * j : src, ok ? 16 : 0);
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) stage_in(s);
    ptx::cp_async_commit();
  }

  float sum[kN / 2], acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) sum[i] = 0.0f;

  // ldmatrix rows of the warp's 16-row A slice: tiles q = (rows 0-7 | 8-15) x
  // (k 0-3 | 4-7), q & 1 the row half
  const int q = lane >> 3, r = lane & 7;
  const int oa = (wr * 16 + (q & 1) * 8 + r) * kRow + (q >> 1) * 4;
  // this warpgroup's columns: core matrices (kN / 8) x (kBK / 4) from n8 block
  // wg kN / 8; K-adjacent ones 128 bytes apart, N-adjacent ones kBK / 4 x 128
  constexpr uint32_t kLbo = 128, kSbo = (kBK / 4) * 128;

  for (int s = 0; s < steps; ++s) {
    ptx::cp_async_wait<kStages - 2>();  // this thread's copies of step s have landed
    ptx::fence_proxy_async();           // ... and are visible to the wgmma
    __syncthreads();                    // ... for every thread; stage (s - 1) is free
    if (s + kStages - 1 < steps) stage_in(s + kStages - 1);
    ptx::cp_async_commit();

    const float* st = smem + (s % kStages) * G::kStage;
    uint32_t hi[kBK / 8][4], lo[kBK / 8][4];
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      uint32_t raw[4];
      ptx::ldmatrix_x4(raw, st + oa + ks * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) split(raw[i], hi[ks][i], lo[ks][i]);
    }
    const float* wh = st + G::kRows * kRow + wg * (kN / 8) * (kBK / 4) * 32;
    ptx::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {  // small terms first; the first starts acc afresh
      const uint64_t dh = ptx::wgmma_desc(wh + ks * 2 * 32, kLbo, kSbo);
      const uint64_t dl = ptx::wgmma_desc(wh + G::kW + ks * 2 * 32, kLbo, kSbo);
      ptx::wgmma_tf32<kN>(acc, lo[ks], dh, ks > 0);
      ptx::wgmma_tf32<kN>(acc, hi[ks], dl, 1);
      ptx::wgmma_tf32<kN>(acc, hi[ks], dh, 1);
    }
    ptx::wgmma_commit();
    ptx::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) sum[i] += acc[i];
  }
  ptx::cp_async_wait<0>();
  __syncthreads();  // the ring is dead: z takes its place

  // z + b into shared memory, (kRows, kZS); thread (warp wr of its group,
  // lane 4 g + t) holds rows 16 wr + g (+ 8), columns 8 j + 2 t (+ 1) of its
  // group's kN
  float* zs = smem;
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int o = wg * kN + 8 * j + 2 * t;
      const float b0 = __ldg(a.bias + o), b1 = __ldg(a.bias + o + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(zs + (wr * 16 + g + 8 * h) * G::kZS + o) =
            make_float2(sum[4 * j + 2 * h] + b0, sum[4 * j + 2 * h + 1] + b1);
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
      for (int j = 0; j < 3; ++j) m[j] /= G::kCo;
      center(z0, m[0]);
      center(z1, m[1]);
      center(z2, m[2]);
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
      prm[2 * e + 1] = 1.0f / sqrtf(fmaxf(q, 0.0f) / G::kCo + kNormEps);
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
      nw[k] = __ldg(reinterpret_cast<const float4*>(a.norm_w + o));
      nb[k] = __ldg(reinterpret_cast<const float4*>(a.norm_b + o));
    }
  }
  for (int i = 1 + warp; i < G::kRows - 1; i += G::kWarps) {
    const int t = t0 - 1 + i;
    if (t >= T) break;
    float4 zp[G::kSlots], zc[G::kSlots], zn[G::kSlots];
    load_row<G::kSlots, G::kCo, G::kZS>(zp, zs, i - 1, lane);
    load_row<G::kSlots, G::kCo, G::kZS>(zc, zs, i, lane);
    load_row<G::kSlots, G::kCo, G::kZS>(zn, zs, i + 1, lane);
    float* orow = a.out + ((b * T + t) * a.s) * static_cast<long long>(G::kCo);
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
        if (o < G::kCo) *reinterpret_cast<float4*>(orow + p * G::kCo + o) = v;
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int kWG, int kN>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  using G = Tile<kWG, kN>;
  constexpr size_t smem = sizeof(float) * static_cast<size_t>(G::kFloats);
  static_assert(smem <= 227 * 1024, "shared memory");
  auto kernel = up_fused_tc_kernel<kWG, kN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(l3ac::ceil_div(a.T, G::kOwn), B);
  kernel<<<grid, G::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: (B, T, Ci) with Ci a multiple of 4; w_hi / w_lo: (Co, Ci), the conv
// weight in its nn.Linear layout split into TF32 hi and lo
// (ops/kernels/tc_gemm.py:split_tf32), Co one of 32, 64, 96, 128, 192, 256;
// bias: (Co); norm_w / norm_b: (Co), both null for no norm; out: (B, T s, Co).
// All fp32 and contiguous, x, w and the norm 16-byte aligned; 1 <= s <= 16.
// Returns the CUDA error code (invalid value for a shape it does not take).
extern "C" int l3ac_up_fused_tc(const float* x, const float* w_hi, const float* w_lo,
                                const float* bias, const float* norm_w, const float* norm_b,
                                float* out, int B, int Ci, int Co, int T, int s, void* stream) {
  if (B < 1 || B > 65535 || Ci < 4 || Ci % 4 != 0 || T < 1 || s < 1 || s > kMaxScale ||
      !aligned16(x) || !aligned16(w_hi) || !aligned16(w_lo) ||
      (norm_w == nullptr) != (norm_b == nullptr) ||
      (norm_w != nullptr && (!aligned16(norm_w) || !aligned16(norm_b))) ||
      static_cast<long long>(T) * s * Co >= (1LL << 40))
    return cudaErrorInvalidValue;
  Args a{x, w_hi, w_lo, bias, norm_w, norm_b, out, Ci, Co, T, s, {}};
  for (int p = 0; p < s; ++p) {  // ops/resample.py:phase_weights, in double
    const double d = (p + 0.5) / s - 0.5;
    const double w = 1.0 + d;
    a.taps[p][0] = d >= 0.0 ? 0.0f : static_cast<float>(1.0 - w);
    a.taps[p][1] = d >= 0.0 ? static_cast<float>(1.0 - d) : static_cast<float>(w);
    a.taps[p][2] = d >= 0.0 ? static_cast<float>(d) : 0.0f;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Co) {
    case 32: return launch<1, 32>(a, B, st);
    case 64: return launch<1, 64>(a, B, st);
    case 96: return launch<1, 96>(a, B, st);
    case 128: return launch<1, 128>(a, B, st);
    case 192: return launch<2, 96>(a, B, st);
    case 256: return launch<2, 128>(a, B, st);
    default: return cudaErrorInvalidValue;
  }
}
