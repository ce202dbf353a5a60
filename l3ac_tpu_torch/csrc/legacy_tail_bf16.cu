// The decoder's legacy tail on bf16 as one kernel, audio out:
//   3 x [x + conv1x1(snake(conv_k7,dil d(snake x)))], d = 1, 3, 9
//   -> snake -> conv k7 C -> 1 -> tanh
// with every conv zero-padded at the sequence edges (the residual stream is
// zeroed outside [0, T) after every unit), the products one bf16
// tensor-core pass: the bf16 variant of legacy_tail.cu, designed for the
// H100.
//
// Replaces l3ac_tpu/ops/pallas/legacy_tail.py:legacy_tail_poly_ct (body
// _kernel_poly, input = the two stride-2 phase arrays of the last up path)
// and :legacy_tail_ct (body _kernel, one interleaved (B, C, T) input) on bf16
// activations: one kernel, two input modes (x1 null: interleaved). It rounds
// where legacy_tail.py:_kernel / _kernel_poly do: the snakes in fp32, each
// rounded to bf16; the k7 conv's fp32 sum + b1 rounded; the 1x1's sum + b2
// rounded; the residual x + h rounded to bf16 after every unit, so the
// stream in registers holds bf16 values; the output conv and tanh in fp32,
// the audio rounded once.
//
// Bound on the H100: per sample 3 x (7 C^2 + C^2) MACs, 27.6 k operations at
// C = 24, one bf16 pass at 989 TFLOP/s: ~0.04 ms per 8 x 10 s decode (1.28 M
// samples); the 7 C snakes per sample (sin2_ilp and a Newton quotient, 22
// instructions each) ~0.14 ms at the SMs' issue rate of one warp
// instruction per scheduler per clock, 0.15 with the adds and the output
// conv (chip_smoke.py snake_bound_ms). The former design (the
// fp32 design with bf16 values: a TF32 hi / lo layout, fp32 activations,
// k8 products, library sinf) ran at 1.37 ms, its sines 0.71 and its
// products 0.64 (tools/tail_variants.py --bf16). This one runs at 0.60 ms;
// the same tool puts its products (with the snakes the compiler then folds)
// at 0.32, the input and output at 0.14, the SIMT output conv at 0.035
// (PERF.md §6): the snakes' fp32 issue and the mma.sync products bound it.
//
// Design: time is the M axis of every product.
//   - A persistent grid, one block of 16 warps per SM, walks tiles of kS =
//     1452 output samples of one batch row with a 42-sample halo per side
//     (3 (1 + 3 + 9) + 3): kW = 1536 rows, 6 slabs of 16 per warp, a 5.5 %
//     halo (the former design's 768-row tiles: 12 %).
//   - Shared memory holds every weight, staged once per block by cp.async
//     from the prepared buffer (legacy_tail.py:pack_bf16: bf16, each lane's
//     B fragments of two n8 tiles in 16 contiguous bytes; the vectors fp32),
//     42 KB at C = 24, and one bf16 time-major activation buffer A (kW + 2 x
//     27 rows, rows of an odd number of 16-byte pieces: conflict-free
//     ldmatrix): 119 KB in all.
//   - The input is loaded into A in interleaved time order whichever mode it
//     has (phase mode reads x_{g & 1}[g >> 1]), zero outside [0, T).
//   - Each warp keeps its slabs' residual stream in registers as bf16 pairs
//     in the mma accumulator layout. Per unit it writes snake(x) into A at
//     its own positions; after a barrier the dilated k7 conv is one product
//     per slab over K = 7 x (C rounded up to 8), the taps folded into K:
//     ldmatrix takes each 8-column piece of the A operand from its tap's
//     shifted row (the im2col is a row address per lane), so the product
//     runs m16n8k16 with one fp32 accumulator. b1, the rounding and the
//     snake are applied to the accumulator in registers, which then is the
//     1x1's A operand (C fragment -> A fragment, no shared memory); the
//     1x1's output lands in the residual's own layout. A second barrier ends
//     the unit.
//   - The final snake goes to A, and the k7 conv C -> 1 (7 C MACs a sample)
//     and tanh run SIMT, one thread per sample (8 bf16 a load); only the
//     audio (B, T) is written, once.
//   - Snakes: sin2_ilp and the Newton quotient on the prepared reciprocal
//     (common.cuh), a slab's 4 kC8 values at a time: no branch per value.
// Widths (C a multiple of 4 up to 64): up to C = 24 as above; from C = 28
// on the matrices stay in device memory and each lane reads its 16-byte
// fragments there (a warp reads 512 contiguous bytes), only the vectors are
// staged, and a block is 8 warps of 2 slabs (256 working rows, 172 output
// samples a tile), so that the residual stream and the accumulators stay in
// registers.
#include "common.cuh"
#include "ptx.cuh"

namespace {

namespace ptx = l3ac::ptx;
using bf16 = __nv_bfloat16;

constexpr int kHalo = 42;   // 3 (1 + 3 + 9) + 3
constexpr int kPad = 27;    // zero rows on each side: 3 x the largest dilation
constexpr int kUnits = 3;
constexpr int kTaps = 7;
constexpr int kBatch = 12;  // input loads in flight per thread
constexpr int kMaxNarrowC8 = 3;  // C <= 24: every weight in shared memory
constexpr int kMaxC8 = 8;        // C <= 64

// The prepared buffer (legacy_tail.py:pack_bf16) in 16-byte units, then the
// fp32 vectors' offsets in floats from its vector part. kC8 n8 tiles of
// channels, kP pairs of them (and k16 steps of the 1x1), kJ1 k16 steps of
// the folded k7 conv (K = 7 x 8 kC8, zero-filled to 16).
template <int kC8>
struct Layout {
  static constexpr int kP = (kC8 + 1) / 2;
  static constexpr int kJ1 = (kTaps * kC8 + 1) / 2;
  static constexpr int Cp = 8 * kC8;
  static constexpr int w1 = 0;                            // (3, kJ1, kP, 32 lanes)
  static constexpr int w2 = kUnits * kJ1 * kP * 32;       // (3, kP, kP, 32 lanes)
  static constexpr int vec = w2 + kUnits * kP * kP * 32;
  static constexpr int weights = vec + (27 * Cp + 4) / 4;
  // floats from vec: (3, Cp) b1, a1, r1, a2, r2, b2; ao, ro (Cp); wo (7, Cp); bo
  static constexpr int b1 = 0, a1 = 3 * Cp, r1 = 6 * Cp, a2 = 9 * Cp, r2 = 12 * Cp,
                       b2 = 15 * Cp, ao = 18 * Cp, ro = 19 * Cp, wo = 20 * Cp, bo = 27 * Cp;
  static constexpr int AS = 16 * (kC8 % 2 ? kC8 : kC8 + 1);  // bytes per row of A
};

// The narrow widths keep every weight in shared memory and give each of 16
// warps 6 slabs; the wide ones read the matrices from device memory (L2) and
// give each of 8 warps 2 slabs.
template <bool kWide>
struct Tiling {
  static constexpr int kWarps = kWide ? 8 : 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSlabs = kWide ? 2 : 6;
  static constexpr int kW = 16 * kSlabs * kWarps;  // working rows per tile
  static constexpr int kS = kW - 2 * kHalo;        // output samples per tile
};

struct Args {
  const bf16* x0;    // (B, C, T) interleaved, or the even phase (B, C, T / 2)
  const bf16* x1;    // null, or the odd phase
  const uint4* wts;  // the prepared buffer
  bf16* out;         // (B, T)
  int B, C, T;
  long long xB, xC;  // batch and channel strides of x0 and x1
};

__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// kN values snaked in place: alpha and 1 / (alpha + eps) per value
template <int kN>
__device__ __forceinline__ void snake_r(float (&y)[kN], const float (&al)[kN],
                                        const float (&rc)[kN]) {
  float d[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) d[i] = al[i] + l3ac::kSnakeEps;
  l3ac::snake2_ilp(y, al, d, rc);
}

template <int kC8, bool kWide>
__global__ void __launch_bounds__(Tiling<kWide>::kThreads, 1)
    legacy_tail_bf16_kernel(const Args a) {
  using L = Layout<kC8>;
  using G = Tiling<kWide>;
  constexpr int kThreads = G::kThreads, kWarps = G::kWarps, kSlabs = G::kSlabs;
  constexpr int kW = G::kW, kS = G::kS, kP = L::kP, kJ1 = L::kJ1, AS = L::AS;
  // shared memory: the whole buffer (narrow) or its vectors (wide), then A
  constexpr int kStaged = kWide ? L::weights - L::vec : L::weights;
  extern __shared__ __align__(16) uint4 smem[];
  const uint4* w1f = (kWide ? a.wts : smem) + L::w1;
  const uint4* w2f = (kWide ? a.wts : smem) + L::w2;
  const float* vec = reinterpret_cast<const float*>(smem + (kWide ? 0 : L::vec));
  unsigned char* A = reinterpret_cast<unsigned char*>(smem + kStaged);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q8 = lane >> 3, r8 = lane & 7, g = lane >> 2, t = lane & 3;
  const int C = a.C, T = a.T;

  for (int e = tid; e < kStaged; e += kThreads)
    ptx::cp_async16(smem + e, a.wts + (kWide ? L::vec : 0) + e, 16);
  ptx::cp_async_commit();
  for (int e = tid; e < (kW + 2 * kPad) * AS / 16; e += kThreads)
    reinterpret_cast<uint4*>(A)[e] = make_uint4(0, 0, 0, 0);
  ptx::cp_async_wait<0>();

  auto at = [&](int row, int c) { return reinterpret_cast<bf16*>(A + row * AS) + c; };
  const int tiles_per_row = (T + kS - 1) / kS;
  for (int tile = blockIdx.x; tile < a.B * tiles_per_row; tile += gridDim.x) {
    const int b = tile / tiles_per_row;
    const long long g0 = static_cast<long long>(tile - b * tiles_per_row) * kS - kHalo;
    __syncthreads();  // the weights have landed; the last tile's reads of A are done

    // x -> A (time-major), zero outside [0, T); channels past C stay zero
    {
      const bf16* xb0 = a.x0 + b * a.xB;
      const bf16* xb1 = a.x1 == nullptr ? nullptr : a.x1 + b * a.xB;
      const int n = C * kW;
      for (int e0 = tid; e0 < n; e0 += kBatch * kThreads) {
        bf16 v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kThreads, c = e / kW;
          const long long tt = g0 + (e - c * kW);
          v[u] = __float2bfloat16_rn(0.0f);
          if (e < n && tt >= 0 && tt < T)
            v[u] = xb1 == nullptr ? xb0[c * a.xC + tt]
                                  : ((tt & 1) ? xb1 : xb0)[c * a.xC + (tt >> 1)];
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kThreads, c = e / kW;
          if (e < n) *at(kPad + e - c * kW, c) = v[u];
        }
      }
    }
    __syncthreads();

    // the residual stream of this warp's slabs as bf16 pairs: xr[s][n][r] is
    // row g + 8 r of slab s, channels 8 n + 2 t (+1); rows outside [0, T)
    // are zero
    uint32_t xr[kSlabs][kC8][2];
#pragma unroll
    for (int s = 0; s < kSlabs; ++s)
#pragma unroll
      for (int n = 0; n < kC8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          xr[s][n][r] = *reinterpret_cast<const uint32_t*>(
              at(kPad + 16 * (warp + kWarps * s) + g + 8 * r, 8 * n + 2 * t));
    auto valid = [&](int s, int r) {
      const long long tt = g0 + 16 * (warp + kWarps * s) + g + 8 * r;
      return tt >= 0 && tt < T;
    };

    // A = bf16(snake(residual)) at this lane's own positions, zero past C
    auto write_snake = [&](const float* alpha, const float* recip) {
#pragma unroll
      for (int s = 0; s < kSlabs; ++s) {
        const int row = kPad + 16 * (warp + kWarps * s) + g;
        float y[4 * kC8], al[4 * kC8], rc[4 * kC8];  // value 4 n + 2 r + e
#pragma unroll
        for (int i = 0; i < 4 * kC8; ++i) {
          const int n = i >> 2, r = (i >> 1) & 1, e = i & 1, c = 8 * n + 2 * t + e;
          y[i] = e ? hi_f(xr[s][n][r]) : lo_f(xr[s][n][r]);
          al[i] = alpha[c];
          rc[i] = recip[c];
        }
        snake_r(y, al, rc);
#pragma unroll
        for (int n = 0; n < kC8; ++n) {
          const int c = 8 * n + 2 * t;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<uint32_t*>(at(row + 8 * r, c)) = ptx::bf16x2_rn(
                c < C ? y[4 * n + 2 * r] : 0.0f, c + 1 < C ? y[4 * n + 2 * r + 1] : 0.0f);
        }
      }
    };

    // per lane: the A-operand row of its ldmatrix piece (rows (q8 & 1) 8 +
    // r8 of a slab), and which k8 piece of a k16 step it addresses (q8 >> 1)
    const int arow = (q8 & 1) * 8 + r8, khalf = q8 >> 1;
#pragma unroll 1
    for (int u = 0; u < kUnits; ++u) {
      const int d = u == 0 ? 1 : (u == 1 ? 3 : 9);
      write_snake(vec + L::a1 + u * L::Cp, vec + L::r1 + u * L::Cp);
      __syncthreads();
      const float* b1 = vec + L::b1 + u * L::Cp;
      const float* a2 = vec + L::a2 + u * L::Cp;
      const float* r2 = vec + L::r2 + u * L::Cp;
      const float* b2 = vec + L::b2 + u * L::Cp;
      const uint4* w1u = w1f + u * kJ1 * kP * 32 + lane;
      const uint4* w2u = w2f + u * kP * kP * 32 + lane;
#pragma unroll
      for (int s = 0; s < kSlabs; ++s) {  // unrolled: xr stays in registers
        const unsigned char* pa = A + (kPad + 16 * (warp + kWarps * s) + arow) * AS;
        // the k7 conv, taps folded into K: k8 piece m = 2 j + khalf is tap
        // m / kC8, channels 8 (m % kC8) ..; the pad piece past 7 kC8 reads
        // the row itself against zero weights
        float conv[kC8][4];
#pragma unroll
        for (int n = 0; n < kC8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) conv[n][i] = 0.0f;
#pragma unroll
        for (int j = 0; j < kJ1; ++j) {
          const int m = 2 * j + khalf;
          const int tap = m < kTaps * kC8 ? m / kC8 : 3, cg = m < kTaps * kC8 ? m % kC8 : 0;
          uint32_t af[4];
          ptx::ldmatrix_x4(af, pa + (tap - 3) * d * AS + 16 * cg);
#pragma unroll
          for (int p = 0; p < kP; ++p) {
            const uint4 w = kWide ? __ldg(w1u + (j * kP + p) * 32) : w1u[(j * kP + p) * 32];
            const uint32_t b0[2] = {w.x, w.y}, bb[2] = {w.z, w.w};
            ptx::mma_bf16(conv[2 * p], af, b0);
            if (2 * p + 1 < kC8) ptx::mma_bf16(conv[2 * p + 1], af, bb);
          }
        }
        // bf16(conv + b1), then bf16(snake): the 1x1's A fragments; conv[n][i]
        // is row g + 8 (i >> 1), channel 8 n + 2 t + (i & 1)
        float y[4 * kC8], al[4 * kC8], rc[4 * kC8];
#pragma unroll
        for (int i = 0; i < 4 * kC8; ++i) {
          const int c = 8 * (i >> 2) + 2 * t + (i & 1);
          y[i] = l3ac::round_bf16(conv[i >> 2][i & 3] + b1[c]);
          al[i] = a2[c];
          rc[i] = r2[c];
        }
        snake_r(y, al, rc);
        // n8 tile n is half n & 1 of k16 step n >> 1: a{0,1} or a{2,3}
        uint32_t hf[kP][4];
#pragma unroll
        for (int n = 0; n < 2 * kP; ++n) {
          const int m = n < kC8 ? n : 0, c = 8 * n + 2 * t;  // tile kC8 (odd kC8) is zero
#pragma unroll
          for (int r = 0; r < 2; ++r)
            hf[n >> 1][2 * (n & 1) + r] = ptx::bf16x2_rn(
                c < C ? y[4 * m + 2 * r] : 0.0f, c + 1 < C ? y[4 * m + 2 * r + 1] : 0.0f);
        }
        float sum2[kC8][4];
#pragma unroll
        for (int n = 0; n < kC8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) sum2[n][i] = 0.0f;
#pragma unroll
        for (int j = 0; j < kP; ++j)
#pragma unroll
          for (int p = 0; p < kP; ++p) {
            const uint4 w = kWide ? __ldg(w2u + (j * kP + p) * 32) : w2u[(j * kP + p) * 32];
            const uint32_t b0[2] = {w.x, w.y}, bb[2] = {w.z, w.w};
            ptx::mma_bf16(sum2[2 * p], hf[j], b0);
            if (2 * p + 1 < kC8) ptx::mma_bf16(sum2[2 * p + 1], hf[j], bb);
          }
        // the residual, zero outside [0, T): bf16(x + bf16(sum + b2))
#pragma unroll
        for (int n = 0; n < kC8; ++n) {
          const int c = 8 * n + 2 * t;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const bool ok = valid(s, r);
            const float v0 = lo_f(xr[s][n][r]) + l3ac::round_bf16(sum2[n][2 * r] + b2[c]);
            const float v1 = hi_f(xr[s][n][r]) + l3ac::round_bf16(sum2[n][2 * r + 1] + b2[c + 1]);
            xr[s][n][r] = ok ? ptx::bf16x2_rn(v0, v1) : 0u;
          }
        }
      }
      __syncthreads();  // every read of A is done before it is rewritten
    }

    // snake -> conv k7 C -> 1 -> tanh, one thread per output sample
    write_snake(vec + L::ao, vec + L::ro);
    __syncthreads();
    const float* wo = vec + L::wo;
    bf16* ob = a.out + static_cast<long long>(b) * T;
    for (int j = tid; j < kS; j += kThreads) {
      const long long tt = g0 + kHalo + j;
      if (tt >= T) break;
      float yv = vec[L::bo];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const unsigned char* ar = A + (kPad + kHalo + j + k - 3) * AS;
#pragma unroll
        for (int c = 0; c < L::Cp; c += 8) {
          const uint4 av = *reinterpret_cast<const uint4*>(ar + 2 * c);
          const float4 w0 = *reinterpret_cast<const float4*>(wo + k * L::Cp + c);
          const float4 w1 = *reinterpret_cast<const float4*>(wo + k * L::Cp + c + 4);
          yv += w0.x * lo_f(av.x);
          yv += w0.y * hi_f(av.x);
          yv += w0.z * lo_f(av.y);
          yv += w0.w * hi_f(av.y);
          yv += w1.x * lo_f(av.z);
          yv += w1.y * hi_f(av.z);
          yv += w1.z * lo_f(av.w);
          yv += w1.w * hi_f(av.w);
        }
      }
      ob[tt] = __float2bfloat16_rn(tanhf(yv));
    }
  }
}

template <int kC8>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Layout<kC8>;
  constexpr bool kWide = kC8 > kMaxNarrowC8;
  using G = Tiling<kWide>;
  const size_t smem = 16 * static_cast<size_t>(kWide ? L::weights - L::vec : L::weights) +
                      static_cast<size_t>(G::kW + 2 * kPad) * L::AS;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(legacy_tail_bf16_kernel<kC8, kWide>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, legacy_tail_bf16_kernel<kC8, kWide>, G::kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = static_cast<long long>(a.B) * l3ac::ceil_div(a.T, G::kS);
  const int grid = static_cast<int>(tiles < sms * per_sm ? tiles : sms * per_sm);
  legacy_tail_bf16_kernel<kC8, kWide><<<grid, G::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x0 (and x1): bf16 (B, C, T) interleaved with x1 null, or the phase pair
// (B, C, T / 2) with x[2t + q] = x_q[t]; xB, xC their batch and channel
// strides (time contiguous). wts: legacy_tail.py:pack_bf16 of the bf16
// weights, 16-byte aligned (the wrapper checks its size). out: (B, T) bf16.
// C a multiple of 4 up to 64. Returns the CUDA error code.
extern "C" int l3ac_legacy_tail_bf16(const __nv_bfloat16* x0, const __nv_bfloat16* x1,
                                     const void* wts, __nv_bfloat16* out, int B, int C, int T,
                                     long long xB, long long xC, void* stream) {
  if (B < 1 || T < 1 || (x1 != nullptr && T % 2 != 0) ||
      reinterpret_cast<uintptr_t>(wts) % 16 != 0 || C < 4 || C > 8 * kMaxC8 || C % 4 != 0)
    return cudaErrorInvalidValue;
  const Args a{x0, x1, static_cast<const uint4*>(wts), out, B, C, T, xB, xC};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((C + 7) / 8) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 3: return launch<3>(a, s);
    case 4: return launch<4>(a, s);
    case 5: return launch<5>(a, s);
    case 6: return launch<6>(a, s);
    case 7: return launch<7>(a, s);
    default: return launch<8>(a, s);
  }
}
