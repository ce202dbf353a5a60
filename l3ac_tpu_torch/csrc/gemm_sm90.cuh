// bf16 GEMM on Hopper's asynchronous tensor cores, shared by conv_unit_tc.cu
// (the two products of the bf16 ConvUnit on (B, T, C)) and int8_matmul.cu
// (int8 weights on bf16 x):
//   C[M, N] = epilogue(A[M, K] . B[N, K]^T)
// A bf16 K-major; B bf16 K-major (nn.Linear layout), or int8 with an fp32
// row scale, dequantized per tile as bf16(fp32(q) * s[n]) (the rounding of
// l3ac_tpu/ops/pallas/int8_matmul.py:37-38). Sums in fp32, one rounding of
// the output to bf16. Epilogues (finish<>): y = acc + b, snake(acc + b,
// alpha), exact GELU(acc + b), res + (acc + b) (the residual bf16, added in
// fp32 before the rounding); an int8 layer's bias is bf16, added in fp32.
//
// TPU kernels served: l3ac_tpu/ops/pallas/conv_unit.py:260 (conv_unit, body
// _kernel: pw1 and pw2 with the bf16 roundings at :73,85,88) and
// l3ac_tpu/ops/pallas/int8_matmul.py:44 (int8_matmul on bf16 x).
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): 2 M N K operations
// against 2 (M K + M N) + N K (or 2 N K) bytes. At the ConvUnit shapes
// (M = 14232 / 71160, K and N 192-2048) that is 100-690 operations per byte,
// above the card's 295: the tensor cores bound them. The int8 layers of the
// transformer (K = 128-341, N = 128-682) sit at 60-110 operations per byte:
// bytes bound them. So the design feeds wgmma at full rate and keeps every
// byte of A and B to one read:
//   - Products: wgmma.mma_async m64nNk16, both operands from shared memory
//     through 128-byte-swizzle descriptors, K tile 64 (one swizzle row). The
//     accumulator runs across the whole of K; one wgmma group stays in
//     flight (wgmma_wait<1>) while the stage before it is released.
//   - Loads: warpgroup 0 is the producer (setmaxnreg gives its registers to
//     the consumers). Its first thread issues TMA 2-D tile loads into a ring
//     of kStages stages with full / empty mbarriers; rows past M or N and K
//     past its end arrive as zeros (TMA's out-of-bounds fill), so a ragged M
//     is clipped, never padded in a copy. Tensor maps: the weights' built
//     once by the caller and kept with the prepared weights, the
//     activations' encoded per call on the host (cuTensorMapEncodeTiled
//     through cudaGetDriverEntryPoint, so no -lcuda).
//   - Shapes TMA cannot take (a row stride that is no multiple of 16 bytes:
//     bf16 K % 8 != 0, int8 K % 16 != 0, or a base not 16-byte aligned, as
//     the transformer's GEGLU w2 at K = 341) take the cp.async route: the
//     whole producer warpgroup copies into the same swizzled layout with
//     zero fill (16-byte copies where rows allow, else element loads).
//     route_for in ops/kernels/gemm_sm90.py is the one rule; the launch
//     refuses a TMA route the shape does not admit.
//   - int8 B, design (a): TMA brings the int8 tile into a staging buffer
//     and producer warps 1-3 widen it into the swizzled bf16 B stage (byte
//     permutes into the mantissa of 2^23, not the quarter-rate I2F; all of a
//     thread's chunks loaded before any is widened). Chosen over (b), the
//     operands swapped with the weight as wgmma's register A operand,
//     because (a) keeps one consumer code path for both B types and the
//     weight in device memory int8; the widening uses the producer's
//     otherwise idle warps. It is the int8 path's limit (PERF.md).
//   - Epilogue overlap: a persistent grid (one block per SM walks the output
//     tiles, N fastest, so the next tile's stages load during this tile's
//     epilogue), and the two consumer warpgroups either share a 128-row
//     tile (kCoop) or ping-pong: each takes its own tiles of 64 kMB rows in
//     turn, their mainloops ordered by two named barriers, so one group's
//     epilogue runs while the other's products do. tools/tc_variants.py
//     measured the configurations (PERF.md §6 PR 13): ping-pong 64 x 128 for
//     a bf16 B (the exact-snake epilogue of pw1 is as long as the
//     products), ping-pong 128 x 128 (two m64 accumulators a group) for an
//     int8 B; without the persistent grid ping-pong loses its overlap.
//   - The snake epilogue is branch-free (sin_ilp, a Newton quotient):
//     the library sinf inlines a Payne-Hanek slow path with a local array at
//     every value, which made the epilogue large, with local memory, and it
//     and IEEE division branch per value.
//   What still holds it (PERF.md): at the 64 x 128 tile the mainloop asks L2
//   for 43 operations per byte, so the products run at about half of
//   cuBLAS's rate; the 128 x 256 tile needs half the bytes per operation,
//   but its epilogue (128 values a thread, not overlapped) costs more than
//   that saves.
//
// Accuracy: the tensor core adds each k16 step's products into the fp32
// accumulator with truncation, about 2^-24 relative per step. The fp32
// core (tc_gemm.cuh) opens a fresh accumulator every K = 32 because its
// outputs are held to 1e-4 of fp32; here the output is bf16 (ulp 2^-8
// relative), and at K = 2048 (128 steps) the drift stays near 2^-17, so the
// whole of K runs in one accumulator. Held: within 2^-6 x max(1, max
// |plain|) of the bf16 plain versions and >= 99.9 % of outputs within one
// bf16 ulp (tests/test_torch_gemm_sm90.py emulates the scheme at every K of
// the 1kbps bf16 model; chip_smoke.py holds the kernels on the card).
#pragma once

#include <cuda.h>

#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "ptx.cuh"

namespace l3ac::sm90 {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;               // K per stage: one 128-byte swizzle row of bf16
constexpr int kRowBytes = 2 * kBK;    // bytes of one swizzled bf16 row
constexpr int kThreads = 384;         // warpgroup 0 loads, 1 and 2 compute
constexpr int kConsumers = 2;
constexpr size_t kMaxSmem = 232448;   // per block (227 KB)

// kPartial: y = acc + b into the fp32 out32, unrounded (a tensor-parallel
// rank's share of a product, summed over the ranks before it is rounded)
enum class Epi { kBias, kSnake, kGelu, kResidual, kPartial };
enum class Route { kTma = 0, kCpAsync = 1 };

// kBN output columns per tile; a ring of kStages; kCoop: both consumer
// warpgroups on one 128-row tile (rows 64 w ...), else each on its own tiles
// of 64 kMB rows in turn (ping-pong; kMB m64 accumulators a group); an int8
// B. One block per SM: ptxas compiles the
// consumers under the launch bound (168 registers at 384 threads), which two
// blocks per SM would cut to 80, too few for a 64-column accumulator.
template <int kBNT, int kStagesT, bool kCoopT, bool kInt8T, int kMBT = 1>
struct Config {
  static constexpr int kBN = kBNT;
  static constexpr int kStages = kStagesT;
  static constexpr bool kCoop = kCoopT;
  static constexpr bool kInt8 = kInt8T;
  static constexpr int kMB = kMBT;
  static constexpr int kBM = kCoop ? 128 : 64 * kMB;
  static constexpr int kABytes = kBM * kRowBytes;
  static constexpr int kBBytes = kBN * kRowBytes;
  static constexpr int kQBytes = kInt8 ? kBN * kBK : 0;  // the int8 tile's staging
  static constexpr int kStageBytes = kABytes + kBBytes + kQBytes;
  static constexpr int kAcc = kBN / 2;                    // fp32 accumulators per thread
  static constexpr int kProducerRegs = kInt8 ? 72 : 40;   // the int8 widening's registers
  static constexpr int kConsumerRegs = kInt8 ? 216 : 232;
  // the ring, its 3 kStages barriers, and 1 KB to align the base to 1024
  static constexpr size_t kSmem = 1024 + static_cast<size_t>(kStages) * kStageBytes + 24 * kStages;
  static_assert(kBN == 128 || kBN == 256, "wgmma_bf16 has n128 and n256");
  static_assert(kMB == 1 || (!kCoop && kMB == 2 && kBN == 128), "two m64 blocks: ping-pong at n128");
  static_assert(kSmem <= kMaxSmem, "shared memory");
  static_assert(kProducerRegs * 128 + kConsumerRegs * 256 <= 65536, "registers");
};

// What the port runs (tools/tc_variants.py measured the alternatives).
using Bf16Config = Config<128, 4, false, false>;
using Int8Config = Config<128, 4, false, true, 2>;

struct Params {
  const bf16* a;            // (M, K)
  const bf16* b;            // (N, K) bf16 B, or null
  const signed char* b_q;   // (N, K) int8 B, or null
  const float* scale;       // (N) its row scale
  const float* bias;        // (N) fp32 bias, or null
  const bf16* bias16;       // (N) bf16 bias of an int8 B, or null
  const float* alpha;       // (N) snake
  const bf16* res;          // (M, N) residual
  bf16* out;                // (M, N)
  float* out32;             // (M, N) fp32, kPartial
  int M, N, K;
  int vec_out;              // N even, out and res 4-byte aligned: bf16 pairs
  int vec_a, vec_b;         // cp.async route: 16-byte copies of A / bf16 B rows
};

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The TMA route's condition: row strides and bases 16-byte aligned.
inline bool admits_tma(const void* a, const void* b, int K, bool int8) {
  return K % (int8 ? 16 : 8) == 0 && aligned(a, 16) && aligned(b, 16);
}

// byte offset of 16-byte chunk j of row r in a 128-byte-swizzled tile
__host__ __device__ __forceinline__ int swizzle128(int r, int j) {
  return r * kRowBytes + ((j ^ (r & 7)) << 4);
}

template <Epi kEpi>
__device__ __forceinline__ float finish(float acc, float b) {
  const float y = acc + b;
  if constexpr (kEpi == Epi::kGelu) return gelu(y);
  return y;
}

__device__ __forceinline__ float bf16_bits(const bf16* p, long long i) {
  return __uint_as_float(static_cast<uint32_t>(reinterpret_cast<const unsigned short*>(p)[i]) << 16);
}

// cp.async route: rows [r0, r0 + R) x K [k0, k0 + 64) of an (rows, K) bf16
// matrix into a swizzled tile, by the producer's 128 threads; zero past the
// edges
template <int R>
__device__ __forceinline__ void load_bf16(unsigned char* dst, const bf16* src, long long r0,
                                          long long rows, int k0, int K, bool vec, int tid) {
#pragma unroll 4
  for (int i = tid; i < R * 8; i += 128) {
    const int r = i >> 3, j = i & 7, k = k0 + 8 * j;
    const long long gr = r0 + r;
    unsigned char* d = dst + swizzle128(r, j);
    if (vec) {  // K % 8 == 0: a chunk is whole or absent
      const bool ok = gr < rows && k < K;
      ptx::cp_async16(d, ok ? src + gr * K + k : src, ok ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok0 = gr < rows && k + 2 * e < K, ok1 = gr < rows && k + 2 * e + 1 < K;
        const uint32_t lo = ok0 ? reinterpret_cast<const unsigned short*>(src)[gr * K + k + 2 * e] : 0u;
        const uint32_t hi = ok1 ? reinterpret_cast<const unsigned short*>(src)[gr * K + k + 2 * e + 1] : 0u;
        w[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// eight int8 weights (little endian in lo, hi) times s, as four bf16 pairs.
// Each byte becomes fp32 without I2F (a quarter-rate conversion, the
// widening's limit): q + 128 placed in the mantissa of 2^23 by a byte
// permute, then 2^23 + 128 subtracted, exact for every int8.
__device__ __forceinline__ uint4 dequant8(uint32_t lo, uint32_t hi, float s) {
  const uint32_t ul = lo ^ 0x80808080u, uh = hi ^ 0x80808080u;  // q + 128, unsigned bytes
  auto q = [](uint32_t u, uint32_t i) {
    return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | i)) - 8388736.0f;
  };
  return make_uint4(ptx::bf16x2_rn(q(ul, 0) * s, q(ul, 1) * s), ptx::bf16x2_rn(q(ul, 2) * s, q(ul, 3) * s),
                    ptx::bf16x2_rn(q(uh, 0) * s, q(uh, 1) * s), ptx::bf16x2_rn(q(uh, 2) * s, q(uh, 3) * s));
}

// cp.async route, int8 B: rows [n0, n0 + R) x [k0, k0 + 64) loaded by bytes
// and stored dequantized into the swizzled bf16 tile
template <int R>
__device__ __forceinline__ void load_int8(unsigned char* dst, const Params& p, int n0, int k0,
                                          int tid) {
#pragma unroll 2
  for (int i = tid; i < R * 8; i += 128) {
    const int r = i >> 3, j = i & 7, n = n0 + r, k = k0 + 8 * j;
    uint32_t w[2] = {0u, 0u};
    float s = 0.0f;
    if (n < p.N) {
      s = p.scale[n];
      const signed char* src = p.b_q + static_cast<long long>(n) * p.K;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (k + e < p.K) w[e >> 2] |= (static_cast<uint32_t>(src[k + e]) & 0xffu) << (8 * (e & 3));
    }
    *reinterpret_cast<uint4*>(dst + swizzle128(r, j)) = dequant8(w[0], w[1], s);
  }
}

// The column parameters of output columns n, n + 1 (n + 1 < N unless !two):
// bias, and for the snake alpha, alpha + eps and its reciprocal.
template <class Cfg, Epi kEpi>
__device__ __forceinline__ void columns(const Params& p, int n, bool two, float (&cb)[2],
                                        float (&ca)[2], float (&cd)[2], float (&cr)[2]) {
  cb[0] = cb[1] = 0.0f;
  if constexpr (Cfg::kInt8) {
    if (p.bias16 != nullptr) {
      cb[0] = __bfloat162float(p.bias16[n]);
      if (two) cb[1] = __bfloat162float(p.bias16[n + 1]);
    }
  } else if (p.bias != nullptr) {
    cb[0] = p.bias[n];
    if (two) cb[1] = p.bias[n + 1];
  }
  if constexpr (kEpi == Epi::kSnake) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ca[i] = (i == 0 || two) ? p.alpha[n + i] : 1.0f;
      cd[i] = ca[i] + kSnakeEps;
      cr[i] = __frcp_rn(cd[i]);
    }
  }
}

// The tile's outputs from the accumulators. A thread whose rows and columns
// all lie inside (M, N), with bf16-pair stores, takes the straight path: the
// values finished a chunk of 16 at a time with no bounds test between them,
// then stored as pairs; the edges go value by value through the same
// arithmetic.
template <class Cfg, Epi kEpi>
__device__ __forceinline__ void epilogue(float (&acc)[Cfg::kAcc], const Params& p,
                                         long long m_base, int n0, int warp, int lane) {
  constexpr int kJ = Cfg::kMB == 1 ? 4 : 1;  // column pairs per chunk (the registers allow)
  const int g = lane >> 2, t = lane & 3;
  const long long row0 = m_base + 16 * warp + g;
  if (p.vec_out && n0 + Cfg::kBN <= p.N && row0 + 8 < p.M) {
#pragma unroll
    for (int j0 = 0; j0 < Cfg::kBN / 8; j0 += kJ) {
      float y[4 * kJ], a[4 * kJ], d[4 * kJ], r[4 * kJ];
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        float cb[2], ca[2], cd[2], cr[2];
        columns<Cfg, kEpi>(p, n0 + 8 * (j0 + jj) + 2 * t, true, cb, ca, cd, cr);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int u = 4 * jj + i;
          y[u] = acc[4 * j0 + u] + cb[i & 1];
          if constexpr (kEpi == Epi::kSnake) a[u] = ca[i & 1], d[u] = cd[i & 1], r[u] = cr[i & 1];
        }
      }
      if constexpr (kEpi == Epi::kSnake) snake_ilp(y, a, d, r);
#pragma unroll
      for (int u = 0; u < 4 * kJ; ++u) acc[4 * j0 + u] = kEpi == Epi::kGelu ? gelu(y[u]) : y[u];
    }
#pragma unroll
    for (int j = 0; j < Cfg::kBN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long o = (row0 + 8 * h) * p.N + n0 + 8 * j + 2 * t;
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if constexpr (kEpi == Epi::kResidual) {
          const uint32_t rv = *reinterpret_cast<const uint32_t*>(p.res + o);
          v0 += __uint_as_float(rv << 16);
          v1 += __uint_as_float(rv & 0xffff0000u);
        }
        if constexpr (kEpi == Epi::kPartial)
          *reinterpret_cast<float2*>(p.out32 + o) = make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(p.out + o) = ptx::bf16x2_rn(v0, v1);
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < Cfg::kBN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    if (n >= p.N) continue;
    const bool two = n + 1 < p.N;
    float cb[2], ca[2], cd[2], cr[2];
    columns<Cfg, kEpi>(p, n, two, cb, ca, cd, cr);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = row0 + 8 * h;
      if (m >= p.M) continue;
      float v[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (kEpi == Epi::kSnake) {
          float y[1] = {acc[4 * j + 2 * h + i] + cb[i]};
          const float a[1] = {ca[i]}, d[1] = {cd[i]}, r[1] = {cr[i]};
          snake_ilp(y, a, d, r);
          v[i] = y[0];
        } else {
          v[i] = finish<kEpi>(acc[4 * j + 2 * h + i], cb[i]);
        }
      }
      const long long o = m * p.N + n;
      if (p.vec_out && two) {
        if constexpr (kEpi == Epi::kResidual) {
          const uint32_t rv = *reinterpret_cast<const uint32_t*>(p.res + o);
          v[0] += __uint_as_float(rv << 16);
          v[1] += __uint_as_float(rv & 0xffff0000u);
        }
        if constexpr (kEpi == Epi::kPartial)
          *reinterpret_cast<float2*>(p.out32 + o) = make_float2(v[0], v[1]);
        else
          *reinterpret_cast<uint32_t*>(p.out + o) = ptx::bf16x2_rn(v[0], v[1]);
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i == 1 && !two) continue;
          if constexpr (kEpi == Epi::kResidual) v[i] += bf16_bits(p.res, o + i);
          if constexpr (kEpi == Epi::kPartial) p.out32[o + i] = v[i];
          else p.out[o + i] = __float2bfloat16_rn(v[i]);
        }
      }
    }
  }
}

template <class Cfg, Epi kEpi, Route kRoute>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                const Params p) {
  constexpr int S = Cfg::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - ptx::smem_addr(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * Cfg::kStageBytes);
  uint64_t* empty = full + S;
  uint64_t* qfull = empty + S;  // int8 TMA route: the staged int8 tile has landed

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int tiles_n = (p.N + Cfg::kBN - 1) / Cfg::kBN;
  const int tiles = ((p.M + Cfg::kBM - 1) / Cfg::kBM) * tiles_n;
  const int ksteps = (p.K + kBK - 1) / kBK;
  constexpr bool kTma = kRoute == Route::kTma;
  // full: the TMA thread's expect_tx arrival (+ the 96 widening threads of
  // an int8 tile), or the producer's 128 threads on the cp.async route
  constexpr uint32_t kFullCount = kTma ? (Cfg::kInt8 ? 97 : 1) : 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      ptx::mbar_init(&full[s], kFullCount);
      ptx::mbar_init(&empty[s], Cfg::kCoop ? kConsumers : 1);
      ptx::mbar_init(&qfull[s], 1);
    }
    ptx::fence_mbarrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // ---- producer ----
    ptx::setmaxnreg_dec<Cfg::kProducerRegs>();
    const int warp = tid / 32;
    if constexpr (kTma) {
      if (warp == 0) {
        if (tid == 0) {
          int c = 0;
          for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
            const int m0 = (tile / tiles_n) * Cfg::kBM, n0 = (tile % tiles_n) * Cfg::kBN;
            for (int ks = 0; ks < ksteps; ++ks, ++c) {
              const int s = c % S;
              ptx::mbar_wait(&empty[s], ((c / S) & 1) ^ 1);
              unsigned char* st = smem + s * Cfg::kStageBytes;
              if constexpr (!Cfg::kInt8) {
                ptx::mbar_arrive_expect_tx(&full[s], Cfg::kABytes + Cfg::kBBytes);
                ptx::tma_load_2d(st, &map_a, &full[s], ks * kBK, m0);
                ptx::tma_load_2d(st + Cfg::kABytes, &map_b, &full[s], ks * kBK, n0);
              } else {
                ptx::mbar_arrive_expect_tx(&full[s], Cfg::kABytes);
                ptx::tma_load_2d(st, &map_a, &full[s], ks * kBK, m0);
                ptx::mbar_arrive_expect_tx(&qfull[s], Cfg::kQBytes);
                ptx::tma_load_2d(st + Cfg::kABytes + Cfg::kBBytes, &map_b, &qfull[s], ks * kBK, n0);
              }
            }
          }
        }
      } else if constexpr (Cfg::kInt8) {  // warps 1-3 widen each staged int8 tile
        // chunk wt + 96 i (8 weights: row ch / 8, 16-byte column ch % 8) for
        // i < kPer; all of a thread's chunks loaded before any is widened,
        // so the loads overlap; the rows' scales loaded once per tile
        constexpr int kChunks = Cfg::kBN * 8, kPer = (kChunks + 95) / 96;
        const int wt = tid - 32;
        int c = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          const int n0 = (tile % tiles_n) * Cfg::kBN;
          float sc[kPer];
#pragma unroll
          for (int i = 0; i < kPer; ++i)  // rows past N are zero: any scale will do
            sc[i] = p.scale[min(n0 + (wt + 96 * i) / 8, p.N - 1)];
          for (int ks = 0; ks < ksteps; ++ks, ++c) {
            const int s = c % S;
            ptx::mbar_wait(&qfull[s], (c / S) & 1);
            unsigned char* st = smem + s * Cfg::kStageBytes;
            const unsigned char* q = st + Cfg::kABytes + Cfg::kBBytes;  // (kBN, 64) bytes
            uint2 w[kPer];
#pragma unroll
            for (int i = 0; i < kPer; ++i)
              if (wt + 96 * i < kChunks) w[i] = *reinterpret_cast<const uint2*>(q + 8 * (wt + 96 * i));
#pragma unroll
            for (int i = 0; i < kPer; ++i) {
              const int ch = wt + 96 * i;
              if (ch < kChunks)
                *reinterpret_cast<uint4*>(st + Cfg::kABytes + swizzle128(ch >> 3, ch & 7)) =
                    dequant8(w[i].x, w[i].y, sc[i]);
            }
            ptx::fence_proxy_async();
            ptx::mbar_arrive(&full[s]);
          }
        }
      }
    } else {  // cp.async route: all 128 threads, each stage signalled one stage late
      int c = 0, prev = -1;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * Cfg::kBM, n0 = (tile % tiles_n) * Cfg::kBN;
        for (int ks = 0; ks < ksteps; ++ks, ++c) {
          const int s = c % S;
          ptx::mbar_wait(&empty[s], ((c / S) & 1) ^ 1);
          unsigned char* st = smem + s * Cfg::kStageBytes;
          load_bf16<Cfg::kBM>(st, p.a, m0, p.M, ks * kBK, p.K, p.vec_a, tid);
          if constexpr (Cfg::kInt8) load_int8<Cfg::kBN>(st + Cfg::kABytes, p, n0, ks * kBK, tid);
          else load_bf16<Cfg::kBN>(st + Cfg::kABytes, p.b, n0, p.N, ks * kBK, p.K, p.vec_b, tid);
          ptx::cp_async_commit();
          if (prev >= 0) {
            ptx::cp_async_wait<1>();
            ptx::fence_proxy_async();
            ptx::mbar_arrive(&full[prev]);
          }
          prev = s;
        }
      }
      if (prev >= 0) {
        ptx::cp_async_wait<0>();
        ptx::fence_proxy_async();
        ptx::mbar_arrive(&full[prev]);
      }
    }
  } else {  // ---- consumers ----
    ptx::setmaxnreg_inc<Cfg::kConsumerRegs>();
    const int cw = wg - 1, warp = tid / 32, lane = tid % 32;
    const int a_off = Cfg::kCoop ? cw * 64 * kRowBytes : 0;
    float acc[Cfg::kMB][Cfg::kAcc];
#pragma unroll
    for (int mb = 0; mb < Cfg::kMB; ++mb)
#pragma unroll
      for (int i = 0; i < Cfg::kAcc; ++i) acc[mb][i] = 0.0f;
    int c = 0, local = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++local) {
      if (!Cfg::kCoop && (local & 1) != cw) {  // the other group's tile
        c += ksteps;
        continue;
      }
      // ping-pong: the groups' mainloops take turns (named barrier 1 + cw
      // opens this group's), so one group's epilogue overlaps the other's
      // products, and no group waits on a stage's phase before the other
      // group has waited on the phase before it (a parity wait cannot tell
      // the two apart)
      if (!Cfg::kCoop && local > 0) ptx::bar_sync(1 + cw, 2 * 128);
      const int m0 = (tile / tiles_n) * Cfg::kBM, n0 = (tile % tiles_n) * Cfg::kBN;
      int prev = -1;
      for (int ks = 0; ks < ksteps; ++ks, ++c) {
        const int s = c % S;
        ptx::mbar_wait(&full[s], (c / S) & 1);
        const unsigned char* st = smem + s * Cfg::kStageBytes;
        const uint64_t da = ptx::wgmma_desc_sw128(st + a_off);
        const uint64_t db = ptx::wgmma_desc_sw128(st + Cfg::kABytes);
        ptx::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
          for (int mb = 0; mb < Cfg::kMB; ++mb)  // m-block mb: 64 rows (8 KB, 512 units) on
            ptx::wgmma_bf16<Cfg::kBN>(acc[mb], da + 512 * mb + 2 * kk, db + 2 * kk,
                                      (ks > 0 || kk > 0) ? 1 : 0);
        ptx::wgmma_commit();
        ptx::wgmma_wait<1>();  // the step before has finished reading its stage
        if (prev >= 0 && tid == 0) ptx::mbar_arrive(&empty[prev]);
        prev = s;
      }
      ptx::wgmma_wait<0>();
#pragma unroll
      for (int mb = 0; mb < Cfg::kMB; ++mb)
#pragma unroll
        for (int i = 0; i < Cfg::kAcc; ++i) ptx::fence_operand(acc[mb][i]);
      if (tid == 0) ptx::mbar_arrive(&empty[prev]);
      if (!Cfg::kCoop && tile + static_cast<int>(gridDim.x) < tiles) ptx::bar_arrive(2 - cw, 2 * 128);
#pragma unroll
      for (int mb = 0; mb < Cfg::kMB; ++mb)
        epilogue<Cfg, kEpi>(acc[mb], p, m0 + (Cfg::kCoop ? 64 * cw : 64 * mb), n0, warp, lane);
    }
  }
}

// ---- host side ----------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      f = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) != cudaSuccess)
      f = nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// The tensor map of a row-major (rows, K) matrix, boxes of box_rows x 64:
// bf16 in the 128-byte swizzle, int8 unswizzled (the staging layout).
inline cudaError_t encode_map(CUtensorMap* m, const void* base, long long rows, int K,
                              int box_rows, bool int8) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * (int8 ? 1 : 2)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(m, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The weight's map for Cfg (B box of kBN rows), to keep with a prepared weight.
template <class Cfg>
cudaError_t weight_map(CUtensorMap* m, const void* w, int N, int K) {
  if (N < 1 || K < 1 || !admits_tma(w, w, K, Cfg::kInt8)) return cudaErrorInvalidValue;
  return encode_map(m, w, N, K, Cfg::kBN, Cfg::kInt8);
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 132;
    return v;
  }();
  return n;
}

// Launch on stream s; returns the CUDA error code (a refused launch never
// runs). p.b (bf16 B) or p.b_q / p.scale (int8) per Cfg. b_map: the
// weight's prepared map, or null to encode it here. persistent: one block
// per SM walks the tiles, else one block per tile.
template <class Cfg, Epi kEpi>
cudaError_t launch(Params p, Route route, const void* b_map, bool persistent, cudaStream_t s) {
  const void* b = Cfg::kInt8 ? static_cast<const void*>(p.b_q) : static_cast<const void*>(p.b);
  if (p.M < 1 || p.N < 1 || p.K < 1 || b == nullptr || (Cfg::kInt8 && p.scale == nullptr) ||
      (kEpi == Epi::kSnake && p.alpha == nullptr) || (kEpi == Epi::kResidual && p.res == nullptr) ||
      (kEpi == Epi::kPartial && p.out32 == nullptr))
    return cudaErrorInvalidValue;
  p.vec_out = kEpi == Epi::kPartial
                  ? p.N % 2 == 0 && aligned(p.out32, 8)
                  : p.N % 2 == 0 && aligned(p.out, 4) && (p.res == nullptr || aligned(p.res, 4));
  p.vec_a = p.K % 8 == 0 && aligned(p.a, 16);
  p.vec_b = !Cfg::kInt8 && p.K % 8 == 0 && aligned(p.b, 16);
  CUtensorMap ma, mb;
  std::memset(&ma, 0, sizeof(ma));
  std::memset(&mb, 0, sizeof(mb));
  if (route == Route::kTma) {
    if (!admits_tma(p.a, b, p.K, Cfg::kInt8)) return cudaErrorInvalidValue;
    cudaError_t err = encode_map(&ma, p.a, p.M, p.K, Cfg::kBM, false);
    if (err != cudaSuccess) return err;
    if (b_map != nullptr) std::memcpy(&mb, b_map, sizeof(mb));
    else if ((err = encode_map(&mb, b, p.N, p.K, Cfg::kBN, Cfg::kInt8)) != cudaSuccess) return err;
  }
  auto kernel = route == Route::kTma ? gemm_kernel<Cfg, kEpi, Route::kTma>
                                     : gemm_kernel<Cfg, kEpi, Route::kCpAsync>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(Cfg::kSmem));
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>((p.M + Cfg::kBM - 1) / Cfg::kBM) *
                          ((p.N + Cfg::kBN - 1) / Cfg::kBN);
  const long long cap = sm_count();
  const long long grid = persistent && tiles > cap ? cap : tiles;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(grid), kThreads, Cfg::kSmem, s>>>(ma, mb, p);
  return cudaGetLastError();
}

}  // namespace l3ac::sm90
