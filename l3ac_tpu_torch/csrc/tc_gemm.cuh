// fp32-accurate GEMM on the H100's tensor cores, shared by int8_matmul.cu
// and conv_unit_tc.cu:
//   C[M, N] = epilogue(A[M, K] . B[N, K]^T),
// A fp32 row-major (K-major), B K-major in nn.Linear layout, so no weight is
// transposed. B is either
//   - an fp32 weight split once, by the caller, into TF32 hi and lo
//     (ops/kernels/tc_gemm.py:split_tf32): 3 passes of the TF32 mma
//     (m16n8k8), A_lo B_hi + A_hi B_lo + A_hi B_hi ("3xTF32"), A split into
//     hi = tf32_rna(a) and lo = tf32_rna(a - hi). The term dropped, A_lo B_lo,
//     and the TF32 roundings of the lo parts are each below 2^-22 relative.
//   - an int8 weight, exact in bf16 (|q| <= 127): 3 passes of the bf16 mma
//     (m16n8k16), A = a0 + a1 + a2 in bf16 (24 bits, the split of
//     tc_gemm.py:split_bf16x3), with the row scale in the epilogue,
//     y = scale * (A q^T) + b.
// A is split as its fragments are loaded from shared memory.
//
// Split and tiling choices (Fp32Tiling, Int8Tiling), measured on the card
// against the alternatives with l3ac_tpu_torch/tools/tc_variants.py
// (PERF.md): int8 on three bf16 passes against two TF32 passes
// (A_lo q + A_hi q; bf16 is also exact to 2^-24 where TF32 stops at 2^-22),
// 512 threads of 32 x 32 warp tiles against 256 of 32 x 64.
//
// Accuracy of the sums: the tensor core adds in fp32 with truncation, so a
// long chain of mma steps drifts toward zero (~2^-24 relative per step; at
// K = 2048 and 3 passes about 40x the error of an fp32 FMA loop). Each K step
// of 32 therefore sums into a fresh accumulator (12 TF32 or 6 bf16 mma
// steps), which is then added to the block's fp32 sum with an ordinary
// rounded add. In the CPU emulation of this scheme
// (tests/test_torch_tc_gemm.py) that keeps the error at or below the fp32
// plain product's at every shape of the codec.
//
// Design: one block per 128 x 128 output tile; K in steps of 32 through a
// 3-stage ring in shared memory filled by cp.async (16-byte copies where
// rows are 16-byte aligned, else 4-byte ones; zero fill past the M, N and K
// edges, so ragged shapes such as K = 341 or N = 682 need no padded copy).
// An int8 B tile goes through registers: loaded one step ahead, converted to
// fp32 (exact) and stored after the step's products. Fragments come from
// ldmatrix; rows are padded to 36 floats so that its eight row reads hit
// distinct banks. The bf16 mma wants k pairs (2t, 2t+1) per lane; ldmatrix
// of fp32 rows gives lane t the words t and t + 4, so the bf16 step maps the
// mma's k order (2t, 2t+1, 2t+8, 2t+9) onto columns (t, t+4, t+8, t+12) of
// A and B alike, which leaves the product unchanged.
// Bound on the H100: the tensor-core passes (495 TFLOP/s TF32, 989 bf16) at
// the conv_unit shapes, memory for the smallest transformer products. The
// bf16 products (bf16 activations) run on gemm_sm90.cuh's wgmma core; wgmma
// here would need the split A in registers (3xTF32), not yet tried.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "ptx.cuh"

namespace l3ac::tc {

constexpr int kBM = 128;             // output rows per block
constexpr int kBN = 128;             // output columns per block
constexpr int kBK = 32;              // K step, one fresh accumulator each
constexpr int kStages = 3;           // shared-memory ring
constexpr int kRow = kBK + 4;        // shared row stride in floats
constexpr int kTile = kBM * kRow;    // floats of one A or B tile
static_assert(kBM == kBN, "A and B tiles share a size");

// The block's warps (kThreads / 32, warp tiles of 32 x kWN) and, for an int8
// B, the split of A: three bf16 terms (kBf16) or TF32 hi / lo.
template <int kThreadsT, int kWNT, bool kBf16T>
struct Tiling {
  static constexpr int kThreads = kThreadsT;
  static constexpr int kWM = 32, kWN = kWNT;
  static constexpr bool kBf16 = kBf16T;
  static constexpr int kWarpsN = kBN / kWN;
  static constexpr int kMT = kWM / 16;   // m16 tiles per warp
  static constexpr int kNT = kWN / 8;    // n8 tiles per warp
  static_assert((kBM / kWM) * kWarpsN * 32 == kThreads, "one warp tile per warp");
};
using Fp32Tiling = Tiling<512, 32, false>;  // fp32 B: 16 warps of 32 x 32
using Int8Tiling = Tiling<256, 64, true>;   // int8 B: 8 warps of 32 x 64, bf16 split
template <bool kInt8>
using DefaultTiling = std::conditional_t<kInt8, Int8Tiling, Fp32Tiling>;

enum class Epi {
  kBias,      // y = acc + b (int8: scale * acc + b); b may be null
  kSnake,     // y = snake(acc + b, alpha)
  kGelu,      // y = gelu(acc + b)
  kResidual,  // y = res + (acc + b)
};

struct Params {
  const float* a;          // (M, K)
  const float* b_hi;       // (N, K) TF32 hi of an fp32 weight, or null
  const float* b_lo;       // (N, K) TF32 lo
  const signed char* b_q;  // (N, K) int8 weight, or null
  const float* scale;      // (N) int8 row scale
  const float* bias;       // (N) or null
  const float* alpha;      // (N) snake
  const float* res;        // (M, N) residual
  float* out;              // (M, N)
  int M, N, K;
  int vec_out;             // N even, out and res 8-byte aligned: float2 stores
};

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// floats of one ring stage: A, then B (fp32: hi and lo)
template <bool kInt8>
__host__ __device__ constexpr int stage_floats() { return kTile * (kInt8 ? 2 : 3); }

template <bool kInt8>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * kStages * stage_floats<kInt8>();
}

// rows [r0, r0 + 128) x K [k0, k0 + 32) of an (R, K) fp32 matrix into a tile,
// 16 bytes per copy (K % 4 == 0, src 16-byte aligned), kThreads threads
template <int kThreads>
__device__ __forceinline__ void load_rows16(float* dst, const float* src, long long r0,
                                            long long R, int k0, int K, int tid) {
#pragma unroll
  for (int i = 0; i < kBM * kBK / 4 / kThreads; ++i) {
    const int c = tid + i * kThreads, row = c / (kBK / 4), col = (c % (kBK / 4)) * 4;
    const bool ok = r0 + row < R && k0 + col < K;
    const float* s = ok ? src + (r0 + row) * K + k0 + col : src;
    ptx::cp_async16(dst + row * kRow + col, s, ok ? 16 : 0);
  }
}

// the same, 4 bytes per copy (any K, any alignment)
template <int kThreads>
__device__ __forceinline__ void load_rows4(float* dst, const float* src, long long r0,
                                           long long R, int k0, int K, int tid) {
#pragma unroll
  for (int i = 0; i < kBM * kBK / kThreads; ++i) {
    const int e = tid + i * kThreads, row = e / kBK, col = e % kBK;
    const bool ok = r0 + row < R && k0 + col < K;
    const float* s = ok ? src + (r0 + row) * K + k0 + col : src;
    ptx::cp_async4(dst + row * kRow + col, s, ok ? 4 : 0);
  }
}

// an int8 B tile in registers: four 4-byte words (K % 4 == 0, aligned) or
// sixteen bytes per thread; stored to shared memory as fp32 (exact)
template <bool kVec, int kThreads>
struct QTile {
  static constexpr int kN = kVec ? kBN * kBK / 4 / kThreads : kBN * kBK / kThreads;
  int v[kN];

  __device__ __forceinline__ void load(const Params& p, int n0, int k0, int tid) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int e = tid + i * kThreads;
      const int row = kVec ? e / (kBK / 4) : e / kBK;
      const int col = kVec ? (e % (kBK / 4)) * 4 : e % kBK;
      const bool ok = n0 + row < p.N && k0 + col < p.K;
      const signed char* s = p.b_q + static_cast<long long>(n0 + row) * p.K + k0 + col;
      if (kVec) v[i] = ok ? *reinterpret_cast<const int*>(s) : 0;
      else v[i] = ok ? static_cast<int>(*s) : 0;
    }
  }

  __device__ __forceinline__ void store(float* dst, int tid) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int e = tid + i * kThreads;
      if (kVec) {
        const int row = e / (kBK / 4), col = (e % (kBK / 4)) * 4;
        const int w = v[i];  // little endian: byte j is k = col + j
        *reinterpret_cast<float4*>(dst + row * kRow + col) = make_float4(
            static_cast<float>(static_cast<signed char>(w & 0xff)),
            static_cast<float>(static_cast<signed char>((w >> 8) & 0xff)),
            static_cast<float>(static_cast<signed char>((w >> 16) & 0xff)),
            static_cast<float>(w >> 24));
      } else {
        dst[(e / kBK) * kRow + e % kBK] = static_cast<float>(v[i]);
      }
    }
  }
};

// The products of one K step on a staged tile with TF32 passes, into acc
// (zeroed by the caller): 3xTF32 for an fp32 B, A_lo q + A_hi q for an int8
// one. ldmatrix rows: A tiles q = (rows 0-7 | 8-15) x (k 0-3 | 4-7), q & 1
// the row half; B pairs of n8 tiles, q >> 1 the tile, q & 1 the k half.
template <class T, bool kInt8>
__device__ __forceinline__ void mma_step_tf32(const float* sA, const float* sBh,
                                              const float* sBl,
                                              float (&acc)[T::kMT][T::kNT][4], int wm, int wn,
                                              int lane) {
  const int q = lane >> 3, r = lane & 7;
  const float* pa = sA + (wm * T::kWM + (q & 1) * 8 + r) * kRow + (q >> 1) * 4;
  const int ob = (wn * T::kWN + (q >> 1) * 8 + r) * kRow + (q & 1) * 4;
#pragma unroll
  for (int ks = 0; ks < kBK / 8; ++ks) {
    uint32_t bh[T::kNT][2], bl[T::kNT][2];
#pragma unroll
    for (int j = 0; j < T::kNT / 2; ++j) {
      uint32_t t[4];
      ptx::ldmatrix_x4(t, sBh + ob + j * 16 * kRow + ks * 8);
      bh[2 * j][0] = t[0], bh[2 * j][1] = t[1], bh[2 * j + 1][0] = t[2], bh[2 * j + 1][1] = t[3];
      if constexpr (!kInt8) {
        ptx::ldmatrix_x4(t, sBl + ob + j * 16 * kRow + ks * 8);
        bl[2 * j][0] = t[0], bl[2 * j][1] = t[1], bl[2 * j + 1][0] = t[2], bl[2 * j + 1][1] = t[3];
      }
    }
#pragma unroll
    for (int mt = 0; mt < T::kMT; ++mt) {
      uint32_t raw[4], hi[4], lo[4];
      ptx::ldmatrix_x4(raw, pa + mt * 16 * kRow + ks * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = __uint_as_float(raw[i]);
        hi[i] = ptx::tf32_rna(v);
        lo[i] = ptx::tf32_rna(v - __uint_as_float(hi[i]));
      }
#pragma unroll
      for (int nt = 0; nt < T::kNT; ++nt) {  // small terms first
        ptx::mma_tf32(acc[mt][nt], lo, bh[nt]);
        if constexpr (!kInt8) ptx::mma_tf32(acc[mt][nt], hi, bl[nt]);
        ptx::mma_tf32(acc[mt][nt], hi, bh[nt]);
      }
    }
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }

// The same for an int8 B (fp32 in shared memory, exact in bf16): A in three
// bf16 terms, k16 steps; the mma's k (2t, 2t+1, 2t+8, 2t+9) are columns
// (t, t+4, t+8, t+12) of A and B.
template <class T>
__device__ __forceinline__ void mma_step_bf16(const float* sA, const float* sB,
                                              float (&acc)[T::kMT][T::kNT][4], int wm, int wn,
                                              int lane) {
  const int q = lane >> 3, r = lane & 7;
  const float* pa = sA + (wm * T::kWM + (q & 1) * 8 + r) * kRow + (q >> 1) * 4;
  const int ob = (wn * T::kWN + (q >> 1) * 8 + r) * kRow + (q & 1) * 4;
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks) {
    uint32_t b[T::kNT][2];
#pragma unroll
    for (int j = 0; j < T::kNT / 2; ++j) {
      uint32_t t0[4], t1[4];  // columns 0-7 and 8-15 of the k16 step
      ptx::ldmatrix_x4(t0, sB + ob + j * 16 * kRow + ks * 16);
      ptx::ldmatrix_x4(t1, sB + ob + j * 16 * kRow + ks * 16 + 8);
      b[2 * j][0] = ptx::bf16x2_rn(__uint_as_float(t0[0]), __uint_as_float(t0[1]));
      b[2 * j][1] = ptx::bf16x2_rn(__uint_as_float(t1[0]), __uint_as_float(t1[1]));
      b[2 * j + 1][0] = ptx::bf16x2_rn(__uint_as_float(t0[2]), __uint_as_float(t0[3]));
      b[2 * j + 1][1] = ptx::bf16x2_rn(__uint_as_float(t1[2]), __uint_as_float(t1[3]));
    }
#pragma unroll
    for (int mt = 0; mt < T::kMT; ++mt) {
      uint32_t r0[4], r1[4];
      ptx::ldmatrix_x4(r0, pa + mt * 16 * kRow + ks * 16);
      ptx::ldmatrix_x4(r1, pa + mt * 16 * kRow + ks * 16 + 8);
      // register i of the fragment: the pair (column c, column c + 4)
      const uint32_t pair[4][2] = {{r0[0], r0[2]}, {r0[1], r0[3]}, {r1[0], r1[2]}, {r1[1], r1[3]}};
      uint32_t x0[4], x1[4], x2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float u = __uint_as_float(pair[i][0]), v = __uint_as_float(pair[i][1]);
        x0[i] = ptx::bf16x2_rn(u, v);
        const float u1 = u - bf16_lo(x0[i]), v1 = v - bf16_hi(x0[i]);  // exact
        x1[i] = ptx::bf16x2_rn(u1, v1);
        x2[i] = ptx::bf16x2_rn(u1 - bf16_lo(x1[i]), v1 - bf16_hi(x1[i]));
      }
#pragma unroll
      for (int nt = 0; nt < T::kNT; ++nt) {  // small terms first
        ptx::mma_bf16(acc[mt][nt], x2, b[nt]);
        ptx::mma_bf16(acc[mt][nt], x1, b[nt]);
        ptx::mma_bf16(acc[mt][nt], x0, b[nt]);
      }
    }
  }
}

template <bool kInt8, Epi kEpi>
__device__ __forceinline__ float finish(float acc, float s, float b, float al) {
  if constexpr (kInt8) acc *= s;
  const float y = acc + b;
  if constexpr (kEpi == Epi::kSnake) return snake(y, al);
  if constexpr (kEpi == Epi::kGelu) return gelu(y);
  return y;
}

template <bool kInt8, Epi kEpi, bool kVecA, bool kVecB, class T>
__global__ void __launch_bounds__(T::kThreads, 1) gemm_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kThreads = T::kThreads, kMT = T::kMT, kNT = T::kNT;
  constexpr int kStage = stage_floats<kInt8>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  const long long m0 = static_cast<long long>(blockIdx.y) * kBM;
  const int n0 = blockIdx.x * kBN;
  const int steps = (p.K + kBK - 1) / kBK;

  // A (and an fp32 B) of step s into stage s % kStages, asynchronously
  auto stage_in = [&](int s) {
    float* st = smem + (s % kStages) * kStage;
    if constexpr (kVecA) load_rows16<kThreads>(st, p.a, m0, p.M, s * kBK, p.K, tid);
    else load_rows4<kThreads>(st, p.a, m0, p.M, s * kBK, p.K, tid);
    if constexpr (!kInt8 && kVecB) {
      load_rows16<kThreads>(st + kTile, p.b_hi, n0, p.N, s * kBK, p.K, tid);
      load_rows16<kThreads>(st + 2 * kTile, p.b_lo, n0, p.N, s * kBK, p.K, tid);
    } else if constexpr (!kInt8) {  // any K (general.cu's unit products)
      load_rows4<kThreads>(st + kTile, p.b_hi, n0, p.N, s * kBK, p.K, tid);
      load_rows4<kThreads>(st + 2 * kTile, p.b_lo, n0, p.N, s * kBK, p.K, tid);
    }
  };

  QTile<kVecB, kThreads> qt;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      stage_in(s);
      if constexpr (kInt8) {
        qt.load(p, n0, s * kBK, tid);
        qt.store(smem + s * kStage + kTile, tid);
      }
    }
    ptx::cp_async_commit();
  }

  float sum[kMT][kNT][4], acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[mt][nt][i] = 0.0f;

  for (int s = 0; s < steps; ++s) {
    ptx::cp_async_wait<kStages - 2>();  // step s has landed
    __syncthreads();                    // ... for every thread; stage (s - 1) is free
    const int next = s + kStages - 1;
    if (next < steps) {
      stage_in(next);
      if constexpr (kInt8) qt.load(p, n0, next * kBK, tid);  // in flight during the products
    }
    ptx::cp_async_commit();

#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    const float* st = smem + (s % kStages) * kStage;
    if constexpr (kInt8 && T::kBf16) mma_step_bf16<T>(st, st + kTile, acc, wm, wn, lane);
    else mma_step_tf32<T, kInt8>(st, st + kTile, st + 2 * kTile, acc, wm, wn, lane);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[mt][nt][i] += acc[mt][nt][i];

    if constexpr (kInt8) {
      if (next < steps) qt.store(smem + (next % kStages) * kStage + kTile, tid);
    }
  }

  // epilogue: lane (g, t) holds rows g and g + 8, columns 2t and 2t + 1 of each tile
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int n = n0 + wn * T::kWN + nt * 8 + 2 * t;
    float cs[2], cb[2], ca[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool ok = n + j < p.N;
      cs[j] = (kInt8 && ok) ? p.scale[n + j] : 1.0f;
      cb[j] = (ok && p.bias != nullptr) ? p.bias[n + j] : 0.0f;
      ca[j] = (kEpi == Epi::kSnake && ok) ? p.alpha[n + j] : 1.0f;
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + wm * T::kWM + mt * 16 + g + h * 8;
        if (m >= p.M) continue;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          v[j] = finish<kInt8, kEpi>(sum[mt][nt][2 * h + j], cs[j], cb[j], ca[j]);
        const long long o = m * p.N + n;
        if (p.vec_out && n + 1 < p.N) {
          if constexpr (kEpi == Epi::kResidual) {
            const float2 rv = *reinterpret_cast<const float2*>(p.res + o);
            v[0] = rv.x + v[0];
            v[1] = rv.y + v[1];
          }
          *reinterpret_cast<float2*>(p.out + o) = make_float2(v[0], v[1]);
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (n + j >= p.N) continue;
            if constexpr (kEpi == Epi::kResidual) v[j] = p.res[o + j] + v[j];
            p.out[o + j] = v[j];
          }
        }
      }
    }
  }
}

// Launch on stream s; returns the CUDA error code (a refused launch never runs).
template <bool kInt8, Epi kEpi, bool kVecA, bool kVecB, class T = DefaultTiling<kInt8>>
cudaError_t launch_gemm(Params p, cudaStream_t s) {
  const long long m_tiles = (static_cast<long long>(p.M) + kBM - 1) / kBM;
  if (p.M < 1 || p.N < 1 || p.K < 1 || m_tiles > 65535) return cudaErrorInvalidValue;
  p.vec_out = p.N % 2 == 0 && aligned(p.out, 8) && (p.res == nullptr || aligned(p.res, 8));
  constexpr size_t smem = smem_bytes<kInt8>();
  auto kernel = gemm_kernel<kInt8, kEpi, kVecA, kVecB, T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // N tiles fastest, so consecutive blocks read the same A rows from L2
  dim3 grid(ceil_div(p.N, kBN), static_cast<unsigned>(m_tiles));
  kernel<<<grid, T::kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace l3ac::tc
