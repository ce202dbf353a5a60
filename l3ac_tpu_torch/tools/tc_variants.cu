// The tensor-core GEMM core (csrc/tc_gemm.cuh) at the tilings and int8 splits
// it was chosen from, for tools/tc_variants.py; not part of the kernel
// library. Variant 0 of each fp32 entry point is what the port runs. Below
// them, the bf16 products' former core (one mma.sync pass, a fresh
// accumulator every K = 32, a 3-stage cp.async ring), kept as the baseline
// of the wgmma core (csrc/gemm_sm90.cuh, tools/sm90_variants.cu); the port
// no longer runs it.
#include "tc_gemm.cuh"

namespace {

using namespace l3ac::tc;

template <class T>
int fp32(const Params& p, int epi, cudaStream_t s) {
  return epi == 0 ? launch_gemm<false, Epi::kSnake, true, true, T>(p, s)
                  : launch_gemm<false, Epi::kResidual, true, true, T>(p, s);
}

template <class T>
int int8(const Params& p, cudaStream_t s) {
  const bool vec = p.K % 4 == 0 && aligned(p.a, 16) && aligned(p.b_q, 4);
  return vec ? launch_gemm<true, Epi::kBias, true, true, T>(p, s)
             : launch_gemm<true, Epi::kBias, false, false, T>(p, s);
}

}  // namespace

// variant: 0 Fp32Tiling (512 threads, 32 x 32), 1 Tiling<256, 64> (32 x 64).
// epi 0: snake(a w^T + b) (pw1), 1: res + a w^T + b (pw2).
extern "C" int l3ac_tcv_fp32(int variant, const float* a, const float* w_hi, const float* w_lo,
                             const float* bias, const float* alpha, const float* res,
                             float* out, int M, int N, int K, int epi, void* stream) {
  Params p{};
  p.a = a, p.b_hi = w_hi, p.b_lo = w_lo, p.bias = bias, p.alpha = alpha, p.res = res;
  p.out = out, p.M = M, p.N = N, p.K = K;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return fp32<Fp32Tiling>(p, epi, s);
    case 1: return fp32<Tiling<256, 64, false>>(p, epi, s);
    default: return cudaErrorInvalidValue;
  }
}

// variant: 0 Int8Tiling (256 threads, 32 x 64, three bf16 passes), 1 the same
// tiling with two TF32 passes, 2 512 threads of 32 x 32 with bf16 passes.
extern "C" int l3ac_tcv_int8(int variant, const float* x, const signed char* w_q,
                             const float* scale, const float* bias, float* out, int M, int N,
                             int K, void* stream) {
  Params p{};
  p.a = x, p.b_q = w_q, p.scale = scale, p.bias = bias, p.out = out, p.M = M, p.N = N, p.K = K;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return int8<Int8Tiling>(p, s);
    case 1: return int8<Tiling<256, 64, false>>(p, s);
    case 2: return int8<Tiling<512, 32, true>>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

namespace l3ac::tc {

// ---- the former bf16 core: one bf16 pass --------------------------------
//
// C[M, N] = epilogue(A[M, K] . B[N, K]^T) with A and B bf16 (both K-major)
// and fp32 sums: one mma.sync m16n8k16 pass per k16 step, the exact product
// of bf16 operands. Same 128 x 128 tile, K step of 32 (one fresh
// accumulator each, as above) and 3-stage cp.async ring; 8 warps of 32 x 64;
// bf16 rows padded to 40 elements (80 bytes: an odd number of 16-byte
// pieces, so ldmatrix's eight row reads hit distinct banks), fragments by
// ldmatrix in the mma's natural k order. The epilogue computes in fp32 from
// fp32 vectors and rounds the output to bf16 once (the residual, bf16, is
// added in fp32 before that rounding). K % 8 == 0, N even and 16-byte aligned
// rows: the wrapper's widths (C % 64 == 0) always are.
//
// An int8 B (kInt8, int8_matmul.cu on bf16 x): each int8 tile is loaded one
// step ahead into registers and dequantized as it is stored to the ring,
// bf16(fp32(q) * scale[n]), the rounding of l3ac_tpu/ops/pallas/int8_matmul.py:37-38;
// the bias is bf16, added in fp32 before the output's one rounding. Any K
// and N: A by 16-byte copies where K % 8 == 0 (kVecA), else by plain loads
// with zero fill; the int8 rows by 4-byte loads where K % 4 == 0, else bytes.

using bf16 = __nv_bfloat16;

struct ParamsBf16 {
  const bf16* a;           // (M, K)
  const bf16* b;           // (N, K), or null for an int8 B
  const signed char* b_q;  // (N, K) int8 weight (kInt8)
  const float* scale;      // (N) its row scale
  const float* bias;       // (N) or null
  const bf16* bias16;      // (N) bf16 bias of an int8 B, or null
  const float* alpha;      // (N) snake
  const bf16* res;         // (M, N) residual
  bf16* out;               // (M, N)
  int M, N, K;
  int vec_out;             // N even and out 4-byte aligned: bf16 pairs
};

constexpr int kBf16Threads = 256;
constexpr int kBf16WM = 32, kBf16WN = 64;
constexpr int kBf16Row = kBK + 8;                 // bf16 elements
constexpr int kBf16Tile = kBM * kBf16Row;         // bf16 elements of one A or B tile
constexpr size_t kBf16Smem = sizeof(bf16) * kStages * 2 * kBf16Tile;

// rows [r0, r0 + 128) x K [k0, k0 + 32) of an (R, K) bf16 matrix, 16 bytes per copy
__device__ __forceinline__ void load_rows_bf16(bf16* dst, const bf16* src, long long r0,
                                               long long R, int k0, int K, int tid) {
#pragma unroll
  for (int i = 0; i < kBM * kBK / 8 / kBf16Threads; ++i) {
    const int c = tid + i * kBf16Threads, row = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
    const bool ok = r0 + row < R && k0 + col < K;
    const bf16* s = ok ? src + (r0 + row) * K + k0 + col : src;
    ptx::cp_async16(dst + row * kBf16Row + col, s, ok ? 16 : 0);
  }
}

// the same rows, any K and alignment: plain loads, zero past the edges
__device__ __forceinline__ void load_rows_bf16_any(bf16* dst, const bf16* src, long long r0,
                                                   long long R, int k0, int K, int tid) {
#pragma unroll 4
  for (int i = 0; i < kBM * kBK / kBf16Threads; ++i) {
    const int e = tid + i * kBf16Threads, row = e / kBK, col = e % kBK;
    const bool ok = r0 + row < R && k0 + col < K;
    dst[row * kBf16Row + col] = ok ? src[(r0 + row) * K + k0 + col] : __float2bfloat16_rn(0.0f);
  }
}

// An int8 B tile in registers (four 4-byte words, or sixteen bytes, per
// thread), stored to the ring dequantized: bf16(fp32(q) * scale[row]). A
// thread's rows are the same at every K step, so their scales are loaded once.
template <bool kVec>
struct QTileBf16 {
  static constexpr int kN = kVec ? kBN * kBK / 4 / kBf16Threads : kBN * kBK / kBf16Threads;
  static constexpr int kPer = kVec ? kBK / 4 : kBK;  // loads per row
  int v[kN];
  float sc[kN];

  __device__ __forceinline__ void scales(const ParamsBf16& p, int n0, int tid) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int row = (tid + i * kBf16Threads) / kPer;
      sc[i] = n0 + row < p.N ? p.scale[n0 + row] : 0.0f;
    }
  }

  __device__ __forceinline__ void load(const ParamsBf16& p, int n0, int k0, int tid) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int e = tid + i * kBf16Threads, row = e / kPer;
      const int col = kVec ? (e % kPer) * 4 : e % kPer;
      const bool ok = n0 + row < p.N && k0 + col < p.K;
      const signed char* s = p.b_q + static_cast<long long>(n0 + row) * p.K + k0 + col;
      if (kVec) v[i] = ok ? *reinterpret_cast<const int*>(s) : 0;
      else v[i] = ok ? static_cast<int>(*s) : 0;
    }
  }

  __device__ __forceinline__ void store(bf16* dst, int tid) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int e = tid + i * kBf16Threads, row = e / kPer;
      if (kVec) {
        const int col = (e % kPer) * 4, w = v[i];  // little endian: byte j is k = col + j
        const float q0 = static_cast<float>(static_cast<signed char>(w & 0xff));
        const float q1 = static_cast<float>(static_cast<signed char>((w >> 8) & 0xff));
        const float q2 = static_cast<float>(static_cast<signed char>((w >> 16) & 0xff));
        const float q3 = static_cast<float>(w >> 24);
        *reinterpret_cast<uint2*>(dst + row * kBf16Row + col) =
            make_uint2(ptx::bf16x2_rn(q0 * sc[i], q1 * sc[i]), ptx::bf16x2_rn(q2 * sc[i], q3 * sc[i]));
      } else {
        dst[row * kBf16Row + e % kPer] = __float2bfloat16_rn(static_cast<float>(v[i]) * sc[i]);
      }
    }
  }
};

// kInt8: B is p.b_q (QTileBf16), the bias p.bias16; kVecA / kVecB: A by
// 16-byte copies, the int8 rows by 4-byte loads
template <Epi kEpi, bool kInt8 = false, bool kVecA = true, bool kVecB = true>
__global__ void __launch_bounds__(kBf16Threads, 1) gemm_bf16_kernel(const ParamsBf16 p) {
  extern __shared__ __align__(16) float smem_f[];
  bf16* smem = reinterpret_cast<bf16*>(smem_f);
  constexpr int kMT = kBf16WM / 16, kNT = kBf16WN / 8, kWarpsN = kBN / kBf16WN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const long long m0 = static_cast<long long>(blockIdx.y) * kBM;
  const int n0 = blockIdx.x * kBN;
  const int steps = (p.K + kBK - 1) / kBK;
  auto stage_in = [&](int s) {
    bf16* st = smem + (s % kStages) * 2 * kBf16Tile;
    if constexpr (kVecA) load_rows_bf16(st, p.a, m0, p.M, s * kBK, p.K, tid);
    else load_rows_bf16_any(st, p.a, m0, p.M, s * kBK, p.K, tid);
    if constexpr (!kInt8) load_rows_bf16(st + kBf16Tile, p.b, n0, p.N, s * kBK, p.K, tid);
  };
  QTileBf16<kVecB> qt;
  if constexpr (kInt8) qt.scales(p, n0, tid);
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      stage_in(s);
      if constexpr (kInt8) {
        qt.load(p, n0, s * kBK, tid);
        qt.store(smem + s * 2 * kBf16Tile + kBf16Tile, tid);
      }
    }
    ptx::cp_async_commit();
  }
  const int q = lane >> 3, r = lane & 7;
  const int oa = (wm * kBf16WM + (q & 1) * 8 + r) * kBf16Row + (q >> 1) * 8;
  const int ob = (wn * kBf16WN + (q >> 1) * 8 + r) * kBf16Row + (q & 1) * 8;

  float sum[kMT][kNT][4], acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[mt][nt][i] = 0.0f;

  for (int s = 0; s < steps; ++s) {
    ptx::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = s + kStages - 1;
    if (next < steps) {
      stage_in(next);
      if constexpr (kInt8) qt.load(p, n0, next * kBK, tid);  // in flight during the products
    }
    ptx::cp_async_commit();
    const bf16* sA = smem + (s % kStages) * 2 * kBf16Tile;
    const bf16* sB = sA + kBf16Tile;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t b[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        uint32_t t[4];
        ptx::ldmatrix_x4(t, sB + ob + j * 16 * kBf16Row + ks * 16);
        b[2 * j][0] = t[0], b[2 * j][1] = t[1], b[2 * j + 1][0] = t[2], b[2 * j + 1][1] = t[3];
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        uint32_t af[4];
        ptx::ldmatrix_x4(af, sA + oa + mt * 16 * kBf16Row + ks * 16);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) ptx::mma_bf16(acc[mt][nt], af, b[nt]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[mt][nt][i] += acc[mt][nt][i];
    if constexpr (kInt8) {
      if (next < steps) qt.store(smem + (next % kStages) * 2 * kBf16Tile + kBf16Tile, tid);
    }
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int n = n0 + wn * kBf16WN + nt * 8 + 2 * t;
    if (n >= p.N) continue;
    if constexpr (kInt8) {  // any N: pairs where both columns exist and out allows
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long m = m0 + wm * kBf16WM + mt * 16 + g + h * 8;
          if (m >= p.M) continue;
          float v[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float bj = (n + j < p.N && p.bias16 != nullptr) ? __bfloat162float(p.bias16[n + j])
                                                                   : 0.0f;
            v[j] = sum[mt][nt][2 * h + j] + bj;
          }
          const long long o = m * p.N + n;
          if (p.vec_out && n + 1 < p.N) {
            *reinterpret_cast<uint32_t*>(p.out + o) = ptx::bf16x2_rn(v[0], v[1]);
          } else {
            p.out[o] = __float2bfloat16_rn(v[0]);
            if (n + 1 < p.N) p.out[o + 1] = __float2bfloat16_rn(v[1]);
          }
        }
      continue;
    }
    // N is even: n + 1 < N too
    const float cb[2] = {p.bias != nullptr ? p.bias[n] : 0.0f,
                         p.bias != nullptr ? p.bias[n + 1] : 0.0f};
    const float ca[2] = {kEpi == Epi::kSnake ? p.alpha[n] : 1.0f,
                         kEpi == Epi::kSnake ? p.alpha[n + 1] : 1.0f};
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + wm * kBf16WM + mt * 16 + g + h * 8;
        if (m >= p.M) continue;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) v[j] = finish<false, kEpi>(sum[mt][nt][2 * h + j], 1.0f, cb[j], ca[j]);
        const long long o = m * p.N + n;
        if constexpr (kEpi == Epi::kResidual) {
          const uint32_t rv = *reinterpret_cast<const uint32_t*>(p.res + o);
          v[0] += __uint_as_float(rv << 16);
          v[1] += __uint_as_float(rv & 0xffff0000u);
        }
        *reinterpret_cast<uint32_t*>(p.out + o) = ptx::bf16x2_rn(v[0], v[1]);
      }
  }
}

template <Epi kEpi>
cudaError_t launch_gemm_bf16(const ParamsBf16& p, cudaStream_t s) {
  const long long m_tiles = (static_cast<long long>(p.M) + kBM - 1) / kBM;
  if (p.M < 1 || p.N < 2 || p.N % 2 != 0 || p.K < 8 || p.K % 8 != 0 || m_tiles > 65535 ||
      !aligned(p.a, 16) || !aligned(p.b, 16) || !aligned(p.out, 4) ||
      (p.res != nullptr && !aligned(p.res, 4)))
    return cudaErrorInvalidValue;
  auto kernel = gemm_bf16_kernel<kEpi>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kBf16Smem));
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(p.N, kBN), static_cast<unsigned>(m_tiles));
  kernel<<<grid, kBf16Threads, kBf16Smem, s>>>(p);
  return cudaGetLastError();
}

// y = x . bf16(q * scale)^T + bf16 bias, bf16 out: the int8 B path above
template <bool kVecA, bool kVecB>
cudaError_t launch_gemm_int8_bf16(ParamsBf16 p, cudaStream_t s) {
  const long long m_tiles = (static_cast<long long>(p.M) + kBM - 1) / kBM;
  if (p.M < 1 || p.N < 1 || p.K < 1 || m_tiles > 65535) return cudaErrorInvalidValue;
  p.vec_out = p.N % 2 == 0 && aligned(p.out, 4);
  auto kernel = gemm_bf16_kernel<Epi::kBias, true, kVecA, kVecB>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kBf16Smem));
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(p.N, kBN), static_cast<unsigned>(m_tiles));
  kernel<<<grid, kBf16Threads, kBf16Smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace l3ac::tc

// The former bf16 core: epi 1 snake(a w^T + b), 3 res + a w^T + b (bf16 a, w,
// res, out; fp32 bias, alpha). K % 8 == 0, N even, 16-byte aligned rows.
extern "C" int l3ac_tcv_bf16_mma(const void* a, const void* w, const float* bias,
                                 const float* alpha, const void* res, void* out, int M, int N,
                                 int K, int epi, void* stream) {
  using namespace l3ac::tc;
  ParamsBf16 p{};
  p.a = static_cast<const bf16*>(a), p.b = static_cast<const bf16*>(w), p.bias = bias;
  p.alpha = alpha, p.res = static_cast<const bf16*>(res), p.out = static_cast<bf16*>(out);
  p.M = M, p.N = N, p.K = K;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return epi == 1 ? launch_gemm_bf16<Epi::kSnake>(p, s) : launch_gemm_bf16<Epi::kResidual>(p, s);
}

// The former bf16 core on an int8 weight: y = x . bf16(q s)^T + bf16 bias.
extern "C" int l3ac_tcv_int8_bf16_mma(const void* x, const signed char* w_q, const float* scale,
                                      const void* bias, void* out, int M, int N, int K,
                                      void* stream) {
  using namespace l3ac::tc;
  ParamsBf16 p{};
  p.a = static_cast<const bf16*>(x), p.b_q = w_q, p.scale = scale;
  p.bias16 = static_cast<const bf16*>(bias), p.out = static_cast<bf16*>(out);
  p.M = M, p.N = N, p.K = K;
  const bool vec_a = K % 8 == 0 && aligned(x, 16), vec_b = K % 4 == 0 && aligned(w_q, 4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_a)
    return vec_b ? launch_gemm_int8_bf16<true, true>(p, s) : launch_gemm_int8_bf16<true, false>(p, s);
  return vec_b ? launch_gemm_int8_bf16<false, true>(p, s) : launch_gemm_int8_bf16<false, false>(p, s);
}
