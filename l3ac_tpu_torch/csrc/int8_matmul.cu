// int8 weight-only dense layer: y = x @ (w_q * scale)^T + b, fp32 in and out.
//
// Replaces l3ac_tpu/ops/pallas/int8_matmul.py:int8_matmul (body _kernel).
// x: (M, K) fp32; w_q: (N, K) int8 (nn.Linear layout); scale, b: (N) fp32.
//
// Bound on the H100: 2 M K N operations against 4 M (K + N) + K N bytes, so
// at the codec's shapes (K, N <= 2048, M in the thousands) the fp32 rate
// bounds it, not memory. The TPU kernel keeps the whole (K, N) weight in VMEM
// and tiles only M; a block here has at most 227 KB, so the weight is tiled
// in N and K as well.
// Design: one block per 128 x 64 output tile, 256 threads, each with an 8 x 4
// tile of fp32 sums in registers. K is walked in steps of 32: the x chunk
// (128 x 32 fp32) and the w_q chunk (64 x 32 int8, dequantized as
// float(q) * scale, the rounding of the plain version) go to shared memory,
// both stored K-major so that the inner loop reads x and w as float4. Every
// load is scalar and masked: K = 341 and N = 682 leave rows unaligned.
// Device memory sees only the 1-byte weight. SIMT fp32 FMAs (wgmma needs a
// narrower activation type).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;        // output rows per block
constexpr int kBN = 64;         // output columns per block
constexpr int kBK = 32;         // K step
constexpr int kTM = 8;          // rows per thread
constexpr int kTN = 4;          // columns per thread
constexpr int kXS = kBM + 4;    // x chunk row stride: (4 k + m) % 32 spreads the stores over banks
constexpr int kWS = kBN + 4;    // w chunk row stride, the same for (4 k + n)

static_assert(kThreads == (kBM / kTM) * (kBN / kTN), "one micro-tile per thread");

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const float* __restrict__ x, const signed char* __restrict__ w_q,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float xs[kBK * kXS];  // xs[k][m]
  __shared__ __align__(16) float ws[kBK * kWS];  // ws[k][n], dequantized

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);  // column quad
  const int ty = tid / (kBN / kTN);  // row octet
  const long long m0 = static_cast<long long>(blockIdx.y) * kBM;
  const int n0 = blockIdx.x * kBN;

  // staging map: within each group of 32 elements, 8 consecutive k by 4 rows,
  // so a warp reads 4 runs of 8 along K and stores to 32 distinct banks
  float sc[kBN * kBK / kThreads];
#pragma unroll
  for (int i = 0; i < kBN * kBK / kThreads; ++i) {
    const int e = tid + i * kThreads, g = e / 32;
    const int n = (g / 4) * 4 + (e / 8) % 4;
    sc[i] = n0 + n < N ? scale[n0 + n] : 0.0f;
  }

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int e = tid + i * kThreads, g = e / 32;
      const int k = (g % 4) * 8 + e % 8, m = (g / 4) * 4 + (e / 8) % 4;
      const long long gm = m0 + m;
      const int gk = k0 + k;
      xs[k * kXS + m] = (gm < M && gk < K) ? x[gm * K + gk] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBN * kBK / kThreads; ++i) {
      const int e = tid + i * kThreads, g = e / 32;
      const int k = (g % 4) * 8 + e % 8, n = (g / 4) * 4 + (e / 8) % 4;
      const int gn = n0 + n, gk = k0 + k;
      ws[k * kWS + n] = (gn < N && gk < K)
          ? static_cast<float>(w_q[static_cast<long long>(gn) * K + gk]) * sc[i] : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(xs + k * kXS + ty * kTM);
      const float4 a1 = *reinterpret_cast<const float4*>(xs + k * kXS + ty * kTM + 4);
      const float4 bv = *reinterpret_cast<const float4*>(ws + k * kWS + tx * kTN);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bw[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();  // the chunks are rewritten by the next step
  }

  const int nq = n0 + tx * kTN;
  float bn[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) bn[j] = (bias != nullptr && nq + j < N) ? bias[nq + j] : 0.0f;
  const bool quad = N % 4 == 0 && nq + kTN <= N;  // 16-byte aligned, all in range
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + ty * kTM + i;
    if (m >= M) break;
    float* o = out + m * N + nq;
    if (quad) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[i][0] + bn[0], acc[i][1] + bn[1],
                                                  acc[i][2] + bn[2], acc[i][3] + bn[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        if (nq + j < N) o[j] = acc[i][j] + bn[j];
    }
  }
}

}  // namespace

// x: (M, K) fp32; w_q: (N, K) int8; scale: (N) fp32; bias: (N) fp32 or null;
// out: (M, N) fp32. All contiguous, out not aliasing x. Returns the CUDA
// error code.
extern "C" int l3ac_int8_matmul(const float* x, const signed char* w_q, const float* scale,
                                const float* bias, float* out, int M, int N, int K,
                                void* stream) {
  if (M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
  const long long m_tiles = (static_cast<long long>(M) + kBM - 1) / kBM;
  if (m_tiles > 65535) return cudaErrorInvalidValue;
  dim3 grid(l3ac::ceil_div(N, kBN), static_cast<unsigned>(m_tiles));
  int8_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w_q, scale, bias, out, M, N, K);
  return cudaGetLastError();
}
