// The decoder's legacy tail as one kernel, audio out:
//   3 x [x + conv1x1(snake(conv_k7,dil d(snake x)))], d = 1, 3, 9
//   -> snake -> conv k7 C -> 1 -> tanh
// with every conv zero-padded at the sequence edges (the activations are
// zeroed outside [0, T) after every conv).
//
// Replaces l3ac_tpu/ops/pallas/legacy_tail.py:legacy_tail_poly_ct (body
// _kernel_poly, input = the two stride-2 phase arrays of the last up path)
// and :legacy_tail_ct (body _kernel, one interleaved (B, C, T) input): one
// kernel, two input modes (x1 null: interleaved).
//
// Bound on the H100: ~28 k fp32 operations per sample (7 C^2 + C^2 FMAs per
// unit, three units, at C = 24) against 4 C bytes read and 4 written: the
// fp32 rate, not memory.
// Design: one block per (batch, tile of S = W - 84 samples), 256 threads,
// W = 768 working columns (the tile and a 42-sample halo per side).
//   - The input is loaded in interleaved time order whichever mode it has
//     (phase mode reads x_{g & 1}[g >> 1]), zero outside [0, T). The Pallas
//     kernel routes each k7 tap to a phase because Mosaic cannot interleave
//     lanes; on Hopper the interleave is the load address.
//   - Shared memory holds the residual stream X (C, W), one activation buffer
//     A (C, W + 54) whose 27-column margins stay zero (taps past the window
//     read zero; those columns lie in the halo and never reach the output),
//     and all weights (w1 as (k, Cin, Cout) so that a float4 load gives four
//     output channels).
//   - Each thread owns 3 columns. A k7 conv accumulates 3 x C outputs in
//     registers from A, then (after a barrier) writes them back into A through
//     the snake; the 1x1 conv and the residual add are column-private.
//   - Only the audio (B, T) is written.
// Exact sinf and IEEE division in the snake (common.cuh), tanhf, no fast math.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 3;                  // columns per thread
constexpr int kW = kThreads * kCols;      // working columns per block
constexpr int kHalo = 42;                 // 3 (1 + 3 + 9) + 3
constexpr int kS = kW - 2 * kHalo;        // output samples per block
constexpr int kPad = 27;                  // 3 x the largest dilation
constexpr int kWA = kW + 2 * kPad;

template <int C>
__host__ __device__ constexpr int weight_floats() {
  return (3 * 7 * C * C + 3 * C * C + 12 * C + C + 7 * C + 1 + 3) / 4 * 4;
}

struct Args {
  const float* x0;   // (B, C, T) interleaved, or the even phase (B, C, T / 2)
  const float* x1;   // null, or the odd phase
  const float* wts;  // packed weights, see legacy_tail.py:pack
  float* out;        // (B, T)
  int T;
  long long xB, xC;  // batch and channel strides of x0 and x1
};

template <int C>
__global__ void __launch_bounds__(kThreads) legacy_tail_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* X = smem;              // (C, kW) residual stream
  float* A = X + C * kW;        // (C, kWA) activations, column n at A[c kWA + kPad + n]
  float* wsm = A + C * kWA;
  const float* W1 = wsm;                  // (3, 7, C, C)
  const float* W2 = W1 + 3 * 7 * C * C;   // (3, C, C)
  const float* B1 = W2 + 3 * C * C;       // (3, C)
  const float* A1 = B1 + 3 * C;
  const float* A2 = A1 + 3 * C;
  const float* B2 = A2 + 3 * C;
  const float* AO = B2 + 3 * C;           // (C)
  const float* WO = AO + C;               // (7, C)
  const float* BO = WO + 7 * C;           // (1)

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const long long g0 = static_cast<long long>(blockIdx.x) * kS - kHalo;  // time of column 0

  for (int i = tid; i < weight_floats<C>() / 4; i += kThreads)
    reinterpret_cast<float4*>(wsm)[i] = __ldg(reinterpret_cast<const float4*>(a.wts) + i);
  for (int i = tid; i < C * kWA; i += kThreads) A[i] = 0.0f;
  const float* xb0 = a.x0 + b * a.xB;
  const float* xb1 = a.x1 == nullptr ? nullptr : a.x1 + b * a.xB;
  for (int e = tid; e < C * kW; e += kThreads) {
    const int c = e / kW, n = e - c * kW;
    const long long g = g0 + n;
    float v = 0.0f;
    if (g >= 0 && g < a.T) {
      if (xb1 == nullptr) v = xb0[c * a.xC + g];
      else v = ((g & 1) ? xb1 : xb0)[c * a.xC + (g >> 1)];
    }
    X[e] = v;
  }
  __syncthreads();

  bool valid[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const long long g = g0 + tid + kThreads * i;
    valid[i] = g >= 0 && g < a.T;
  }

  for (int u = 0; u < 3; ++u) {
    const int d = u == 0 ? 1 : (u == 1 ? 3 : 9);
    // A = snake(X): column-private
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int n = tid + kThreads * i;
      for (int c = 0; c < C; ++c)
        A[c * kWA + kPad + n] = l3ac::snake(X[c * kW + n], A1[u * C + c]);
    }
    __syncthreads();

    // k7 conv at dilation d, C -> C, into registers
    float acc[kCols][C];
#pragma unroll
    for (int i = 0; i < kCols; ++i)
#pragma unroll
      for (int o = 0; o < C; ++o) acc[i][o] = B1[u * C + o];
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const int off = kPad + (k - 3) * d + tid;
      const float* wk = W1 + (u * 7 + k) * C * C;
#pragma unroll 4
      for (int c = 0; c < C; ++c) {
        float av[kCols];
#pragma unroll
        for (int i = 0; i < kCols; ++i) av[i] = A[c * kWA + off + kThreads * i];
        const float4* wr = reinterpret_cast<const float4*>(wk + c * C);
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
          const float4 wv = wr[q];
#pragma unroll
          for (int i = 0; i < kCols; ++i) {
            acc[i][4 * q] += wv.x * av[i];
            acc[i][4 * q + 1] += wv.y * av[i];
            acc[i][4 * q + 2] += wv.z * av[i];
            acc[i][4 * q + 3] += wv.w * av[i];
          }
        }
      }
    }
    __syncthreads();  // every read of A is done

    // A = snake(conv), zero outside [0, T); then the 1x1 conv and the
    // residual, zero outside [0, T): both column-private
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int n = tid + kThreads * i;
#pragma unroll
      for (int o = 0; o < C; ++o)
        A[o * kWA + kPad + n] = valid[i] ? l3ac::snake(acc[i][o], A2[u * C + o]) : 0.0f;
      float h[C];
#pragma unroll
      for (int o = 0; o < C; ++o) h[o] = B2[u * C + o];
      for (int c = 0; c < C; ++c) {
        const float av = A[c * kWA + kPad + n];
        const float4* wr = reinterpret_cast<const float4*>(W2 + (u * C + c) * C);
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
          const float4 wv = wr[q];
          h[4 * q] += wv.x * av;
          h[4 * q + 1] += wv.y * av;
          h[4 * q + 2] += wv.z * av;
          h[4 * q + 3] += wv.w * av;
        }
      }
#pragma unroll
      for (int o = 0; o < C; ++o)
        X[o * kW + n] = valid[i] ? X[o * kW + n] + h[o] : 0.0f;
    }
    // the next unit's snake writes only this thread's columns of A; the
    // barrier after it orders that before any neighbour reads
  }

  // snake -> conv k7 C -> 1 -> tanh
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int n = tid + kThreads * i;
    for (int c = 0; c < C; ++c) A[c * kWA + kPad + n] = l3ac::snake(X[c * kW + n], AO[c]);
  }
  __syncthreads();
  float* ob = a.out + b * static_cast<long long>(a.T);
  for (int j = tid; j < kS; j += kThreads) {
    const long long g = g0 + kHalo + j;
    if (g >= a.T) break;
    const int n = kHalo + j;
    float y = BO[0];
    for (int k = 0; k < 7; ++k)
      for (int c = 0; c < C; ++c) y += WO[k * C + c] * A[c * kWA + kPad + n + k - 3];
    ob[g] = tanhf(y);
  }
}

template <int C>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(C) * (kW + kWA) + weight_floats<C>());
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(legacy_tail_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(l3ac::ceil_div(a.T, kS), B);
  legacy_tail_kernel<C><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x0 (and x1): (B, C, T) interleaved with x1 null, or the phase pair
// (B, C, T / 2) with x[2t + q] = x_q[t]; xB, xC their batch and channel
// strides (time contiguous). wts: legacy_tail.py:pack. out: (B, T).
// C in {8, 12, 16, 24}. All fp32. Returns the CUDA error code.
extern "C" int l3ac_legacy_tail(const float* x0, const float* x1, const float* wts,
                                float* out, int B, int C, int T, long long xB,
                                long long xC, void* stream) {
  if (B < 1 || T < 1 || (x1 != nullptr && T % 2 != 0)) return cudaErrorInvalidValue;
  const Args a{x0, x1, wts, out, T, xB, xC};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return launch<8>(a, B, s);
    case 12: return launch<12>(a, B, s);
    case 16: return launch<16>(a, B, s);
    case 24: return launch<24>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}
