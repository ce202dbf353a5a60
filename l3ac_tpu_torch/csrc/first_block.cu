// Encoder stem (FirstBlock) as one fused kernel, audio (B, T) -> features (B, Cout, T).
//
// Replaces l3ac_tpu/ops/pallas/first_block.py:first_block_ct (body _kernel).
//   5 branches, pool k in {1, 5, 11, 21, 45}: |x| -> max-pool k -> avg-pool k
//   (torch pads: max -inf, avg 0 and always / k; k = 1 is the raw signal)
//   -> conv 1->4, k7, zero pad 3; concat (20) -> 1x1 20->80 -> exact GELU
//   -> concat the raw sample (81) -> 1x1 81->Cout.
//
// Semantics follow the plain (jnp) path: the pooled branch signals are zero
// outside [0, T) before the k7 branch conv, as conv1d zero-pads a length-T
// signal. (The Pallas kernel leaves them unmasked there, which changes the
// first and last three output columns.)
//
// Bound on the H100: about 3.7k multiply-adds per output column against 4 bytes
// read and 4 Cout bytes written, so the fp32 SIMT rate bounds it, not memory.
// Design: one block per (batch, 256-column tile), one thread per output column;
// the audio tile with a halo of 2 * 22 + 3 = 47 samples and the four pooled
// signals live in shared memory, the 20 branch outputs and the 80 hidden
// activations of a column live in registers, so nothing between the audio and
// the output touches device memory.
#include "common.cuh"

namespace {

constexpr int kTile = 256;                     // output columns = threads per block
constexpr int kMaxP = 22;                      // 45 // 2
constexpr int kHalo = 2 * kMaxP + 3;           // 47
constexpr int kXLen = kTile + 2 * kHalo;       // staged audio
constexpr int kALen = kTile + 6;               // pooled signal incl. the k7 halo
constexpr int kMLen = kALen + 2 * kMaxP;       // max-pooled signal, widest branch
constexpr int kBranches = 5;
constexpr int kHid = 20;                       // 5 branches x 4 channels
constexpr int kMid = 80;
constexpr int kMaxCout = 64;

// avg_pool_k(max_pool_k(|x|)) over [t0 - 3, t0 + kTile + 3), zero outside [0, T).
// Both reductions run in index order, the summation order of ops/pool.py.
template <int K>
__device__ void trend_pool_tile(const float* xs, float* ms, float* as, long long t0, int T) {
  constexpr int p = K / 2;
  for (int r = threadIdx.x; r < kALen + 2 * p; r += kTile) {
    const long long v = t0 - 3 - p + r;
    float m = 0.0f;
    if (v >= 0 && v < T) {
      const float* src = xs + r + (kHalo - 3) - 2 * p;  // x[v - p] .. x[v + p]
      m = fabsf(src[0]);
#pragma unroll
      for (int d = 1; d < K; ++d) m = fmaxf(m, fabsf(src[d]));
    }
    ms[r] = m;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < kALen; s += kTile) {
    const long long u = t0 - 3 + s;
    float a = 0.0f;
    if (u >= 0 && u < T) {
      float acc = ms[s];
#pragma unroll
      for (int d = 1; d < K; ++d) acc += ms[s + d];
      a = acc / static_cast<float>(K);
    }
    as[s] = a;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kTile)
first_block_kernel(const float* __restrict__ x, const float* __restrict__ wb,
                   const float* __restrict__ bb, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, float* __restrict__ out, int T, int Cout) {
  __shared__ float xs[kXLen];
  __shared__ float ms[kMLen];
  __shared__ float as[kBranches - 1][kALen];
  __shared__ float wbs[kHid * 7];
  __shared__ float bbs[kHid];
  __shared__ float w1s[kMid * kHid];
  __shared__ float b1s[kMid];
  __shared__ float w2s[kMaxCout * (kMid + 1)];
  __shared__ float b2s[kMaxCout];

  const int b = blockIdx.y;
  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  const float* xb = x + static_cast<long long>(b) * T;

  for (int i = threadIdx.x; i < kXLen; i += kTile) {
    const long long g = t0 - kHalo + i;
    xs[i] = (g >= 0 && g < T) ? xb[g] : 0.0f;
  }
  for (int i = threadIdx.x; i < kHid * 7; i += kTile) wbs[i] = wb[i];
  for (int i = threadIdx.x; i < kMid * kHid; i += kTile) w1s[i] = w1[i];
  for (int i = threadIdx.x; i < Cout * (kMid + 1); i += kTile) w2s[i] = w2[i];
  if (threadIdx.x < kHid) bbs[threadIdx.x] = bb[threadIdx.x];
  if (threadIdx.x < kMid) b1s[threadIdx.x] = b1[threadIdx.x];
  if (threadIdx.x < Cout) b2s[threadIdx.x] = b2[threadIdx.x];
  __syncthreads();

  trend_pool_tile<5>(xs, ms, as[0], t0, T);
  trend_pool_tile<11>(xs, ms, as[1], t0, T);
  trend_pool_tile<21>(xs, ms, as[2], t0, T);
  trend_pool_tile<45>(xs, ms, as[3], t0, T);

  const int j = threadIdx.x;
  const long long t = t0 + j;
  if (t >= T) return;  // no barrier follows

  // branch convs 1 -> 4, k7, pad 3: out[t] = b + sum_k w[k] a[t - 3 + k]
  float h[kHid];
#pragma unroll
  for (int br = 0; br < kBranches; ++br) {
    // branch 0 (k = 1) is the raw signal: a[u] = x[u] = xs[s + 44] for u = t0 - 3 + s
    const float* a = (br == 0) ? (xs + (kHalo - 3)) : as[br - 1];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float acc = bbs[br * 4 + c];
#pragma unroll
      for (int k = 0; k < 7; ++k) acc += wbs[(br * 4 + c) * 7 + k] * a[j + k];
      h[br * 4 + c] = acc;
    }
  }

  // 1x1 20 -> 80 and exact GELU
  float g[kMid];
#pragma unroll
  for (int m = 0; m < kMid; ++m) {
    float z = b1s[m];
#pragma unroll
    for (int i = 0; i < kHid; ++i) z += w1s[m * kHid + i] * h[i];
    g[m] = l3ac::gelu(z);
  }

  // concat the raw sample, 1x1 81 -> Cout
  const float xt = xs[j + kHalo];
  float* ob = out + static_cast<long long>(b) * Cout * T + t;
  for (int c = 0; c < Cout; ++c) {
    const float* wr = w2s + c * (kMid + 1);
    float y = b2s[c];
#pragma unroll
    for (int m = 0; m < kMid; ++m) y += wr[m] * g[m];
    y += wr[kMid] * xt;
    ob[static_cast<long long>(c) * T] = y;
  }
}

}  // namespace

// x: (B, T) audio; wb: (5, 4, 7) branch weights (torch layout, the in-channel
// axis squeezed); bb: (5, 4); w1: (80, 20); b1: (80); w2: (Cout, 81); b2: (Cout);
// out: (B, Cout, T). All fp32 and contiguous. Returns the CUDA error code.
extern "C" int l3ac_first_block(const float* x, const float* wb, const float* bb,
                                const float* w1, const float* b1, const float* w2,
                                const float* b2, float* out, int B, int T, int Cout,
                                void* stream) {
  if (Cout < 1 || Cout > kMaxCout || B < 1 || T < 1) return cudaErrorInvalidValue;
  dim3 grid(l3ac::ceil_div(T, kTile), B);
  first_block_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      x, wb, bb, w1, b1, w2, b2, out, T, Cout);
  return static_cast<int>(cudaGetLastError());
}
