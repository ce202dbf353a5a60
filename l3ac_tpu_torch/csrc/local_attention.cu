// Block-local causal attention with an additive position bias, fp32.
//
// Replaces l3ac_tpu/ops/pallas/local_attention.py:local_attention (body
// _attn_kernel). q, k, v, out: (B, H, T, D) with D <= 32, T a multiple of the
// window n; bias: (H, n, 2n) or null. Query i of window w attends to key j of
// [window w-1 | window w] (global key row (w-1) n + j) iff j <= n + i, and in
// window 0 only to j >= n (its previous block does not exist). Scores are
// (q * D^-0.5) . k + bias[h, i, j]; the softmax is fp32.
//
// Bound on the H100: 4 D fp32 operations per valid (query, key) pair; the
// fp32 rate bounds it. Design: one block per (64-query tile, window,
// batch * head); 8 warps of 8 query rows each. Keys and values stream through
// shared memory in tiles of 64, only up to the causal limit of the tile's last
// row. Per row, lane l scores keys l and l + 32 of the tile, the warp reduces
// max and sum (online softmax), and lane d < D accumulates output element d,
// so the score matrix never reaches device memory.
#include "common.cuh"

namespace {

constexpr int kD = 32;      // largest head dim: one lane per output element
constexpr int kRows = 64;   // query rows per block
constexpr int kKeys = 64;   // keys per shared tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kRows / kWarps;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
local_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ bias,
                       float* __restrict__ out, int H, int T, int n, int D, float scale) {
  __shared__ float qs[kRows][kD];
  __shared__ float ks[kKeys][kD + 1];
  __shared__ float vs[kKeys][kD];
  __shared__ float ps[kWarps][kKeys];

  const int i0 = blockIdx.x * kRows;
  const int w = blockIdx.y;
  const int bh = blockIdx.z;
  const int h = bh % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long base = static_cast<long long>(bh) * T * D;
  const int rows = min(kRows, n - i0);
  const long long q0 = static_cast<long long>(w) * n + i0;  // global row of query i0

  for (int e = tid; e < kRows * kD; e += kThreads) {
    const int r = e / kD, d = e % kD;
    qs[r][d] = (r < rows && d < D) ? q[base + (q0 + r) * D + d] * scale : 0.0f;
  }

  const int j_begin = (w == 0) ? n : 0;
  const int j_end = n + i0 + rows;           // one past the last row's last key
  const long long k0 = static_cast<long long>(w) * n - n;  // global row of key j = 0

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.0f;
    acc[rr] = 0.0f;
  }

  for (int j0 = j_begin; j0 < j_end; j0 += kKeys) {
    __syncthreads();  // the previous tile is consumed; qs is loaded
    for (int e = tid; e < kKeys * kD; e += kThreads) {
      const int jj = e / kD, d = e % kD;
      const int j = j0 + jj;
      float kv = 0.0f, vv = 0.0f;
      if (j < j_end && d < D) {
        const long long g = base + (k0 + j) * D + d;
        kv = k[g];
        vv = v[g];
      }
      ks[jj][d] = kv;
      vs[jj][d] = vv;
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      if (r < rows) {  // warp-uniform
        const int i = i0 + r;
        const int ja = j0 + lane, jb = ja + 32;
        const bool va = ja <= n + i, vb = jb <= n + i;  // j < 2n follows
        float sa = 0.0f, sb = 0.0f;
#pragma unroll
        for (int d = 0; d < kD; ++d) {
          const float qd = qs[r][d];
          sa += qd * ks[lane][d];
          sb += qd * ks[lane + 32][d];
        }
        if (bias != nullptr) {
          const float* br = bias + (static_cast<long long>(h) * n + i) * (2 * n);
          if (va) sa += br[ja];
          if (vb) sb += br[jb];
        }
        sa = va ? sa : -INFINITY;
        sb = vb ? sb : -INFINITY;
        const float tmax = warp_max(fmaxf(sa, sb));
        if (tmax != -INFINITY) {  // warp-uniform: some key of the tile is valid
          const float m_new = fmaxf(m[rr], tmax);
          const float corr = expf(m[rr] - m_new);  // 0 on the first valid tile
          const float pa = va ? expf(sa - m_new) : 0.0f;
          const float pb = vb ? expf(sb - m_new) : 0.0f;
          l[rr] = l[rr] * corr + warp_sum(pa + pb);
          ps[warp][lane] = pa;
          ps[warp][lane + 32] = pb;
          __syncwarp();
          float o = acc[rr] * corr;
#pragma unroll 16
          for (int jj = 0; jj < kKeys; ++jj) o += ps[warp][jj] * vs[jj][lane];
          acc[rr] = o;
          m[rr] = m_new;
          __syncwarp();  // ps is rewritten by the next row
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    if (r < rows && lane < D) out[base + (q0 + r) * D + lane] = acc[rr] / l[rr];
  }
}

}  // namespace

// q, k, v, out: (BH, T, D) fp32 contiguous, D <= 32 (batch and head
// flattened, head index = row % H); bias: (H, n, 2n) or null. Returns the
// CUDA error code.
extern "C" int l3ac_local_attention(const float* q, const float* k, const float* v,
                                    const float* bias, float* out, int BH, int H, int T,
                                    int n, int D, float scale, void* stream) {
  if (BH < 1 || H < 1 || BH % H || n < 1 || T % n || T / n > 65535 || BH > 65535 ||
      D < 1 || D > kD)
    return cudaErrorInvalidValue;
  dim3 grid(l3ac::ceil_div(n, kRows), T / n, BH);
  local_attention_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, bias, out, H, T, n, D, scale);
  return static_cast<int>(cudaGetLastError());
}
