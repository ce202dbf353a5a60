// The bf16 local attention as the port ran it from PR 11 to PR 14 (PERF.md
// §6 row 3b, "PR 12 kernel"): one block per (64-query tile, window,
// batch * head), 4 warps of 16 query rows, K / V tiles of 64 keys through a
// 2-stage cp.async ring of 8-byte pieces with a block barrier per tile, both
// products one mma.sync m16n8k16 bf16 pass (K by ldmatrix, V by
// ldmatrix.trans), q scaled in bf16 in shared memory, the mask, the bias and
// the online softmax in fp32 with expf. Built only by
// tools/attention_variants.py --bf16, as the baseline of the redesign in
// csrc/local_attention_bf16.cu and the ground of its ablations.
#include "common.cuh"
#include "ptx.cuh"

namespace {

namespace ptx = l3ac::ptx;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows per block: one m16 tile per warp
constexpr int kKeys = 64;           // keys per tile: 8 n8 tiles of S
constexpr int kStages = 2;          // K / V ring
constexpr int kMaxD8 = 16;          // D <= 128

enum BiasMode { kNoBias = 0, kFullBias = 1, kTableBias = 2 };

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

using bf16 = __nv_bfloat16;

struct ArgsBf16 {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* bias;   // (H, n, 2n), kFullBias
  const bf16* table;  // (2n, H), kTableBias
  bf16* out;          // (B, T, H, D) contiguous
  long long qs[3], ks[3], vs[3];  // B, H, T strides in elements
  int H, T, n, D;
  float scale;        // D^-1/2 rounded to bf16
};

// Row strides in bf16 elements: 16 kD16 + 8, an odd number of 16-byte
// pieces, so the eight rows of an ldmatrix tile (plain or .trans) fall in
// distinct banks.
template <int kD16>
struct LayoutBf16 {
  static constexpr int row = 16 * kD16 + 8;
  static constexpr int ktile = kKeys * row;
  static constexpr int stage = 2 * ktile;            // K, then V
  static constexpr int q = kRows * row;
  static constexpr int fixed = q + kStages * stage;  // bf16 elements; then the table, 2n floats
};

template <int kD16, int kBias>
__global__ void __launch_bounds__(kThreads) attention_bf16_kernel(const ArgsBf16 a) {
  using L = LayoutBf16<kD16>;
  extern __shared__ __align__(16) float smem[];
  bf16* qsm = reinterpret_cast<bf16*>(smem);    // (kRows, row), q scaled in place
  bf16* ring = qsm + L::q;                      // kStages x [K (kKeys, row) | V (kKeys, row)]
  float* tab = reinterpret_cast<float*>(qsm + L::fixed);  // table column h, fp32

  const int n = a.n, D = a.D;
  const int i0 = blockIdx.x * kRows, w = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.H, h = bh - b * a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = min(kRows, n - i0);
  const int j_begin = w == 0 ? n : 0;
  const int j_end = n + i0 + rows;
  const int ntiles = (j_end - j_begin + kKeys - 1) / kKeys;
  const long long q_row0 = static_cast<long long>(w) * n + i0;
  const long long k_row0 = static_cast<long long>(w) * n - n;
  const bf16* qb = a.q + b * a.qs[0] + h * a.qs[1];
  const bf16* kb = a.k + b * a.ks[0] + h * a.ks[1];
  const bf16* vb = a.v + b * a.vs[0] + h * a.vs[1];
  constexpr int kPieces = 4 * kD16;             // 8-byte pieces per (zero-filled) row

  auto stage_kv = [&](int s, int j0) {
    bf16* kt = ring + s * L::stage;
    bf16* vt = kt + L::ktile;
    for (int e = tid; e < kKeys * kPieces; e += kThreads) {
      const int jj = e / kPieces, c = 4 * (e - jj * kPieces), j = j0 + jj;
      const bool ok = j < j_end && c < D;
      const long long t = k_row0 + j;
      ptx::cp_async8(kt + jj * L::row + c, ok ? kb + t * a.ks[2] + c : a.k, ok ? 8 : 0);
      ptx::cp_async8(vt + jj * L::row + c, ok ? vb + t * a.vs[2] + c : a.v, ok ? 8 : 0);
    }
  };

  for (int e = tid; e < kRows * kPieces; e += kThreads) {
    const int r = e / kPieces, c = 4 * (e - r * kPieces);
    const bool ok = r < rows && c < D;
    ptx::cp_async8(qsm + r * L::row + c, ok ? qb + (q_row0 + r) * a.qs[2] + c : a.q,
                   ok ? 8 : 0);
  }
  ptx::cp_async_commit();
  stage_kv(0, j_begin);
  ptx::cp_async_commit();
  if (kBias == kTableBias)
    for (int e = tid; e < 2 * n; e += kThreads) tab[e] = __bfloat162float(a.table[e * a.H + h]);
  ptx::cp_async_wait<1>();  // q has landed
  __syncthreads();
  // q * scale in bf16: one rounding of the exact fp32 product, as torch's
  // and XLA's bf16 multiply
  for (int e = tid; e < kRows * 16 * kD16; e += kThreads) {
    bf16* p = qsm + (e / (16 * kD16)) * L::row + e % (16 * kD16);
    *p = __float2bfloat16_rn(__bfloat162float(*p) * a.scale);
  }
  __syncthreads();

  const int q8 = lane >> 3, r8 = lane & 7, g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp;
  const int ia = i0 + r0 + g, ib = ia + 8;
  const int i_last = min(i0 + r0 + 15, n - 1);
  const bool warp_live = i0 + r0 < n;
  uint32_t qf[kD16][4];  // Q's A fragments, k16 step by step
#pragma unroll
  for (int k16 = 0; k16 < kD16; ++k16)
    ptx::ldmatrix_x4(qf[k16], qsm + (r0 + (q8 & 1) * 8 + r8) * L::row + (q8 >> 1) * 8 + k16 * 16);
  // K's B fragments: pairs of n8 tiles (keys) x k16 (row = key)
  const int k_off = ((q8 >> 1) * 8 + r8) * L::row + (q8 & 1) * 8;
  // V's B fragments through .trans: matrix q = (keys (q & 1) 8.., dims (q >> 1) 8..)
  const int v_off = ((q8 & 1) * 8 + r8) * L::row + (q8 >> 1) * 8;

  float o[2 * kD16][4];
#pragma unroll
  for (int dt = 0; dt < 2 * kD16; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    ptx::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < ntiles) stage_kv((it + 1) % kStages, j_begin + (it + 1) * kKeys);
    ptx::cp_async_commit();
    const int j0 = j_begin + it * kKeys;
    if (!warp_live || j0 > n + i_last) continue;
    const bf16* kt = ring + (it % kStages) * L::stage;
    const bf16* vt = kt + L::ktile;

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int k16 = 0; k16 < kD16; ++k16)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        ptx::ldmatrix_x4(r, kt + np * 16 * L::row + k_off + k16 * 16);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        ptx::mma_bf16(s[2 * np], qf[k16], b0);
        ptx::mma_bf16(s[2 * np + 1], qf[k16], b1);
      }

    // s[nt][e]: row (e < 2 ? ia : ib), key j0 + nt * 8 + 2 t4 + (e & 1)
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? ia : ib, j = j0 + nt * 8 + 2 * t4 + (e & 1);
        const bool ok = i < n && j <= n + i;
        float x = s[nt][e];
        if (kBias == kTableBias) x += ok ? tab[n + i - j] : 0.0f;
        if (kBias == kFullBias)
          x += ok ? __bfloat162float(a.bias[(static_cast<long long>(h) * n + i) * (2 * n) + j])
                  : 0.0f;
        x = ok ? x : -INFINITY;
        s[nt][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
    const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
    const float mu_a = mn_a == -INFINITY ? 0.0f : mn_a;
    const float mu_b = mn_b == -INFINITY ? 0.0f : mn_b;
    const float c_a = expf(m_a - mu_a), c_b = expf(m_b - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[nt][e] - (e < 2 ? mu_a : mu_b));
        s[nt][e] = pe;
        if (e < 2) ps_a += pe;
        else ps_b += pe;
      }
    l_a = l_a * c_a + ps_a;
    l_b = l_b * c_b + ps_b;
#pragma unroll
    for (int dt = 0; dt < 2 * kD16; ++dt) {
      o[dt][0] *= c_a;
      o[dt][1] *= c_a;
      o[dt][2] *= c_b;
      o[dt][3] *= c_b;
    }

    // O += bf16(P) V, four k16 steps of 16 keys: the accumulator pairs of n8
    // tiles 2 kk and 2 kk + 1 are P's A fragment of step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pf[4] = {ptx::bf16x2_rn(s[2 * kk][0], s[2 * kk][1]),
                              ptx::bf16x2_rn(s[2 * kk][2], s[2 * kk][3]),
                              ptx::bf16x2_rn(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              ptx::bf16x2_rn(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kD16; ++dp) {
        uint32_t r[4];
        ptx::ldmatrix_x4_trans(r, vt + kk * 16 * L::row + v_off + dp * 16);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        ptx::mma_bf16(o[2 * dp], pf, b0);
        ptx::mma_bf16(o[2 * dp + 1], pf, b1);
      }
    }
  }

  const float inv_a = 1.0f / quad_sum(l_a), inv_b = 1.0f / quad_sum(l_b);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = hf ? ib : ia;
    if (i >= n) continue;
    const float inv = hf ? inv_b : inv_a;
    bf16* orow = a.out + ((static_cast<long long>(b) * a.T + w * static_cast<long long>(n) + i) *
                          a.H + h) * D;
#pragma unroll
    for (int dt = 0; dt < 2 * kD16; ++dt) {
      const int d = dt * 8 + 2 * t4;
      if (d < D)
        *reinterpret_cast<uint32_t*>(orow + d) =
            ptx::bf16x2_rn(o[dt][2 * hf] * inv, o[dt][2 * hf + 1] * inv);
    }
  }
}

template <int kD16, int kBias>
cudaError_t launch_bf16(const ArgsBf16& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * LayoutBf16<kD16>::fixed +
                      (kBias == kTableBias ? sizeof(float) * 2 * a.n : 0);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_bf16_kernel<kD16, kBias>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(l3ac::ceil_div(a.n, kRows), a.T / a.n, B * a.H);
  attention_bf16_kernel<kD16, kBias><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int kD16>
cudaError_t launch_d_bf16(const ArgsBf16& a, int B, cudaStream_t stream) {
  if (a.table != nullptr) return launch_bf16<kD16, kTableBias>(a, B, stream);
  if (a.bias != nullptr) return launch_bf16<kD16, kFullBias>(a, B, stream);
  return launch_bf16<kD16, kNoBias>(a, B, stream);
}

bool aligned8(const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; }

}  // namespace

// The same for bf16 q, k, v, bias / table and out, element strides multiples
// of 4 and pointers 8-byte aligned; scale is D^-1/2 rounded to bf16.
extern "C" int l3ac_local_attention_bf16(const void* q, const void* k, const void* v,
                                         const void* bias, const void* table, void* out, int B,
                                         int H, int T, int n, int D, long long qsB,
                                         long long qsH, long long qsT, long long ksB,
                                         long long ksH, long long ksT, long long vsB,
                                         long long vsH, long long vsT, float scale,
                                         void* stream) {
  const long long strides[9] = {qsB, qsH, qsT, ksB, ksH, ksT, vsB, vsH, vsT};
  bool ok = B >= 1 && H >= 1 && static_cast<long long>(B) * H <= 65535 && n >= 1 &&
            T >= n && T % n == 0 && T / n <= 65535 && D >= 4 && D <= 8 * kMaxD8 &&
            D % 4 == 0 && !(bias != nullptr && table != nullptr) && aligned8(q) &&
            aligned8(k) && aligned8(v) && aligned8(out);
  for (long long s : strides) ok = ok && s % 4 == 0;
  if (!ok) return cudaErrorInvalidValue;
  const ArgsBf16 a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), static_cast<const bf16*>(bias),
                   static_cast<const bf16*>(table), static_cast<bf16*>(out),
                   {qsB, qsH, qsT}, {ksB, ksH, ksT}, {vsB, vsH, vsT}, H, T, n, D, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d16 = (D + 15) / 16;  // k16 steps: 1, 2, then 4 or 8 (zero-filled)
  if (d16 <= 2) return d16 == 1 ? launch_d_bf16<1>(a, B, s) : launch_d_bf16<2>(a, B, s);
  return d16 <= 4 ? launch_d_bf16<4>(a, B, s) : launch_d_bf16<8>(a, B, s);
}
