// Block-local causal attention with an additive position bias, fp32, both
// products on the tensor cores.
//
// Replaces l3ac_tpu/ops/pallas/local_attention.py:local_attention (body
// _attn_kernel). q, k, v: (B, H, T, D) views whose last dim is contiguous,
// read in place through their B / H / T strides (16-byte aligned rows);
// out: (B, T, H, D), so that the caller's (B, T, H * D) is a view. Query i of
// window w attends to key j of [window w-1 | window w] (global key row
// (w-1) n + j) iff j <= n + i, and in window 0 only to j >= n (its previous
// block does not exist). Scores are (q * D^-0.5) . k + bias[h, i, j]; the
// softmax is fp32. The bias is either the full (H, n, 2n) tensor, read from
// device memory, or the dynamic position bias's (2n, H) Toeplitz table,
// bias[h, i, j] = table[|n + i - j|, h], whose column h is staged in shared
// memory (6 KB at n = 750) and indexed from (i, j).
//
// Bound on the H100: per valid (query, key) pair 2 D operations for each of
// the two products, plus the exp and the softmax's few fp32 operations. As
// 3 TF32 passes at 495 TFLOP/s that is ~0.09 / 0.17 ms per 8 x 10 s 1kbps
// encode / decode (94.6 M pairs per call at n = 750, 10.5 M at n = 250), 2.5x
// below the fp32 SIMT bound. The exp and the softmax's other few fp32
// operations per pair need less than a fifth of that on the fp32 pipe, and
// the bytes (q, k, v read once, out written once) a tenth.
//
// Design, flash-attention style: one block per (64-query tile, window,
// batch * head), 4 warps of 16 query rows. K / V tiles of 64 keys go through
// a 2-stage cp.async ring (zero fill past the causal limit of the tile's last
// row, where the key loop stops, and in the head dim past D), so the score
// matrix never reaches device memory. Per warp and key tile:
//   S (16 x 64) = Q K^T on mma.sync m16n8k8 TF32, 3 passes (lo.hi + hi.lo +
//   hi.hi), operands split with tf32_rna as their fragments load; q is
//   scaled before the split, as the plain version scales it. K = D in steps
//   of 8 (zero-filled to kD8 of them: D <= 32 exactly, then 64 and 128).
//   Up to D = 32 the q fragments stay in registers for the whole key loop;
//   above, they are reloaded from the staged q for every key tile, so that
//   the registers hold O (D / 8 n8 tiles) and S without spilling.
//   The mask and bias from (i, j); the running max and sum in registers, each
//   row's reduction across the 4 lanes of a quad. A row with no valid key in
//   a tile (rows past n, or before their first key) takes the max 0, so no
//   exp(-inf - -inf) is formed; every real row has key n + i.
//   O (16 x D) += P V, again 3 TF32 passes, a fresh accumulator per K step
//   of 32 keys added to the fp32 total (the tensor core's own fp32 adds
//   truncate, csrc/tc_gemm.cuh). Above D = 32 the 32 keys of P are split
//   once and O is walked tile by tile, one tile's accumulator live at a time.
// P moves from S's accumulator (C) layout to P V's A layout with no data
// movement. For m16n8k8 the two differ: lane (g, t) holds C columns 2t and
// 2t+1 of an n8 tile, but A columns t and t+4. So S's n8 tile puts its keys
// in the order {0, 4, 1, 5, 2, 6, 3, 7}: ldmatrix takes each row address
// from a lane, and the lanes that address K's rows give key sigma(r) =
// r / 2 + 4 (r % 2) for row r. Then lane (g, t)'s C columns 2t, 2t+1 are
// keys t, t+4 of the tile, which is P's A fragment for that k8 step, and V's
// B fragment reads V's rows t and t+4 in their natural order. Shuffles would
// cost 8 per k8 step, a per-warp buffer a store, a barrier and a load.
// No fast math: expf, IEEE division for the final 1 / sum. The bf16 attention
// is its own kernel, csrc/local_attention_bf16.cu.
// The previous-window operands of JAX's kernel (_attn_kernel's kp, kp0 and vp0
// refs): window w >= 1 reads its previous half's keys from kp (a view like k,
// default k: the rotary path's keys rotated as previous-window keys), and
// window 0 from pk / pv, (B, H, n, D) contiguous (under sequence parallelism
// the left shard's last window), unless its previous half is masked: with no
// pk, or with left_edge 1 (the globally first shard). The K / V ring loads
// each key row from its own source, so a tile may straddle the two halves.
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
constexpr int kRegQ8 = 4;           // up to D = 32 the q fragments stay in registers

enum BiasMode { kNoBias = 0, kFullBias = 1, kTableBias = 2 };

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* kp;     // the previous-role keys of windows w >= 1 (default k)
  const float* pk;     // (B, H, n, D) window 0's previous keys, or null
  const float* pv;     // ... its values
  const float* bias;   // (H, n, 2n), kFullBias
  const float* table;  // (2n, H), kTableBias
  float* out;          // (B, T, H, D) contiguous
  long long qs[3], ks[3], vs[3], kps[3];  // B, H, T strides in floats
  int H, T, n, D;
  int mask_first;      // window 0's previous half masked (no pk, or left_edge)
  float scale;
};

// Row strides in floats. Q and K rows are read by ldmatrix (8 rows of 16
// bytes at a time): 4 mod 8 puts the eight rows in distinct banks. V is read
// as B fragments V[t][g] (lane (g, t)): a stride of 8 or 24 mod 32 does.
template <int kD8>
struct Layout {
  static constexpr int qk = 8 * kD8 + 4;
  static constexpr int v = (8 * kD8) % 32 == 8 || (8 * kD8) % 32 == 24 ? 8 * kD8 : 8 * kD8 + 8;
  static constexpr int ktile = kKeys * qk;
  static constexpr int stage = kKeys * (qk + v);
  static constexpr int q = kRows * qk;
  static constexpr int fixed = q + kStages * stage;  // + the staged table, 2n floats
};

// raw fp32 fragment -> TF32 hi and lo
template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = ptx::tf32_rna(x[i]);
    lo[i] = ptx::tf32_rna(x[i] - __uint_as_float(hi[i]));
  }
}

// the three passes of one m16n8k8 step, small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  ptx::mma_tf32(d, al, bh);
  ptx::mma_tf32(d, ah, bl);
  ptx::mma_tf32(d, ah, bh);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int kD8, int kBias>
__global__ void __launch_bounds__(kThreads) attention_kernel(const Args a) {
  using L = Layout<kD8>;
  extern __shared__ __align__(16) float smem[];
  float* qsm = smem;                            // (kRows, qk), q unscaled
  float* ring = smem + L::q;                    // kStages x [K (kKeys, qk) | V (kKeys, v)]
  float* tab = smem + L::fixed;                 // table column h, 2n floats

  const int n = a.n, D = a.D;
  const int i0 = blockIdx.x * kRows, w = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.H, h = bh - b * a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = min(kRows, n - i0);
  const int j_begin = w == 0 && a.mask_first ? n : 0;
  const int j_end = n + i0 + rows;              // one past the last row's last key
  const int ntiles = (j_end - j_begin + kKeys - 1) / kKeys;
  const long long q_row0 = static_cast<long long>(w) * n + i0;  // time of query row 0
  const long long k_row0 = static_cast<long long>(w) * n - n;   // time of key j = 0
  const float* qb = a.q + b * a.qs[0] + h * a.qs[1];
  const float* kb = a.k + b * a.ks[0] + h * a.ks[1];
  const float* vb = a.v + b * a.vs[0] + h * a.vs[1];
  const float* kpb = a.kp + b * a.kps[0] + h * a.kps[1];
  const long long p_row0 = static_cast<long long>(bh) * n;  // pk / pv row of key j = 0
  constexpr int kPieces = 2 * kD8;              // 16-byte pieces per (zero-filled) row

  // key j < n of window w >= 1 from kp, of window 0 from pk / pv; j >= n from k
  auto stage_kv = [&](int s, int j0) {
    float* kt = ring + s * L::stage;
    float* vt = kt + L::ktile;
    for (int e = tid; e < kKeys * kPieces; e += kThreads) {
      const int jj = e / kPieces, c = 4 * (e - jj * kPieces), j = j0 + jj;
      const bool ok = j < j_end && c < D;
      const long long t = k_row0 + j;
      const float* ks = a.k;
      const float* vs = a.v;
      if (ok) {
        if (j >= n || w > 0) {
          ks = (j >= n ? kb + t * a.ks[2] : kpb + t * a.kps[2]) + c;
          vs = vb + t * a.vs[2] + c;
        } else {
          ks = a.pk + (p_row0 + j) * D + c;
          vs = a.pv + (p_row0 + j) * D + c;
        }
      }
      ptx::cp_async16(kt + jj * L::qk + c, ks, ok ? 16 : 0);
      ptx::cp_async16(vt + jj * L::v + c, vs, ok ? 16 : 0);
    }
  };

  // q rows past n and head dims past D are zero
  for (int e = tid; e < kRows * kPieces; e += kThreads) {
    const int r = e / kPieces, c = 4 * (e - r * kPieces);
    const bool ok = r < rows && c < D;
    ptx::cp_async16(qsm + r * L::qk + c, ok ? qb + (q_row0 + r) * a.qs[2] + c : a.q,
                    ok ? 16 : 0);
  }
  stage_kv(0, j_begin);
  ptx::cp_async_commit();
  if (kBias == kTableBias)
    for (int e = tid; e < 2 * n; e += kThreads) tab[e] = __ldg(a.table + e * a.H + h);

  const int q8 = lane >> 3, r8 = lane & 7, g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp;
  const int ia = i0 + r0 + g, ib = ia + 8;      // this lane's two query rows
  const int i_last = min(i0 + r0 + 15, n - 1);  // the warp's last real row
  const bool warp_live = i0 + r0 < n;
  // ldmatrix row addresses: Q's A fragments, and K's B fragments with the
  // key order sigma within each n8 tile (see the note above)
  const float* pq = qsm + (r0 + (q8 & 1) * 8 + r8) * L::qk + (q8 >> 1) * 4;
  const int k_off = ((q8 >> 1) * 8 + (r8 >> 1) + 4 * (r8 & 1)) * L::qk + (q8 & 1) * 4;

  constexpr bool kQRegs = kD8 <= kRegQ8;
  uint32_t qh[kQRegs ? kD8 : 1][4], ql[kQRegs ? kD8 : 1][4];
  // the A fragments of Q's k8 step k8, scaled, split
  auto q_fragment = [&](int k8, uint32_t (&h)[4], uint32_t (&l)[4]) {
    uint32_t raw[4];
    ptx::ldmatrix_x4(raw, pq + k8 * 8);
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = __uint_as_float(raw[e]) * a.scale;
    split(x, h, l);
  };
  float o[kD8][4];
#pragma unroll
  for (int dt = 0; dt < kD8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    ptx::cp_async_wait<0>();
    __syncthreads();  // tile it has landed for every thread; tile it - 1 is consumed
    if (it + 1 < ntiles) stage_kv((it + 1) % kStages, j_begin + (it + 1) * kKeys);
    ptx::cp_async_commit();
    if constexpr (kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int k8 = 0; k8 < kD8; ++k8) q_fragment(k8, qh[k8], ql[k8]);
      }
    }
    const int j0 = j_begin + it * kKeys;
    if (!warp_live || j0 > n + i_last) continue;  // warp-uniform: every key masked
    const float* kt = ring + (it % kStages) * L::stage;
    const float* vt = kt + L::ktile;

    // S = (q * scale) K^T, kD8 k8 steps
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int k8 = 0; k8 < kD8; ++k8) {
      uint32_t fh[4], fl[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) fh[e] = qh[k8][e], fl[e] = ql[k8][e];
      } else {
        q_fragment(k8, fh, fl);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t raw[4];
        ptx::ldmatrix_x4(raw, kt + np * 16 * L::qk + k_off + k8 * 8);
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = __uint_as_float(raw[e]);
        uint32_t hi[4], lo[4];
        split(x, hi, lo);
        const uint32_t bh0[2] = {hi[0], hi[1]}, bl0[2] = {lo[0], lo[1]};
        const uint32_t bh1[2] = {hi[2], hi[3]}, bl1[2] = {lo[2], lo[3]};
        mma3(s[2 * np], fh, fl, bh0, bl0);
        mma3(s[2 * np + 1], fh, fl, bh1, bl1);
      }
    }

    // mask, bias and the online softmax. s[nt][e]: row (e < 2 ? ia : ib), key
    // j0 + nt * 8 + t4 + 4 (e & 1)
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? ia : ib, j = j0 + nt * 8 + t4 + 4 * (e & 1);
        const bool ok = i < n && j <= n + i;
        float x = s[nt][e];
        if (kBias == kTableBias) x += ok ? tab[n + i - j] : 0.0f;
        if (kBias == kFullBias)
          x += ok ? __ldg(a.bias + (static_cast<long long>(h) * n + i) * (2 * n) + j) : 0.0f;
        x = ok ? x : -INFINITY;
        s[nt][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
    const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
    const float mu_a = mn_a == -INFINITY ? 0.0f : mn_a;
    const float mu_b = mn_b == -INFINITY ? 0.0f : mn_b;
    const float c_a = expf(m_a - mu_a), c_b = expf(m_b - mu_b);  // 0 before the first key
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - (e < 2 ? mu_a : mu_b));  // masked: exp(-inf) = 0
        s[nt][e] = p;
        if (e < 2) ps_a += p;
        else ps_b += p;
      }
    l_a = l_a * c_a + ps_a;  // per-lane partial sums; the quad adds them at the end
    l_b = l_b * c_b + ps_b;
#pragma unroll
    for (int dt = 0; dt < kD8; ++dt) {
      o[dt][0] *= c_a;
      o[dt][1] *= c_a;
      o[dt][2] *= c_b;
      o[dt][3] *= c_b;
    }

    // O += P V in two K steps of 32 keys; s[nt] is P's A fragment of k8 step
    // nt: {P[g][t], P[g+8][t], P[g][t+4], P[g+8][t+4]} = s[nt][0, 2, 1, 3]
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if constexpr (kQRegs) {  // D <= 32: all of O's tiles per k8 step
        float acc[kD8][4];
#pragma unroll
        for (int dt = 0; dt < kD8; ++dt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int nt = 4 * half + kk;
          const float pa[4] = {s[nt][0], s[nt][2], s[nt][1], s[nt][3]};
          uint32_t ph[4], pl[4];
          split(pa, ph, pl);
          const float* vr = vt + (nt * 8 + t4) * L::v + g;
#pragma unroll
          for (int dt = 0; dt < kD8; ++dt) {
            const float vv[2] = {vr[dt * 8], vr[4 * L::v + dt * 8]};
            uint32_t vh[2], vl[2];
            split(vv, vh, vl);
            mma3(acc[dt], ph, pl, vh, vl);
          }
        }
#pragma unroll
        for (int dt = 0; dt < kD8; ++dt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[dt][e] += acc[dt][e];
        continue;
      }
      // wider D: P's 32 keys split once, then O tile by tile, so that one
      // tile's accumulator is live at a time
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int nt = 4 * half + kk;
        const float pa[4] = {s[nt][0], s[nt][2], s[nt][1], s[nt][3]};
        split(pa, ph[kk], pl[kk]);
      }
#pragma unroll
      for (int dt = 0; dt < kD8; ++dt) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* vr = vt + ((4 * half + kk) * 8 + t4) * L::v + g;
          const float vv[2] = {vr[dt * 8], vr[4 * L::v + dt * 8]};
          uint32_t vh[2], vl[2];
          split(vv, vh, vl);
          mma3(acc, ph[kk], pl[kk], vh, vl);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] += acc[e];
      }
    }
  }

  // out[b, t, h, :] = O / sum; lane (g, t4) holds columns 2 t4, 2 t4 + 1 of
  // each n8 tile of rows ia and ib
  const float inv_a = 1.0f / quad_sum(l_a), inv_b = 1.0f / quad_sum(l_b);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = hf ? ib : ia;
    if (i >= n) continue;
    const float inv = hf ? inv_b : inv_a;
    float* orow = a.out + ((static_cast<long long>(b) * a.T + w * static_cast<long long>(n) + i) *
                           a.H + h) * D;
#pragma unroll
    for (int dt = 0; dt < kD8; ++dt) {
      const int d = dt * 8 + 2 * t4;
      if (d < D)
        *reinterpret_cast<float2*>(orow + d) =
            make_float2(o[dt][2 * hf] * inv, o[dt][2 * hf + 1] * inv);
    }
  }
}

template <int kD8, int kBias>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (Layout<kD8>::fixed + (kBias == kTableBias ? 2 * a.n : 0));
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<kD8, kBias>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(l3ac::ceil_div(a.n, kRows), a.T / a.n, B * a.H);
  attention_kernel<kD8, kBias><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int kD8>
cudaError_t launch_d(const Args& a, int B, cudaStream_t stream) {
  if (a.table != nullptr) return launch<kD8, kTableBias>(a, B, stream);
  if (a.bias != nullptr) return launch<kD8, kFullBias>(a, B, stream);
  return launch<kD8, kNoBias>(a, B, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// q, k, v, kp: (B, H, T, D) with element strides (sB, sH, sT, 1) each, every
// stride a multiple of 4 and every pointer 16-byte aligned (kp null: k); D a
// multiple of 4 up to 128; T a multiple of n. pk, pv: (B, H, n, D) contiguous,
// both or neither; left_edge 1 masks window 0's previous half all the same.
// bias: (H, n, 2n) contiguous, or table: (2n, H) contiguous, or neither (not
// both). out: (B, T, H, D) contiguous. All fp32. Returns the CUDA error code
// (invalid value for what it does not take).
extern "C" int l3ac_local_attention(const float* q, const float* k, const float* v,
                                    const float* kp, const float* pk, const float* pv,
                                    const float* bias, const float* table, float* out, int B,
                                    int H, int T, int n, int D, int left_edge, long long qsB,
                                    long long qsH, long long qsT, long long ksB, long long ksH,
                                    long long ksT, long long vsB, long long vsH, long long vsT,
                                    long long kpsB, long long kpsH, long long kpsT, float scale,
                                    void* stream) {
  if (kp == nullptr) kp = k, kpsB = ksB, kpsH = ksH, kpsT = ksT;
  const long long strides[12] = {qsB, qsH, qsT, ksB, ksH, ksT, vsB, vsH, vsT, kpsB, kpsH, kpsT};
  bool ok = B >= 1 && H >= 1 && static_cast<long long>(B) * H <= 65535 && n >= 1 &&
            T >= n && T % n == 0 && T / n <= 65535 && D >= 4 && D <= 8 * kMaxD8 &&
            D % 4 == 0 && !(bias != nullptr && table != nullptr) && aligned16(q) &&
            aligned16(k) && aligned16(v) && aligned16(kp) && aligned16(out) &&
            (pk == nullptr) == (pv == nullptr) && aligned16(pk) && aligned16(pv);
  for (long long s : strides) ok = ok && s % 4 == 0;
  if (!ok) return cudaErrorInvalidValue;
  Args a{q, k, v, kp, pk, pv, bias, table, out, {qsB, qsH, qsT}, {ksB, ksH, ksT},
         {vsB, vsH, vsT}, {kpsB, kpsH, kpsT}, H, T, n, D, pk == nullptr || left_edge != 0, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d8 = (D + 7) / 8;  // k8 steps, exact up to 4, then 8 or 16 (zero-filled)
  if (d8 <= 4) {
    switch (d8) {
      case 1: return launch_d<1>(a, B, s);
      case 2: return launch_d<2>(a, B, s);
      case 3: return launch_d<3>(a, B, s);
      default: return launch_d<4>(a, B, s);
    }
  }
  return d8 <= 8 ? launch_d<8>(a, B, s) : launch_d<16>(a, B, s);
}
