// Encoder stem (FirstBlock) as one fused kernel, audio (B, T) -> features
// (B, Cout, T), both 1x1 products on the tensor cores.
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
// first and last three output columns, and stages a halo of 25 samples where
// the receptive field needs 2 * 22 + 3 = 47.)
//
// Bound on the H100: about 7.9k fp32 operations per output column against 4
// bytes read and 4 Cout bytes written, 0.152 ms per 8 x 10 s encode at the
// fp32 rate. 3.5k of them are the two 1x1 products; as three TF32 passes on
// the tensor cores (K 20 padded to 24) they bound it at about 0.06 ms. What
// stays on the SIMT pipes is the 80 exact GELUs per column (erff, no fast
// math), their TF32 splits, the branch convs and the pools.
//
// Design: one block of 4 warps per 128-column tile of one batch row. It
// loads the packed weights (first_block.py:pack, 32 KB at Cout = 24) into
// shared memory, then:
//   1. the audio with a 47-sample halo, zero outside [0, T), into shared
//      memory; the four max pools of |x| from running maxima over 4, 8 and 16
//      samples (a window of k is the max of two or three of them, overlaps
//      allowed), then the average pools summed in index order, the order of
//      ops/pool.py; each pooled signal zero outside [0, T).
//   2. Each lane computes the branch convs of exactly the entries of its A
//      fragments of the first product (time as M, one m16 tile per warp at a
//      time): lane (g, t) owns rows g and g + 8 and channel t of each branch,
//      i.e. hidden inputs t, t + 4, ..., t + 16, and the pad 20..23 is zero.
//      No shared buffer and no barrier between the branch convs and the
//      product.
//   3. Product 1 (20 -> 80) and product 2 (80 -> Cout) as mma.sync m16n8k8
//      with 3 TF32 passes (a_lo b_hi + a_hi b_lo + a_hi b_hi, tf32_rna
//      splits), the weights' hi / lo packed once in fragment order (one
//      16-byte load per lane serves the three passes). Product 1 runs two n8
//      tiles of hidden units at a time; b1 and the exact GELU are applied to
//      its accumulator in registers, which is then split and used as the A
//      fragment of one k8 step of product 2: the C fragment's (g, 2t),
//      (g, 2t + 1) are the A fragment's (g, t), (g, t + 4) when hidden unit
//      8j + 2t is k = t and 8j + 2t + 1 is k = t + 4 of step j, and pack
//      permutes W2's columns that way. So the 80 activations never leave
//      registers. Product 2 sums each K step of 32 (four hidden tiles) into a
//      fresh accumulator added to the fp32 total (the tensor core's own adds
//      truncate, csrc/tc_gemm.cuh); product 1 (K = 24) is one such step, b1
//      added after it in fp32.
//   4. Epilogue: y = total + b2 + w2[:, 80] x[t] (the raw sample as a rank-1
//      term in fp32, so K stays 80), Cout padded to n8 tiles with zero rows,
//      each lane's values stored straight to device memory (8 lanes write 8
//      consecutive columns of an output row).
// Widths: up to Cout = 64 one block computes every output channel; above,
// Cout is padded to 64-channel tiles and the grid's third axis walks them,
// each block staging only its tile's W2 fragments (the rest of the work, the
// pools and product 1, is redone per tile), at any Cout the grid's 65535
// tiles of its third axis hold (ROADMAP C3: the JAX stem takes any Cout).
//
// bf16 stems run csrc/first_block_bf16.cu; this file's former bf16 kernel
// is tools/first_block_bf16_mma.cu.
// Measured on the card against its alternatives with
// l3ac_tpu_torch/tools/first_block_variants.py (PERF.md): the output tile
// staged in shared memory and copied out in 16-byte stores, persistent
// blocks that load the weights once and walk the tiles, two m16 tiles per
// warp at a time, 8 warps per block, registers for 4 blocks per SM
// (kMinBlocks, 106 registers against 95 at Cout = 24), and product 1 of the
// next hidden pair computed beside this pair's GELU: all right and all
// slower, or within 3 %.
// Where the time goes (ablations): the exact GELU about a quarter, the two
// extra TF32 passes and the pools with the branch convs about a fifth each;
// the stores hide behind the rest.
#include "common.cuh"
#include "ptx.cuh"

namespace {

namespace ptx = l3ac::ptx;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 128;                     // output columns per tile
constexpr int kMaxP = 22;                      // 45 // 2
constexpr int kHalo = 2 * kMaxP + 3;           // 47
constexpr int kXLen = kTile + 2 * kHalo;       // staged audio
constexpr int kALen = kTile + 6;               // pooled signal incl. the k7 halo
constexpr int kBranches = 5;
constexpr int kHid = 20;                       // 5 branches x 4 channels
constexpr int kMid = 80;
constexpr int kMidTiles = kMid / 8;            // n8 tiles of product 1 = k8 steps of product 2
constexpr int kSteps1 = 3;                     // k8 steps of product 1: K 20 padded to 24
constexpr int kGroup = 4;                      // k8 steps of product 2 per fresh accumulator
constexpr int kPasses = 3;                     // TF32 passes per product step
constexpr int kMinBlocks = 5;                  // blocks per SM the registers are budgeted for
constexpr int kCapNT = 3;                      // ... up to Cout 8 kCapNT (above, less fits)
constexpr int kMaxNT = 8;                      // output n8 tiles per block: 64 channels

// The shared-memory image, in 32-bit words. The weights are
// first_block.py:pack's buffer (first_block.py:sections) for this block's
// output tile, copied once per block; then the tile's buffers.
template <int kNT>
struct Layout {
  // W2's fragments: kW2Steps k steps of kNT tiles of kW2Tile words each
  static constexpr int kW2Steps = kMidTiles;
  static constexpr int kW2Tile = 128;
  static constexpr int w1 = 0;                                // [10][3][32] (hi0, hi1, lo0, lo1)
  static constexpr int w2 = w1 + kMidTiles * kSteps1 * 128;
  static constexpr int b1 = w2 + kW2Steps * kNT * kW2Tile;    // (80)
  static constexpr int b2 = b1 + kMid;                        // (8 kNT)
  static constexpr int wx = b2 + 8 * kNT;                     // (8 kNT): w2[:, 80]
  static constexpr int wb = wx + 8 * kNT;                     // (5, 4, 7) branch convs
  static constexpr int bb = wb + kHid * 7;                    // (5, 4)
  static constexpr int weights = bb + kHid;
  static constexpr int xs = weights;                          // x[t0 - 47 + i]
  static constexpr int m4 = xs + kXLen;                       // max |x| over 4 samples from i
  static constexpr int m8 = m4 + kXLen;                       // ... over 8
  static constexpr int m16 = m8 + kXLen;                      // ... over 16
  static constexpr int mk = m16 + kXLen;                      // the max pools, kALen + 2p each
  static constexpr int as = mk + 4 * kALen + 2 * (2 + 5 + 10 + 22);  // the avg pools, kALen each
  static constexpr int total = as + 4 * kALen;
  static_assert(weights % 4 == 0, "16-byte copies of the weights");
};

struct Args {
  const void* x;     // (B, T) fp32
  const float* w;    // first_block.py:pack
  void* out;         // (B, Cout, T) fp32
  int B, T, Cout;
  int NT;            // n8 tiles of the packed W2, b2 and wx: padded Cout / 8
};

__device__ __forceinline__ void copy4(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n / 4; i += kThreads)
    reinterpret_cast<float4*>(dst)[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
}

// This block's weights into the Layout (published by the caller's next
// barrier): with one output tile the buffer as it is; with several, W1, the
// W2 fragments, b2 and wx of output tiles [nt0, nt0 + kNT) out of a.NT, and
// the vectors
template <class L, int kNT>
__device__ __forceinline__ void stage_weights(float* smem, const Args& a, int nt0) {
  if (a.NT == kNT) {
    copy4(smem, a.w, L::weights);
    return;
  }
  const float* src = a.w;
  copy4(smem + L::w1, src, L::w2 - L::w1);
  src += L::w2 - L::w1;
  for (int k = 0; k < L::kW2Steps; ++k)
    copy4(smem + L::w2 + k * kNT * L::kW2Tile, src + (k * a.NT + nt0) * L::kW2Tile,
          kNT * L::kW2Tile);
  src += L::kW2Steps * a.NT * L::kW2Tile;
  copy4(smem + L::b1, src, kMid);
  src += kMid;
  copy4(smem + L::b2, src + 8 * nt0, 8 * kNT);
  src += 8 * a.NT;
  copy4(smem + L::wx, src + 8 * nt0, 8 * kNT);
  src += 8 * a.NT;
  copy4(smem + L::wb, src, L::weights - L::wb);
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = ptx::tf32_rna(v);
  lo = ptx::tf32_rna(v - __uint_as_float(hi));
}

// pass p of a 3xTF32 product step, small terms first: a_lo b_hi, a_hi b_lo, a_hi b_hi
__device__ __forceinline__ void mma_pass(int p, float (&d)[4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                         const uint32_t (&bl)[2]) {
  ptx::mma_tf32(d, p == 0 ? al : ah, p == 1 ? bl : bh);
}

__device__ __forceinline__ void fragment(const float* p, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  bh[0] = __float_as_uint(f.x), bh[1] = __float_as_uint(f.y);
  bl[0] = __float_as_uint(f.z), bl[1] = __float_as_uint(f.w);
}

// max-pool k of |x| at v = t0 - 3 - p + r, r in [0, kALen + 2p): the window
// x[v - p .. v + p] is |xs|[s .. s + k) with s = r + kHalo - 3 - 2p; zero
// outside [0, T) (the average pool's padding). Inside, the window holds v,
// so the zeros staged outside [0, T) never exceed its max, as torch's -inf
// padding would not.
template <int K>
__device__ __forceinline__ void max_pool(const float* m4, const float* m8, const float* m16,
                                         float* mk, int t0, int T) {
  constexpr int p = K / 2;
  for (int r = threadIdx.x; r < kALen + 2 * p; r += kThreads) {
    const int v = t0 - 3 - p + r;
    const int s = r + kHalo - 3 - 2 * p;
    float m = 0.0f;
    if (v >= 0 && v < T) {
      if constexpr (K == 5) m = fmaxf(m4[s], m4[s + 1]);
      else if constexpr (K == 11) m = fmaxf(m8[s], m8[s + 3]);
      else if constexpr (K == 21) m = fmaxf(m16[s], m16[s + 5]);
      else m = fmaxf(fmaxf(m16[s], m16[s + 16]), m16[s + 29]);
    }
    mk[r] = m;
  }
}

// avg-pool k of the max pool at u = t0 - 3 + q, summed in index order; zero
// outside [0, T)
template <int K>
__device__ __forceinline__ void avg_pool(const float* mk, float* as, int t0, int T) {
  for (int q = threadIdx.x; q < kALen; q += kThreads) {
    const int u = t0 - 3 + q;
    float a = 0.0f;
    if (u >= 0 && u < T) {
      float acc = mk[q];
#pragma unroll
      for (int d = 1; d < K; ++d) acc += mk[q + d];
      a = acc / static_cast<float>(K);
    }
    as[q] = a;
  }
}

// The four trend pools of the tile whose audio is in xs, into as (4, kALen).
template <class L>
__device__ __forceinline__ void pools(float* smem, int t0, int T) {
  const float* xs = smem + L::xs;
  float *m4 = smem + L::m4, *m8 = smem + L::m8, *m16 = smem + L::m16;
  float* mk = smem + L::mk;
  float* as = smem + L::as;
  for (int i = threadIdx.x; i < kXLen - 3; i += kThreads)
    m4[i] = fmaxf(fmaxf(fabsf(xs[i]), fabsf(xs[i + 1])), fmaxf(fabsf(xs[i + 2]), fabsf(xs[i + 3])));
  __syncthreads();
  for (int i = threadIdx.x; i < kXLen - 7; i += kThreads) {
    const float m = fmaxf(m4[i], m4[i + 4]);
    m8[i] = m;
    if (i < kXLen - 15) m16[i] = fmaxf(m, fmaxf(m4[i + 8], m4[i + 12]));
  }
  __syncthreads();
  float* mk5 = mk;
  float* mk11 = mk5 + kALen + 4;
  float* mk21 = mk11 + kALen + 10;
  float* mk45 = mk21 + kALen + 20;
  max_pool<5>(m4, m8, m16, mk5, t0, T);
  max_pool<11>(m4, m8, m16, mk11, t0, T);
  max_pool<21>(m4, m8, m16, mk21, t0, T);
  max_pool<45>(m4, m8, m16, mk45, t0, T);
  __syncthreads();
  avg_pool<5>(mk5, as, t0, T);
  avg_pool<11>(mk11, as + kALen, t0, T);
  avg_pool<21>(mk21, as + 2 * kALen, t0, T);
  avg_pool<45>(mk45, as + 3 * kALen, t0, T);
  __syncthreads();
}

// The branch convs of the A fragments of product 1 that lane (g, t) holds:
// rows m0 + g and m0 + g + 8 and channel t of each branch, hidden inputs
// t + 4 br; k8 step ks holds inputs 8 ks + t and 8 ks + t + 4, so step 2's
// upper half is the zero pad. h = b + sum_k w[k] a[row + k] in tap order
// (the branch signal a starts at t0 - 3), split into TF32 hi / lo.
__device__ __forceinline__ void branch_fragments(uint32_t (&hh)[kSteps1][4],
                                                 uint32_t (&hl)[kSteps1][4], const float* xs,
                                                 const float* as, const float* wb,
                                                 const float* bb, int m0, int g, int t) {
  float h[kBranches][2];
#pragma unroll
  for (int br = 0; br < kBranches; ++br) {
    // branch 0 (k = 1) is the raw signal: a[q] = x[t0 - 3 + q] = xs[q + kHalo - 3]
    const float* a = (br == 0 ? xs + (kHalo - 3) : as + (br - 1) * kALen) + m0 + g;
    const float* w = wb + (br * 4 + t) * 7;
    h[br][0] = h[br][1] = bb[br * 4 + t];
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const float wk = w[k];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) h[br][hf] = fmaf(wk, a[8 * hf + k], h[br][hf]);
    }
  }
  const float v[kSteps1][4] = {{h[0][0], h[0][1], h[1][0], h[1][1]},
                               {h[2][0], h[2][1], h[3][0], h[3][1]},
                               {h[4][0], h[4][1], 0.0f, 0.0f}};
#pragma unroll
  for (int ks = 0; ks < kSteps1; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) split(v[ks][e], hh[ks][e], hl[ks][e]);
}

template <int kNT>
__global__ void __launch_bounds__(kThreads, kNT <= kCapNT ? kMinBlocks : 1)
    first_block_kernel(const Args a) {
  using L = Layout<kNT>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int T = a.T;

  // the weights of output tile blockIdx.z (published by the barrier after the audio);
  // below 64 channels there is one tile, and nt0 a constant
  const int nt0 = kNT == kMaxNT ? blockIdx.z * kNT : 0;
  stage_weights<L, kNT>(smem, a, nt0);
  const float* w1f = smem + L::w1;
  const float* w2f = smem + L::w2;
  const float* b1 = smem + L::b1;
  const float* b2 = smem + L::b2;
  const float* wx = smem + L::wx;
  float* xs = smem + L::xs;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const float* xb = static_cast<const float*>(a.x) + static_cast<long long>(b) * T;
  float* out = static_cast<float*>(a.out);

  // 1. audio and pools
  for (int i = tid; i < kXLen; i += kThreads) {
    const int u = t0 - kHalo + i;
    xs[i] = (u >= 0 && u < T) ? __ldg(xb + u) : 0.0f;
  }
  __syncthreads();
  pools<L>(smem, t0, T);

  // 2-4. per warp, one m16 tile at a time
  for (int m0 = warp * 16; m0 < kTile; m0 += kWarps * 16) {
    uint32_t hh[kSteps1][4], hl[kSteps1][4];
    branch_fragments(hh, hl, xs, smem + L::as, smem + L::wb, smem + L::bb, m0, g, t);

    float tot[kNT][4], acc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[nt][e] = acc[nt][e] = 0.0f;

#pragma unroll 1
    for (int j = 0; j < kMidTiles; j += 2) {
      // product 1, hidden tiles j and j + 1: z = H W1^T
      float z[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[jj][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kSteps1; ++ks) {
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          fragment(w1f + (((j + jj) * kSteps1 + ks) * 32 + lane) * 4, bh[jj], bl[jj]);
#pragma unroll
        for (int p = 3 - kPasses; p < 3; ++p)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) mma_pass(p, z[jj], hh[ks], hl[ks], bh[jj], bl[jj]);
      }
      // + b1, exact GELU, and the result as the A fragment of step j + jj
      // of product 2: {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)} =
      // z {0, 2, 1, 3}
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float2 bias = *reinterpret_cast<const float2*>(b1 + 8 * (j + jj) + 2 * t);
        const float y[4] = {z[jj][0] + bias.x, z[jj][1] + bias.y, z[jj][2] + bias.x,
                            z[jj][3] + bias.y};
        const int to_a[4] = {0, 2, 1, 3};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(l3ac::gelu(y[to_a[e]]), ah[e], al[e]);
        uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          fragment(w2f + (((j + jj) * kNT + nt) * 32 + lane) * 4, bh[nt], bl[nt]);
#pragma unroll
        for (int p = 3 - kPasses; p < 3; ++p)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) mma_pass(p, acc[nt], ah, al, bh[nt], bl[nt]);
      }
      if ((j + 2) % kGroup == 0 || j + 2 == kMidTiles) {  // a K step of 32 is done
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[nt][e] += acc[nt][e];
            acc[nt][e] = 0.0f;
          }
      }
    }

    // y = total + b2 + w2[:, 80] x[t], straight out: lane (g, t) holds rows
    // g, g + 8 and columns 2t, 2t + 1 of each n8 tile
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * nt + 2 * t + (e & 1);
        const int r = m0 + g + 8 * (e >> 1);
        const float y = fmaf(wx[c], xs[r + kHalo], tot[nt][e] + b2[c]);
        const int co = 8 * nt0 + c;
        if (co < a.Cout && t0 + r < T)
          out[(static_cast<long long>(b) * a.Cout + co) * T + t0 + r] = y;
      }
  }
}

template <int kNT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Layout<kNT>;
  const size_t smem = sizeof(float) * static_cast<size_t>(L::total);
  static_assert(sizeof(float) * L::total <= 227 * 1024, "shared memory");
  auto kernel = first_block_kernel<kNT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(l3ac::ceil_div(a.T, kTile), a.B, a.NT / kNT);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

int launch_cout(const void* x, const float* w, void* out, int B, int T, int Cout,
                void* stream) {
  if (Cout < 1 || B < 1 || B > 65535 || T < 1 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      (Cout + 8 * kMaxNT - 1) / (8 * kMaxNT) > 65535)
    return cudaErrorInvalidValue;
  const int nt = (Cout + 7) / 8;
  const Args a{x, w, out, B, T, Cout, nt <= kMaxNT ? nt : (nt + kMaxNT - 1) / kMaxNT * kMaxNT};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt <= kMaxNT ? nt : kMaxNT) {
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

}  // namespace

// x: (B, T) audio; w: first_block.py:pack's buffer for Cout, 16-byte
// aligned; out: (B, Cout, T). All fp32 and contiguous; Cout >= 1.
// Returns the CUDA error code.
extern "C" int l3ac_first_block(const float* x, const float* w, float* out, int B, int T,
                                int Cout, void* stream) {
  return launch_cout(x, w, out, B, T, Cout, stream);
}

