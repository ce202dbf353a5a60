// The bf16 encoder stem, designed for the H100: audio (B, T) -> features
// (B, Cout, T), bf16 in and out.
//
// Replaces l3ac_tpu/ops/pallas/first_block.py:128 first_block_ct (body
// _kernel) on bf16:
//   5 branches, pool k in {1, 5, 11, 21, 45}: |x| -> max-pool k -> avg-pool k
//   (torch pads: max -inf, avg 0 and always / k; k = 1 is the raw signal)
//   -> conv 1->4, k7, zero pad 3; concat (20) -> 1x1 20->80 -> exact GELU
//   -> concat the raw sample (81) -> 1x1 81->Cout.
// Semantics and rounding points of ops/kernels/first_block.py:
// first_block_plain_bf16 (the jnp path's edges: each pooled signal is zero
// outside [0, T) before its k7 conv): the pools and branch convs in fp32 on
// the bf16 samples, the 20 branch outputs rounded to bf16, product 1 on bf16
// operands with fp32 sums, b1 and the exact GELU in fp32, the 80
// activations rounded to bf16 and product 2 likewise, the raw sample's
// column (bf16 times bf16, exact) and b2 added in fp32, the output rounded
// to bf16.
//
// Bound on the H100 (chip_smoke.py gelu_bound_ms, PERF.md §6 row 4b): 2
// bytes read and 2 Cout written per output column, 0.019 ms per 8 x 10 s
// encode at Cout = 24; but the 80 exact GELUs per column, the pools and the
// 140 fmas of the branch convs run on the SIMT pipes, and their
// instructions at the issue rate take several times that. The products are
// a few hundred bf16 operations per column on the tensor cores.
//
// Design, for that bound. tools/first_block_variants.py --bf16 measured the
// former kernel (tools/first_block_bf16_mma.cu) at 0.208 ms: the GELU 0.08 of
// it, the pools 0.03, the branch convs 0.02, the
// weights staged by each of its 10k blocks 0.01, its 2-byte stores and its
// products nothing (hidden). Redesigns measured slower and dropped (PERF.md
// §6): 256-column tiles of 8 warps with the branch convs through a
// k-major shared tile and the output tile staged for 16-byte stores (0.253:
// 118 registers, two blocks per SM, the products' latency exposed); a
// persistent grid that stages the weights once and prefetches the next
// tile's audio (0.210: its blocks run their barrier-bound pools in step,
// where blocks that come and go overlap them with other blocks' GELUs), also
// with two more warps per block taking the pools a tile ahead (0.219); two
// m16 tiles a warp at once, the k16 steps unrolled (0.217-0.26); the next
// hidden pair's product 1 issued before this pair's GELU (0.192); four
// average-pool outputs a thread sharing their loads (0.184). So this
// kernel keeps the former kernel's structure, a block of 4 warps per
// 128-column tile,
// and changes what the measurements named:
//   - The GELU: where a warp vote finds all 256 pre-activations of a
//     hidden-tile pair in erff's small range, that range's polynomial alone
//     (common.cuh gelu_small, erff's values there, 12 instructions), else
//     the library erff. erff's own operations with both ranges computed and
//     selected, without its branch per value, were no faster, with the vote
//     or without it (PERF.md §6).
//   - The average pools divided by k as IEEE division rounds without its
//     branch (common.cuh quotient).
//   - Per warp and m16 tile, as before: each lane computes the branch convs
//     of exactly its own A fragments of product 1 (K ordered by
//     first_block.py:k_slot), product 1 as mma.sync m16n8k16 two hidden n8
//     tiles at a time, b1 and the GELU on the accumulator in registers, the
//     pair packed as product 2's A fragment of that k16 step, product 2
//     accumulated across the five steps; each lane's outputs stored straight
//     to device memory. Above 64 output channels the tile's channels are
//     walked 64 at a time, product 1 and the GELUs redone for each.
//   - The shared-memory attribute is set once per instantiation (the former
//     kernel set it on every launch).
#include "common.cuh"
#include "ptx.cuh"

namespace {

namespace ptx = l3ac::ptx;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 128;                     // output columns per tile: 2 m16 tiles a warp
constexpr int kMaxP = 22;                      // 45 // 2
constexpr int kHalo = 2 * kMaxP + 3;           // 47 samples each side
constexpr int kXLen = kTile + 2 * kHalo;       // staged audio
constexpr int kALen = kTile + 6;               // pooled signal incl. the k7 halo
constexpr int kMKS = kALen + 2 * kMaxP;        // a max pool incl. its avg pool's halo
constexpr int kMid = 80;
constexpr int kMaxNT = 8;                      // output n8 tiles at a time: 64 channels
constexpr int kMaxCout = 256;                  // output channels a launch; wider: chunks of 256

// Ablations (tools/first_block_variants.py --bf16 turns one off at a time):
// kPools the trend pools, kBranch the branch convs, kProducts both mma
// products, kGelu the GELU (identity when off), kStores the output stores
// (a sentinel compare keeps the work alive), kCompute everything after the
// weight staging; kGeluVote the warp vote for erff's small range (off: the
// library erff for every GELU).
constexpr bool kPools = true, kBranch = true, kProducts = true, kGelu = true, kStores = true;
constexpr bool kCompute = true, kGeluVote = true;

struct Args {
  const bf16* x;     // (B, T)
  const float* w;    // first_block.py:pack of a bf16 stem
  bf16* out;         // (B, ldc, T): this launch's Cout channels of ldc
  int B, T, Cout;
  int NT;            // n8 tiles of the packed W2: padded Cout / 8
  int tiles;         // tiles per batch row; the grid is B tiles
  int ldc;           // channels of the output tensor (Cout, or the whole stem's above kMaxCout)
};

// The shared-memory image in 32-bit words: first_block.py:pack's buffer
// (sections(Cout, bf16=True), NT n8 tiles of W2), then the tile's buffers.
struct Layout {
  int w1, w2, b1, b2, wx, wb, bb, weights, xs, m4, m8, m16, mk, as, total;
  __host__ __device__ explicit Layout(int NT) {
    w1 = 0;                          // [10][2][32] (b0, b1)
    w2 = w1 + 10 * 2 * 64;           // [5][NT][32] (b0, b1)
    b1 = w2 + 5 * NT * 64;           // (80)
    b2 = b1 + kMid;                  // (8 NT)
    wx = b2 + 8 * NT;                // (8 NT): w2[:, 80]
    wb = wx + 8 * NT;                // (5, 4, 7) branch convs
    bb = wb + 140;                   // (5, 4)
    weights = bb + 20;               // a multiple of 4 (pack's size)
    xs = weights;                    // x[t0 - 47 + i]
    m4 = xs + kXLen;                 // max |x| over 4 samples from i
    m8 = m4 + kXLen;
    m16 = m8 + kXLen;
    mk = m16 + kXLen;                // the 4 max pools, kMKS each
    as = mk + 4 * kMKS;              // the 4 avg pools, kALen each
    total = as + 4 * kALen;
  }
};

// max-pool k of |x| at v = t0 - 3 - p + r, r in [0, kALen + 2p): the window
// x[v - p .. v + p] is |xs|[s .. s + k) with s = r + kHalo - 3 - 2p, the max
// of two or three running maxima; zero outside [0, T) (the average pool's
// padding). Inside, the window holds v, so the zeros staged outside [0, T)
// never exceed its max, as torch's -inf padding would not.
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

// avg-pool k of the max pool at u = t0 - 3 + q, summed in index order (the
// order of ops/pool.py) and divided as IEEE division rounds; zero outside [0, T)
template <int K>
__device__ __forceinline__ void avg_pool(const float* mk, float* as, int t0, int T) {
  constexpr float kRcp = 1.0f / K;
  for (int q = threadIdx.x; q < kALen; q += kThreads) {
    const int u = t0 - 3 + q;
    float a = 0.0f;
    if (u >= 0 && u < T) {
      float acc = mk[q];
#pragma unroll
      for (int d = 1; d < K; ++d) acc += mk[q + d];
      a = l3ac::quotient(acc, static_cast<float>(K), kRcp);
    }
    as[q] = a;
  }
}

// The four trend pools of the tile whose audio is in xs, into as (4, kALen).
__device__ __forceinline__ void pools(float* smem, const Layout& L, int t0, int T) {
  const float* xs = smem + L.xs;
  float *m4 = smem + L.m4, *m8 = smem + L.m8, *m16 = smem + L.m16;
  float* mk = smem + L.mk;
  float* as = smem + L.as;
  for (int i = threadIdx.x; i < kXLen - 3; i += kThreads)
    m4[i] = fmaxf(fmaxf(fabsf(xs[i]), fabsf(xs[i + 1])), fmaxf(fabsf(xs[i + 2]), fabsf(xs[i + 3])));
  __syncthreads();
  for (int i = threadIdx.x; i < kXLen - 7; i += kThreads) {
    const float m = fmaxf(m4[i], m4[i + 4]);
    m8[i] = m;
    if (i < kXLen - 15) m16[i] = fmaxf(m, fmaxf(m4[i + 8], m4[i + 12]));
  }
  __syncthreads();
  max_pool<5>(m4, m8, m16, mk, t0, T);
  max_pool<11>(m4, m8, m16, mk + kMKS, t0, T);
  max_pool<21>(m4, m8, m16, mk + 2 * kMKS, t0, T);
  max_pool<45>(m4, m8, m16, mk + 3 * kMKS, t0, T);
  __syncthreads();
  avg_pool<5>(mk, as, t0, T);
  avg_pool<11>(mk + kMKS, as + kALen, t0, T);
  avg_pool<21>(mk + 2 * kMKS, as + 2 * kALen, t0, T);
  avg_pool<45>(mk + 3 * kMKS, as + 3 * kALen, t0, T);
  __syncthreads();
}

// bf16 pair of a fragment held as one 32-bit word in the packed weights
__device__ __forceinline__ void fragment(const float* p, uint32_t (&b)[2]) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  b[0] = __float_as_uint(f.x), b[1] = __float_as_uint(f.y);
}

// GELU in place on the 8 pre-activations of a hidden-tile pair
__device__ __forceinline__ void gelu8(float (&y)[2][4]) {
  if constexpr (!kGelu) return;
  if constexpr (kGeluVote) {
    bool small = true;  // & (not &&): no branch per value
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) small &= l3ac::erf_is_small(y[jj][e] * l3ac::kInvSqrt2);
    if (__all_sync(0xffffffffu, small)) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[jj][e] = l3ac::gelu_small(y[jj][e]);
      return;
    }
  }
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[jj][e] = l3ac::gelu(y[jj][e]);
}

template <int kNT>
__global__ void __launch_bounds__(kThreads) first_block_bf16_kernel(const Args a) {
  const Layout L(a.NT);
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int T = a.T;
  for (int i = tid; i < L.weights / 4; i += kThreads)
    reinterpret_cast<float4*>(smem)[i] = __ldg(reinterpret_cast<const float4*>(a.w) + i);
  __syncthreads();
  if constexpr (!kCompute) {
    if (tid == 0 && smem[L.b1] == -1234.5f) a.out[0] = __float2bfloat16_rn(smem[L.b2]);
    return;
  }
  const float* w1f = smem + L.w1;
  const float* w2f = smem + L.w2;
  const float* b1 = smem + L.b1;
  const float* b2 = smem + L.b2;
  const float* wx = smem + L.wx;
  const float* wb = smem + L.wb;
  const float* bb = smem + L.bb;
  const int idx = blockIdx.x, b = idx / a.tiles, t0 = (idx - b * a.tiles) * kTile;
  float* xs = smem + L.xs;
  const float* as = smem + L.as;
  {  // the tile's audio window x[t0 - 47 ..]
    const bf16* xb = a.x + static_cast<long long>(b) * T;
    for (int i = tid; i < kXLen; i += kThreads) {
      const int u = t0 - kHalo + i;
      xs[i] = u >= 0 && u < T ? __bfloat162float(xb[u]) : 0.0f;
    }
  }
  __syncthreads();
  if constexpr (kPools) pools(smem, L, t0, T);

  for (int m0 = warp * 16; m0 < kTile; m0 += kWarps * 16) {
    // the branch convs of lane (g, t): rows g and g + 8, channel t of each branch
    float hb[5][2];
#pragma unroll
    for (int br = 0; br < 5; ++br) {
      const float* ap = (br == 0 ? xs + (kHalo - 3) : as + (br - 1) * kALen) + m0 + g;
      const float* w = wb + (br * 4 + t) * 7;
      hb[br][0] = hb[br][1] = bb[br * 4 + t];
      if constexpr (!kBranch) {
        hb[br][0] += ap[0], hb[br][1] += ap[8];
        continue;
      }
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        const float wk = w[k];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) hb[br][hf] = fmaf(wk, ap[8 * hf + k], hb[br][hf]);
      }
    }
    // product 1's A fragments: k16 step 0 = channel t of branches 0-3, step 1
    // = of branch 4 and zeros (first_block.py:k_slot)
    const uint32_t a1[2][4] = {
        {ptx::bf16x2_rn(hb[0][0], hb[1][0]), ptx::bf16x2_rn(hb[0][1], hb[1][1]),
         ptx::bf16x2_rn(hb[2][0], hb[3][0]), ptx::bf16x2_rn(hb[2][1], hb[3][1])},
        {ptx::bf16x2_rn(hb[4][0], 0.0f), ptx::bf16x2_rn(hb[4][1], 0.0f), 0u, 0u}};
    const float xa = xs[m0 + g + kHalo], xb8 = xs[m0 + g + 8 + kHalo];

#pragma unroll 1
    for (int nt0 = 0; nt0 < a.NT; nt0 += kNT) {
      float acc[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

#pragma unroll 1
      for (int s = 0; s < kMid / 16; ++s) {
        // product 1, hidden tiles 2s and 2s + 1, + b1, the GELU in fp32,
        // rounded: product 2's A fragment of step s
        float y[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            uint32_t bw[2];
            fragment(w1f + (((2 * s + jj) * 2 + ks) * 32 + lane) * 2, bw);
            if constexpr (kProducts) ptx::mma_bf16(z, a1[ks], bw);
            else z[ks] += __uint_as_float(a1[ks][jj] ^ bw[0]);
          }
          const float2 bias = *reinterpret_cast<const float2*>(b1 + 8 * (2 * s + jj) + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) y[jj][e] = z[e] + ((e & 1) ? bias.y : bias.x);
        }
        gelu8(y);
        const uint32_t a2[4] = {ptx::bf16x2_rn(y[0][0], y[0][1]), ptx::bf16x2_rn(y[0][2], y[0][3]),
                                ptx::bf16x2_rn(y[1][0], y[1][1]), ptx::bf16x2_rn(y[1][2], y[1][3])};
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          uint32_t bw[2];
          fragment(w2f + ((s * a.NT + nt0 + nt) * 32 + lane) * 2, bw);
          if constexpr (kProducts) ptx::mma_bf16(acc[nt], a2, bw);
          else acc[nt][0] += __uint_as_float(a2[0] ^ bw[1]);
        }
      }

      // y = acc + b2 + w2[:, 80] x in fp32, rounded to bf16, each lane's
      // values straight out: lane (g, t) holds rows g, g + 8 and columns
      // 2t, 2t + 1 of each n8 tile
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * (nt0 + nt) + 2 * t + (e & 1);
          const int r = m0 + g + 8 * (e >> 1);
          const float v = fmaf(wx[c], (e >> 1) ? xb8 : xa, acc[nt][e] + b2[c]);
          if (c < a.Cout && t0 + r < T && (kStores || v == -1234.5f))
            a.out[(static_cast<long long>(b) * a.ldc + c) * T + t0 + r] = __float2bfloat16_rn(v);
        }
    }
  }
}

template <int kNT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(Layout(a.NT).total);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = first_block_bf16_kernel<kNT>;
  // the attribute once: a host call of microseconds, beside a launch of about
  // a tenth of a millisecond
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int grid = a.B * a.tiles;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: (B, T) bf16 audio; w: first_block.py:pack's buffer of a bf16 stem with
// Cout outputs, 16-byte aligned; out: (B, Cout, T) bf16. Contiguous;
// Cout >= 1: above kMaxCout (ROADMAP C3) the channels run in chunks of
// kMaxCout, one launch each, whose packs first_block.py:pack concatenates
// (each chunk's pack a multiple of 16 bytes). Returns the CUDA error code.
extern "C" int l3ac_first_block_bf16(const void* x, const float* w, void* out, int B, int T,
                                     int Cout, void* stream) {
  if (Cout < 1 || B < 1 || T < 1 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      static_cast<long long>(B) * ((T + kTile - 1) / kTile) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (T + kTile - 1) / kTile;
  for (int c0 = 0; c0 < Cout; c0 += kMaxCout) {
    const int cout = Cout - c0 < kMaxCout ? Cout - c0 : kMaxCout;
    const int nt = (cout + 7) / 8;
    const int NT = nt <= kMaxNT ? nt : (nt + kMaxNT - 1) / kMaxNT * kMaxNT;  // pack's padding
    const Args a{static_cast<const bf16*>(x), w, static_cast<bf16*>(out) + static_cast<long long>(c0) * T,
                 B, T, cout, NT, tiles, Cout};
    cudaError_t err;
    switch (NT <= kMaxNT ? NT : kMaxNT) {
      case 1: err = launch<1>(a, s); break;
      case 2: err = launch<2>(a, s); break;
      case 3: err = launch<3>(a, s); break;
      case 4: err = launch<4>(a, s); break;
      case 5: err = launch<5>(a, s); break;
      case 6: err = launch<6>(a, s); break;
      case 7: err = launch<7>(a, s); break;
      default: err = launch<8>(a, s); break;
    }
    if (err != cudaSuccess) return err;
    w += Layout(NT).weights;  // the next chunk's pack
  }
  return cudaSuccess;
}
