// The bf16 encoder stem as the port ran it before csrc/first_block_bf16.cu
// (PERF.md §6 row 4b, "former kernel"): one block of 4 warps per 128-column tile of one
// batch row (a grid of 1251 x 8 blocks at 8 x 10 s), each copying the packed
// weights into shared memory; the pools from running maxima in shared
// memory, each lane's branch convs for its own A fragments, both 1x1
// products one mma.sync m16n8k16 bf16 pass, the exact GELU through the
// library erff on product 1's accumulator in registers, and each lane's
// outputs stored to device memory 2 bytes at a time. Built only by
// tools/first_block_variants.py --bf16, as the baseline of the redesign in
// csrc/first_block_bf16.cu and the ground of its ablations (the k* flags
// below: each ablation turns one off).
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
constexpr int kMidTiles = kMid / 8;            // n8 tiles of product 1
constexpr int kMaxNT = 8;                      // output n8 tiles per block: 64 channels
constexpr int kMaxCout = 256;

// The shared-memory image, in 32-bit words. The weights are
// first_block.py:pack's buffer of a bf16 stem (first_block.py:sections) for
// this block's output tile, copied once per block; then the tile's buffers.
template <int kNT>
struct Layout {
  // W2's fragments: kW2Steps k steps of kNT tiles of kW2Tile words each
  static constexpr int kW2Steps = kMid / 16;
  static constexpr int kW2Tile = 64;
  static constexpr int w1 = 0;                                // [10][2][32] (b0, b1)
  static constexpr int w2 = w1 + kMidTiles * 2 * 64;
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
  const void* x;     // (B, T) bf16
  const float* w;    // first_block.py:pack
  void* out;         // (B, Cout, T) bf16
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

// bf16 pair of a fragment held as one 32-bit word in the packed weights
__device__ __forceinline__ void fragment_bf16(const float* p, uint32_t (&b)[2]) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  b[0] = __float_as_uint(f.x), b[1] = __float_as_uint(f.y);
}

// Ablations (tools/first_block_variants.py --bf16 turns one off at a time):
// kPools the trend pools, kBranch the branch convs, kProducts both mma
// products, kGelu the GELU (identity when off), kStores the output stores
// (a sentinel compare keeps the work alive), kCompute everything after the
// weight staging.
constexpr bool kPools = true, kBranch = true, kProducts = true, kGelu = true, kStores = true;
constexpr bool kCompute = true;

template <int kNT>
__global__ void __launch_bounds__(kThreads) first_block_bf16_kernel(const Args a) {
  using L = Layout<kNT>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int T = a.T;
  const int nt0 = kNT == kMaxNT ? blockIdx.z * kNT : 0;  // one tile below 64 channels
  stage_weights<L, kNT>(smem, a, nt0);
  const float* w1f = smem + L::w1;
  const float* w2f = smem + L::w2;
  const float* b1 = smem + L::b1;
  const float* b2 = smem + L::b2;
  const float* wx = smem + L::wx;
  const float* wb = smem + L::wb;
  const float* bb = smem + L::bb;
  float* xs = smem + L::xs;
  const float* as = smem + L::as;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(a.x) + static_cast<long long>(b) * T;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);

  if constexpr (!kCompute) {
    __syncthreads();
    if (tid == 0 && smem[L::b1] == -1234.5f) out[0] = __float2bfloat16_rn(smem[L::b2]);
    return;
  }
  for (int i = tid; i < kXLen; i += kThreads) {
    const int u = t0 - kHalo + i;
    xs[i] = (u >= 0 && u < T) ? __bfloat162float(xb[u]) : 0.0f;
  }
  __syncthreads();
  if constexpr (kPools) pools<L>(smem, t0, T);
  else __syncthreads();

  for (int m0 = warp * 16; m0 < kTile; m0 += kWarps * 16) {
    // the branch convs of lane (g, t): rows g and g + 8, channel t of each branch
    float hb[kBranches][2];
#pragma unroll
    for (int br = 0; br < kBranches; ++br) {
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
    // = of branch 4 and zeros (pack's k order)
    const uint32_t a1[2][4] = {
        {ptx::bf16x2_rn(hb[0][0], hb[1][0]), ptx::bf16x2_rn(hb[0][1], hb[1][1]),
         ptx::bf16x2_rn(hb[2][0], hb[3][0]), ptx::bf16x2_rn(hb[2][1], hb[3][1])},
        {ptx::bf16x2_rn(hb[4][0], 0.0f), ptx::bf16x2_rn(hb[4][1], 0.0f), 0u, 0u}};

    float acc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

#pragma unroll 1
    for (int s = 0; s < kMid / 16; ++s) {
      // product 1, hidden tiles 2s and 2s + 1
      float z[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) z[jj][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t bw[2];
          fragment_bf16(w1f + (((2 * s + jj) * 2 + ks) * 32 + lane) * 2, bw);
          if constexpr (kProducts) ptx::mma_bf16(z[jj], a1[ks], bw);
          else z[jj][ks] += __uint_as_float(a1[ks][jj] ^ bw[0]);
        }
      }
      // + b1, exact GELU in fp32, rounded: product 2's A fragment of step s
      float y[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float2 bias = *reinterpret_cast<const float2*>(b1 + 8 * (2 * s + jj) + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = z[jj][e] + ((e & 1) ? bias.y : bias.x);
          y[jj][e] = kGelu ? l3ac::gelu(v) : v;
        }
      }
      const uint32_t a2[4] = {ptx::bf16x2_rn(y[0][0], y[0][1]), ptx::bf16x2_rn(y[0][2], y[0][3]),
                              ptx::bf16x2_rn(y[1][0], y[1][1]), ptx::bf16x2_rn(y[1][2], y[1][3])};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t bw[2];
        fragment_bf16(w2f + ((s * kNT + nt) * 32 + lane) * 2, bw);
        if constexpr (kProducts) ptx::mma_bf16(acc[nt], a2, bw);
        else acc[nt][0] += __uint_as_float(a2[0] ^ bw[1]);
      }
    }

    // y = acc + b2 + w2[:, 80] x[t] in fp32, rounded to bf16
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * nt + 2 * t + (e & 1);
        const int r = m0 + g + 8 * (e >> 1);
        const float v = fmaf(wx[c], xs[r + kHalo], acc[nt][e] + b2[c]);
        const int co = 8 * nt0 + c;
        if (co < a.Cout && t0 + r < T && (kStores || v == -1234.5f))
          out[(static_cast<long long>(b) * a.Cout + co) * T + t0 + r] = __float2bfloat16_rn(v);
      }
  }
}

template <int kNT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Layout<kNT>;
  const size_t smem = sizeof(float) * static_cast<size_t>(L::total);
  static_assert(sizeof(float) * L::total <= 227 * 1024, "shared memory");
  auto kernel = first_block_bf16_kernel<kNT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(l3ac::ceil_div(a.T, kTile), a.B, a.NT / kNT);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

int launch_cout(const void* x, const float* w, void* out, int B, int T, int Cout,
                void* stream) {
  if (Cout < 1 || Cout > kMaxCout || B < 1 || B > 65535 || T < 1 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
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

// The same with bf16 audio in and bf16 features out; w: pack's buffer of a
// bf16 stem.
extern "C" int l3ac_first_block_bf16(const void* x, const float* w, void* out, int B, int T,
                                     int Cout, void* stream) {
  return launch_cout(x, w, out, B, T, Cout, stream);
}
