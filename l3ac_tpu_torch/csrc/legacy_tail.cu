// The decoder's legacy tail as one kernel, audio out:
//   3 x [x + conv1x1(snake(conv_k7,dil d(snake x)))], d = 1, 3, 9
//   -> snake -> conv k7 C -> 1 -> tanh
// with every conv zero-padded at the sequence edges (the residual stream is
// zeroed outside [0, T) after every unit), the products on the tensor cores.
//
// Replaces l3ac_tpu/ops/pallas/legacy_tail.py:legacy_tail_poly_ct (body
// _kernel_poly, input = the two stride-2 phase arrays of the last up path)
// and :legacy_tail_ct (body _kernel, one interleaved (B, C, T) input): one
// kernel, two input modes (x1 null: interleaved).
//
// Bound on the H100: per sample 3 x (7 C^2 + C^2) MACs, 27.6 k operations at
// C = 24, against 4 C bytes read and 4 written. As 3 TF32 passes at 495
// TFLOP/s that is ~0.22 ms per 8 x 10 s decode (1.28 M samples); the 7 C
// exact sines per sample (sinf, ~30 fp32 operations each) are of the same
// order on the fp32 pipe, so the products and the snakes bound it together.
//
// Design: time is the M axis of every product, as in conv_unit_narrow.cu.
//   - A persistent grid, one block of 16 warps per SM (the 128 registers a
//     thread then has), walks tiles of kS = 684 output samples of one batch
//     row with a 42-sample halo per side (3 (1 + 3 + 9) + 3): kW = 768 rows,
//     the same 12 % halo overhead as the SIMT kernel it replaces.
//   - Shared memory holds every weight, staged once per block by cp.async
//     from the prepared buffer (legacy_tail.py:pack: k7 and 1x1 weights in
//     (out, in) rows, zero-filled to multiples of 8 and split into TF32 hi /
//     lo; biases, alphas and 1 / (alpha + eps)), and one time-major
//     activation buffer A (kW + 2 x 27 rows, C rounded up to 8 + 4 columns):
//     218 KB of the 227 at C = 24.
//   - The input is loaded into A in interleaved time order whichever mode it
//     has (phase mode reads x_{g & 1}[g >> 1]), zero outside [0, T). The
//     Pallas kernel routes each k7 tap to a phase because Mosaic cannot
//     interleave lanes; on Hopper the interleave is the load address.
//   - Each warp owns 3 slabs of 16 rows and keeps their residual stream in
//     registers, in the mma accumulator layout. Per unit it writes snake(x)
//     into A at its own positions; after a barrier the dilated k7 conv is 7
//     products per slab whose A operand is the same buffer shifted by
//     (k - 3) d rows: the im2col is a row offset. Each tap (K = Cin) sums
//     into a fresh accumulator added to the fp32 total (csrc/tc_gemm.cuh:
//     the tensor core's own fp32 adds truncate); 3 passes (lo.hi + hi.lo +
//     hi.hi, A split with tf32_rna as it loads). The conv's output becomes the
//     1x1's A operand in registers: its B fragments read W1's rows in the
//     order {0, 4, 1, 5, 2, 6, 3, 7} per n8 tile (ldmatrix takes each row
//     address from a lane), so lane (g, t) holds channels t and t + 4, the A
//     fragment's columns (csrc/local_attention.cu does the same for P). b1
//     and the snake are applied there, the 1x1 (K = C, one fresh
//     accumulator) follows, and its output lands in the residual's own
//     layout: the residual add and the zeroing outside [0, T) are
//     register-local. A second barrier ends the unit.
//   - The final snake goes to A, and the k7 conv C -> 1 (7 C MACs a sample)
//     and tanh run SIMT, one thread per sample; only the audio (B, T) is
//     written, once.
// Widths (C a multiple of 4 up to 64): up to C = 24 as above; from C = 28
// on the weights of one unit no longer fit beside A, so the matrices stay in
// device memory (L2) and each lane reads its B fragments there (the values
// ldmatrix would hand it), only the vectors are staged, and a block is 8
// warps of 2 slabs (256 working rows, 172 output samples a tile) so that the
// residual stream and the accumulators stay in registers.
// Exact sinf and tanhf, no fast math. The snake's division by (alpha + eps)
// is a multiplication by its fp32 reciprocal, prepared with the weights:
// that adds at most 2^-23 relative error to the sin^2 term (one rounding of
// the reciprocal, and the product's against the quotient's).
// The bf16 tail is legacy_tail_bf16.cu.
#include "common.cuh"
#include "ptx.cuh"

namespace {

namespace ptx = l3ac::ptx;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlabs = 3;                    // 16-row slabs per warp
constexpr int kW = 16 * kSlabs * kWarps;     // working rows per tile
constexpr int kHalo = 42;                    // 3 (1 + 3 + 9) + 3
constexpr int kS = kW - 2 * kHalo;           // output samples per tile
constexpr int kPad = 27;                     // zero rows on each side: 3 x the largest dilation
constexpr int kUnits = 3;
constexpr int kTaps = 7;
constexpr int kBatch = 4;                    // input loads in flight per thread
constexpr int kMaxNarrowNT = 3;              // C <= 24: every weight in shared memory
constexpr int kMaxNT = 8;                    // C <= 64
constexpr int kGroup = 4;                    // k8 steps per fresh accumulator: K steps of 32

// The prepared weight buffer (legacy_tail.py:pack), staged as it is, then A.
// kNT n8 tiles of channels: Cp = 8 kNT, rows of kAS = Cp + 4 floats (4 mod 8:
// the eight rows of an ldmatrix tile fall in distinct banks).
template <int kNT>
struct Layout {
  static constexpr int Cp = 8 * kNT;
  static constexpr int AS = Cp + 4;
  static constexpr int w1 = kUnits * kTaps * Cp * AS;  // (3, 7, Cout, Cin) per hi / lo
  static constexpr int w2 = kUnits * Cp * AS;          // (3, Cout, Cin) per hi / lo
  static constexpr int w1h = 0, w1l = w1, w2h = 2 * w1, w2l = 2 * w1 + w2;
  static constexpr int b1 = 2 * w1 + 2 * w2;            // (3, Cp) each:
  static constexpr int a1 = b1 + kUnits * Cp;           //   snake before the k7 conv
  static constexpr int r1 = a1 + kUnits * Cp;           //   1 / (a1 + eps)
  static constexpr int a2 = r1 + kUnits * Cp;           //   snake before the 1x1
  static constexpr int r2 = a2 + kUnits * Cp;
  static constexpr int b2 = r2 + kUnits * Cp;
  static constexpr int ao = b2 + kUnits * Cp;           // (Cp) the last snake
  static constexpr int ro = ao + Cp;
  static constexpr int wo = ro + Cp;                    // (7, Cp) output conv
  static constexpr int bo = wo + kTaps * Cp;            // (4) its bias, 3 zeros
  static constexpr int weights = bo + 4;
  static constexpr int A = weights;                     // (kW + 2 kPad, AS)
  static constexpr int total = A + (kW + 2 * kPad) * AS;
};

struct Args {
  const float* x0;   // (B, C, T) interleaved, or the even phase (B, C, T / 2)
  const float* x1;   // null, or the odd phase
  const float* wts;  // the prepared buffer, Layout::weights floats
  float* out;        // (B, T)
  int B, C, T;
  long long xB, xC;  // batch and channel strides of x0 and x1
};

__device__ __forceinline__ float snake_r(float h, float a, float r) {
  const float s = sinf(a * h);
  return h + s * s * r;
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = ptx::tf32_rna(x[i]);
    lo[i] = ptx::tf32_rna(x[i] - __uint_as_float(hi[i]));
  }
}

// one m16n8k8 step, 3 passes, small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  const uint32_t bh[2] = {bh0, bh1}, bl[2] = {bl0, bl1};
  ptx::mma_tf32(d, al, bh);
  ptx::mma_tf32(d, ah, bl);
  ptx::mma_tf32(d, ah, bh);
}

// The block's tiling: the narrow widths (C <= 24) keep every weight in
// shared memory and give each of 16 warps 3 slabs; the wide ones (C 32-64)
// read the matrices from device memory (L2) and give each of 8 warps 2
// slabs, so that the residual stream and the accumulators fit the
// registers a thread then has.
template <bool kWide>
struct Tiling {
  static constexpr int kWarps = kWide ? 8 : ::kWarps;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSlabs = kWide ? 2 : ::kSlabs;
  static constexpr int kW = 16 * kSlabs * kWarps;  // working rows per tile
  static constexpr int kS = kW - 2 * kHalo;        // output samples per tile
};

// The B fragments of a pair of n8 tiles read from device memory, as
// ldmatrix_x4 delivers them from the same rows in shared memory: b[2 j] =
// row (8 j + row) of words t and t + 4, b[2 j + 1] the same 8 rows down.
__device__ __forceinline__ void fragments(uint32_t (&b)[4], const float* p, int row, int t,
                                          int stride) {
  const float* r0 = p + row * stride + t;
  const float* r1 = r0 + 8 * stride;
  b[0] = __float_as_uint(__ldg(r0));
  b[1] = __float_as_uint(__ldg(r0 + 4));
  b[2] = __float_as_uint(__ldg(r1));
  b[3] = __float_as_uint(__ldg(r1 + 4));
}

template <int kNT, bool kWide>
__global__ void __launch_bounds__(Tiling<kWide>::kThreads, 1) legacy_tail_kernel(const Args a) {
  using L = Layout<kNT>;
  using G = Tiling<kWide>;
  constexpr int kThreads = G::kThreads, kWarps = G::kWarps, kSlabs = G::kSlabs;
  constexpr int kW = G::kW, kS = G::kS;
  // the vectors' offsets in shared memory: after the matrices (narrow), or
  // first (wide, the matrices stay in device memory)
  constexpr int kVec = kWide ? L::b1 : 0;
  constexpr int kPairs = (kNT + 1) / 2;
  extern __shared__ __align__(16) float smem[];
  float* A = smem + (kWide ? L::weights - L::b1 : L::A);
  const float* vec = smem - kVec;  // vec + L::b1 etc.: the vectors wherever they sit
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q8 = lane >> 3, r8 = lane & 7, g = lane >> 2, t4 = lane & 3;
  const int C = a.C, T = a.T;

  for (int e = tid; e < (L::weights - kVec) / 4; e += kThreads)
    ptx::cp_async16(smem + 4 * e, a.wts + kVec + 4 * e, 16);
  ptx::cp_async_commit();
  for (int e = tid; e < (kW + 2 * kPad) * L::AS; e += kThreads) A[e] = 0.0f;
  ptx::cp_async_wait<0>();

  // ldmatrix offsets: A fragments (rows r8 (+8), words 0-3 / 4-7); the k7
  // weights' B fragments with rows in the order sigma(r) = r / 2 + 4 (r % 2);
  // the 1x1's in their natural order
  const int a_off = ((q8 & 1) * 8 + r8) * L::AS + (q8 >> 1) * 4;
  const int w1_off = ((q8 >> 1) * 8 + (r8 >> 1) + 4 * (r8 & 1)) * L::AS + (q8 & 1) * 4;
  const int w2_off = ((q8 >> 1) * 8 + r8) * L::AS + (q8 & 1) * 4;
  const int w1_row = (g >> 1) + 4 * (g & 1);  // sigma(g): the k7 weights' row within an n8 tile

  const int tiles_per_row = (T + kS - 1) / kS;
  for (int tile = blockIdx.x; tile < a.B * tiles_per_row; tile += gridDim.x) {
    const int b = tile / tiles_per_row;
    const long long g0 = static_cast<long long>(tile - b * tiles_per_row) * kS - kHalo;
    __syncthreads();  // the weights have landed; the last tile's reads of A are done

    // x -> A (time-major), zero outside [0, T); channels past C stay zero
    {
      const float* xb0 = a.x0 + b * a.xB;
      const float* xb1 = a.x1 == nullptr ? nullptr : a.x1 + b * a.xB;
      const int n = C * kW;
      for (int e0 = tid; e0 < n; e0 += kBatch * kThreads) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kThreads, c = e / kW;
          const long long t = g0 + (e - c * kW);
          v[u] = 0.0f;
          if (e < n && t >= 0 && t < T)
            v[u] = xb1 == nullptr ? xb0[c * a.xC + t] : ((t & 1) ? xb1 : xb0)[c * a.xC + (t >> 1)];
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kThreads, c = e / kW;
          if (e < n) A[(kPad + e - c * kW) * L::AS + c] = v[u];
        }
      }
    }
    __syncthreads();

    // the residual stream of this warp's slabs: lane (g, t4) holds rows g and
    // g + 8, channels nt * 8 + 2 t4 (+1); rows outside [0, T) are zero
    float xr[kSlabs][kNT][4];
    bool valid[kSlabs][2];
#pragma unroll
    for (int s = 0; s < kSlabs; ++s) {
      const int row = 16 * (warp + kWarps * s) + g;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const long long t = g0 + row + 8 * hf;
        valid[s][hf] = t >= 0 && t < T;
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float2 v = *reinterpret_cast<const float2*>(
              A + (kPad + row + 8 * hf) * L::AS + nt * 8 + 2 * t4);
          xr[s][nt][2 * hf] = v.x;
          xr[s][nt][2 * hf + 1] = v.y;
        }
    }

    // A = snake(residual) at this lane's own positions
    auto write_snake = [&](const float* alpha, const float* recip) {
#pragma unroll
      for (int s = 0; s < kSlabs; ++s) {
        const int row = 16 * (warp + kWarps * s) + g;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int c = nt * 8 + 2 * t4;
          const float al0 = alpha[c], al1 = alpha[c + 1], rc0 = recip[c], rc1 = recip[c + 1];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float v0 = xr[s][nt][2 * hf], v1 = xr[s][nt][2 * hf + 1];
            *reinterpret_cast<float2*>(A + (kPad + row + 8 * hf) * L::AS + c) =
                make_float2(c < C ? snake_r(v0, al0, rc0) : 0.0f,
                            c + 1 < C ? snake_r(v1, al1, rc1) : 0.0f);
          }
        }
      }
    };

#pragma unroll 1
    for (int u = 0; u < kUnits; ++u) {
      const int d = u == 0 ? 1 : (u == 1 ? 3 : 9);
      write_snake(vec + L::a1 + u * kNT * 8, vec + L::r1 + u * kNT * 8);
      __syncthreads();
      // the matrices: ldmatrix rows in shared memory (narrow), or the B
      // fragments read from device memory, wk / pair / step offsets alike
      const float* wsrc = kWide ? a.wts : smem;
      const float* w1h = wsrc + L::w1h + u * kTaps * L::Cp * L::AS + (kWide ? 0 : w1_off);
      const float* w1l = wsrc + L::w1l + u * kTaps * L::Cp * L::AS + (kWide ? 0 : w1_off);
      const float* w2h = wsrc + L::w2h + u * L::Cp * L::AS + (kWide ? 0 : w2_off);
      const float* w2l = wsrc + L::w2l + u * L::Cp * L::AS + (kWide ? 0 : w2_off);
      const float* b1 = vec + L::b1 + u * L::Cp;
      const float* a2 = vec + L::a2 + u * L::Cp;
      const float* r2 = vec + L::r2 + u * L::Cp;
      const float* b2 = vec + L::b2 + u * L::Cp;
#pragma unroll
      for (int s = 0; s < kSlabs; ++s) {
        const float* pa = A + (kPad + 16 * (warp + kWarps * s)) * L::AS + a_off;
        // the k7 conv: acc[nt][e] is row g (+8 for e >= 2), channel
        // nt * 8 + t4 + 4 (e & 1)
        float conv[kNT][4];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) conv[nt][e] = 0.0f;
#pragma unroll 1
        for (int k = 0; k < kTaps; ++k) {
          const float* pk = pa + (k - 3) * d * L::AS;
          const int wk = k * L::Cp * L::AS;
#pragma unroll
          for (int c0 = 0; c0 < kNT; c0 += kGroup) {  // a fresh accumulator per K step of 32
          float acc[kNT][4];
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
          for (int c8 = c0; c8 < c0 + kGroup && c8 < kNT; ++c8) {
            uint32_t raw[4], ah[4], al[4];
            ptx::ldmatrix_x4(raw, pk + c8 * 8);
            float x[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) x[e] = __uint_as_float(raw[e]);
            split(x, ah, al);
#pragma unroll
            for (int p = 0; p < kPairs; ++p) {
              uint32_t bh[4], bl[4];
              if constexpr (kWide) {
                fragments(bh, w1h + wk + p * 16 * L::AS + c8 * 8, w1_row, t4, L::AS);
                fragments(bl, w1l + wk + p * 16 * L::AS + c8 * 8, w1_row, t4, L::AS);
              } else {
                ptx::ldmatrix_x4(bh, w1h + wk + p * 16 * L::AS + c8 * 8);
                ptx::ldmatrix_x4(bl, w1l + wk + p * 16 * L::AS + c8 * 8);
              }
              mma3(acc[2 * p], ah, al, bh[0], bh[1], bl[0], bl[1]);
              if (2 * p + 1 < kNT)
                mma3(acc[(2 * p + 1) % kNT], ah, al, bh[2], bh[3], bl[2], bl[3]);
            }
          }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) conv[nt][e] += acc[nt][e];
          }
        }
        // b1 and the snake: conv[nt] becomes the 1x1's A fragment of k8 step
        // nt, {H[g][t4], H[g+8][t4], H[g][t4+4], H[g+8][t4+4]}
        float y[kNT][4];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = nt * 8 + t4 + 4 * (e & 1);
            const float v = conv[nt][e] + b1[c];
            y[nt][(e & 1) * 2 + (e >> 1)] = c < C ? snake_r(v, a2[c], r2[c]) : 0.0f;
          }
        float sum2[kNT][4];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum2[nt][e] = 0.0f;
#pragma unroll
        for (int k0 = 0; k0 < kNT; k0 += kGroup) {  // a fresh accumulator per K step of 32
        float acc2[kNT][4];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc2[nt][e] = 0.0f;
#pragma unroll
        for (int k8 = k0; k8 < k0 + kGroup && k8 < kNT; ++k8) {
          uint32_t yh[4], yl[4];
          split(y[k8], yh, yl);
#pragma unroll
          for (int p = 0; p < kPairs; ++p) {
            uint32_t bh[4], bl[4];
            if constexpr (kWide) {
              fragments(bh, w2h + p * 16 * L::AS + k8 * 8, g, t4, L::AS);
              fragments(bl, w2l + p * 16 * L::AS + k8 * 8, g, t4, L::AS);
            } else {
              ptx::ldmatrix_x4(bh, w2h + p * 16 * L::AS + k8 * 8);
              ptx::ldmatrix_x4(bl, w2l + p * 16 * L::AS + k8 * 8);
            }
            mma3(acc2[2 * p], yh, yl, bh[0], bh[1], bl[0], bl[1]);
            if (2 * p + 1 < kNT)
              mma3(acc2[(2 * p + 1) % kNT], yh, yl, bh[2], bh[3], bl[2], bl[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum2[nt][e] += acc2[nt][e];
        }
        // the residual, zero outside [0, T): sum2[nt][e] is row g (+8),
        // channel nt * 8 + 2 t4 + (e & 1), the layout of xr
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float bb = b2[nt * 8 + 2 * t4 + (e & 1)];
            xr[s][nt][e] = valid[s][e >> 1] ? xr[s][nt][e] + (sum2[nt][e] + bb) : 0.0f;
          }
      }
      __syncthreads();  // every read of A is done before it is rewritten
    }

    // snake -> conv k7 C -> 1 -> tanh, one thread per output sample
    write_snake(vec + L::ao, vec + L::ro);
    __syncthreads();
    const float* wo = vec + L::wo;
    float* ob = a.out + static_cast<long long>(b) * T;
    for (int j = tid; j < kS; j += kThreads) {
      const long long t = g0 + kHalo + j;
      if (t >= T) break;
      float yv = vec[L::bo];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const float* ar = A + (kPad + kHalo + j + k - 3) * L::AS;
#pragma unroll
        for (int c = 0; c < L::Cp; c += 4) {
          const float4 av = *reinterpret_cast<const float4*>(ar + c);
          const float4 wv = *reinterpret_cast<const float4*>(wo + k * L::Cp + c);
          yv += wv.x * av.x;
          yv += wv.y * av.y;
          yv += wv.z * av.z;
          yv += wv.w * av.w;
        }
      }
      ob[t] = tanhf(yv);
    }
  }
}

template <int kNT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Layout<kNT>;
  constexpr bool kWide = kNT > kMaxNarrowNT;
  using G = Tiling<kWide>;
  const size_t smem = sizeof(float) * static_cast<size_t>(
      kWide ? L::weights - L::b1 + (G::kW + 2 * kPad) * L::AS : L::total);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(legacy_tail_kernel<kNT, kWide>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, legacy_tail_kernel<kNT, kWide>, G::kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = static_cast<long long>(a.B) * l3ac::ceil_div(a.T, G::kS);
  const int grid = static_cast<int>(tiles < sms * per_sm ? tiles : sms * per_sm);
  legacy_tail_kernel<kNT, kWide><<<grid, G::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The floats of the prepared weight buffer at C channels (legacy_tail.py:pack
// builds it and checks its size against this), or 0 for a C it does not take.
extern "C" int l3ac_legacy_tail_weight_floats(int C) {
  if (C < 4 || C > 8 * kMaxNT || C % 4 != 0) return 0;
  switch ((C + 7) / 8) {
    case 1: return Layout<1>::weights;
    case 2: return Layout<2>::weights;
    case 3: return Layout<3>::weights;
    case 4: return Layout<4>::weights;
    case 5: return Layout<5>::weights;
    case 6: return Layout<6>::weights;
    case 7: return Layout<7>::weights;
    default: return Layout<8>::weights;
  }
}

// x0 (and x1): (B, C, T) interleaved with x1 null, or the phase pair
// (B, C, T / 2) with x[2t + q] = x_q[t]; xB, xC their batch and channel
// strides (time contiguous). wts: legacy_tail.py:pack, 16-byte aligned.
// out: (B, T). C a multiple of 4 up to 64. Returns the CUDA error code.
extern "C" int l3ac_legacy_tail(const float* x0, const float* x1, const float* wts,
                                float* out, int B, int C, int T, long long xB,
                                long long xC, void* stream) {
  if (B < 1 || T < 1 || (x1 != nullptr && T % 2 != 0) ||
      reinterpret_cast<uintptr_t>(wts) % 16 != 0)
    return cudaErrorInvalidValue;
  if (C < 4 || C > 8 * kMaxNT || C % 4 != 0) return cudaErrorInvalidValue;
  const Args a{x0, x1, wts, out, B, C, T, xB, xC};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((C + 7) / 8) {
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
