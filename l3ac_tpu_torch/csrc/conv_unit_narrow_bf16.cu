// Residual ConvUnit on bf16 (B, C, T) for C <= 96, fused, both products one
// bf16 tensor-core pass: the bf16 variant of conv_unit_narrow.cu, designed
// for the H100.
//
// Replaces l3ac_tpu/ops/pallas/conv_unit.py:conv_unit_ct (body _kernel_t) on
// bf16 activations at the encoder's channels-first widths (24, 48, 96; debug's
// 8, 12, 16), rounding where that body does:
//   depthwise conv k, dilation d, zero pad, from the dw bias, taps added in
//   order in fp32 -> ChannelNorm (eps 1e-8 inside the sqrt, fp32, affine)
//   -> bf16 -> pw1 C->4C (fp32 sums) + b1 -> snake (or exact GELU) in fp32
//   -> bf16 -> pw2 4C->C with GRN folded (W2' bf16, fp32 sums) + b2'
//   -> + x in fp32 -> bf16.
// Its operands come in one buffer prepared once per weight set
// (ops/kernels/conv_unit.py:narrow_pack): W1 and W2' in bf16, already in the
// mma B-fragment order of each lane; per hidden unit b1, alpha, alpha + eps
// and its correctly rounded reciprocal; the depthwise taps (K, Cp), dw bias,
// norm weight and bias and b2' in fp32.
//
// Bound on the H100: 16 C^2 operations per column on the tensor cores
// against 4 C bytes moved, and 4 C snakes per column on the fp32 pipe. Per
// 8 x 10 s decode the bytes take 0.10 ms at 3.35 TB/s, the products 0.09
// at the bf16 rate, and the snakes 0.18 (21 instructions each as sin2_ilp
// runs them, at the SMs' issue rate of one warp instruction per scheduler
// per clock), 0.22 with the taps, the norm and the adds (chip_smoke.py
// snake_bound_ms).
// The former design ran at 3.71 ms: the library sine and IEEE division were
// 1.65 of it, x in and out by 2-byte loads 0.70 (tools/narrow_variants.py
// --bf16). This one runs at 1.19 ms (0.64 encode), where the same tool puts
// the snake at 0.41 (its sines 0.33), the products about 0.3, the depthwise
// taps 0.2, the norm 0.06 and x in and out 0.20 (PERF.md §6): the SMs' fp32
// issue of the snake, then the mma.sync products, bound it.
//
// Design:
//   - A persistent grid: each block (8 warps, 128 time columns a tile, 16 a
//     warp as the M axis of both products) stages the whole prepared buffer
//     in shared memory once (W1 and W2' are 16 C^2 bytes: 147 KB at C = 96)
//     and walks tiles of (batch row, 128 columns).
//   - x is staged channel-major with its halo, rounded out to the aligned
//     16-byte pieces that hold it (cp.async, zero past the tensor's ends;
//     a row starts at its own offset o_c in [0, 8), so any T works), two
//     stages: the next tile's x lands while this one computes. Positions
//     outside [0, T) are zeroed on the edge tiles. Where a halo is too wide
//     for two stages beside the weights, the stage holds what fits and the
//     outer taps read device memory (a warp-uniform choice per tap).
//   - Each warp computes the depthwise conv of its 16 columns straight into
//     pw1's A-fragment layout in registers (lane (g, t): rows g, g + 8 and
//     channels 2t, 2t + 1, 2t + 8, 2t + 9 of each k16 step), ChannelNorm's
//     moments by quad shuffles, no fp32 tile and no transpose.
//   - The 4C hidden units in steps of 32: pw1 (m16n8k16, B fragments one
//     16-byte shared-memory load per two n8 tiles), + b1 and the snake
//     (sin2_ilp and a Newton quotient on the prepared reciprocal, 16 values
//     at once: no branch per value) in fp32, rounded into pw2's A fragments
//     in registers (h never leaves them), pw2 into the (16, C) sums. No
//     block barrier inside the walk.
//   - The residual x is read from the staged tile, out = bf16(x + y) written
//     over it in place, and the tile's columns stored as 16-byte pieces.
// Three block barriers a tile (stage landed; all depthwise reads done before
// the stage is overwritten; the output complete before it is stored).
#include "common.cuh"
#include "ptx.cuh"

namespace {

namespace ptx = l3ac::ptx;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kS = 16 * kWarps;  // columns per tile: one m16 slab per warp
constexpr int kStep = 32;        // hidden units per step: two k16 steps of pw2
constexpr int kMaxC = 96;
constexpr int kSmemMax = 227 * 1024;
constexpr float kNormEps = 1e-8f;

struct Args {
  const bf16* x;
  bf16* out;
  const uint4* pk;   // narrow_pack's buffer
  int B, C, T, K, dil;
  int norm, snake;   // ChannelNorm present; snake (else exact GELU)
  int steps;         // hidden steps of 32: ceil(4C / 32)
  int halo, sp;      // the conv's halo; the staged halo (a multiple of 8, <= round8(halo))
  int xw, rs;        // staged columns kS + 2 sp; a stage row's stride, xw + 8
  int fast;          // x and out 16-byte aligned: cp.async staging, 16-byte stores
  float* part;       // tensor-parallel mode: (B, C, T) fp32, the shard's sum, no residual
};

// The prepared buffer's regions in 16-byte units, as narrow_pack lays them
// out: W1 fragments, W2' fragments, hidden-unit vectors, the fp32 vectors.
struct Packed {
  int w1, w2, hv, cv, total;
  __host__ __device__ Packed(int kP, int steps, int K) {
    w1 = 0;
    w2 = steps * 2 * kP * 32;
    hv = 2 * w2;
    cv = hv + steps * kStep;
    total = cv + (K + 4) * 16 * kP / 4;
  }
};

inline int stage_bytes(int C, int rs) { return 2 * 2 * C * rs; }

template <int kP>
__global__ void __launch_bounds__(kThreads, kP <= 3 ? 2 : 1) narrow_bf16_kernel(const Args a) {
  constexpr int kCp = 16 * kP;      // channels padded to k16 steps
  extern __shared__ __align__(16) uint4 smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int C = a.C, T = a.T, K = a.K;
  const Packed P(kP, a.steps, K);
  const uint4* w1f = smem + P.w1;
  const uint4* w2f = smem + P.w2;
  const float4* hv = reinterpret_cast<const float4*>(smem + P.hv);
  const float* cv = reinterpret_cast<const float*>(smem + P.cv);  // dw (K, Cp), dw_b, nw, nb, b2
  bf16* stages = reinterpret_cast<bf16*>(smem + P.total);
  const int stage_elems = C * a.rs;
  const long long n_x = static_cast<long long>(a.B) * C * T;
  const int tiles_per_row = (T + kS - 1) / kS, tiles = a.B * tiles_per_row;

  // x columns [t0 - sp, t0 - sp + xw) of every channel into st: row c at
  // st + c rs + o_c, o_c = its first element's flat index mod 8
  auto stage_x = [&](int tile, bf16* st) {
    const int b = tile / tiles_per_row, ws = (tile - b * tiles_per_row) * kS - a.sp;
    if (a.fast) {
      const int pieces = a.rs / 8;
      for (int e = tid; e < C * pieces; e += kThreads) {
        const int c = e / pieces, k = e - c * pieces;
        // the aligned piece k of row c: flat elements [f, f + 8), f % 8 == 0
        const long long f = (((static_cast<long long>(b) * C + c) * T + ws) & ~7LL) + 8 * k;
        const long long left = n_x - f;
        const int n = f < 0 || left <= 0 ? 0 : (left < 8 ? static_cast<int>(left) : 8);
        ptx::cp_async16(st + c * a.rs + 8 * k, n > 0 ? a.x + f : a.x, 2 * n);
      }
    } else {
      for (int e = tid; e < C * a.xw; e += kThreads) {
        const int c = e / a.xw, j = e - c * a.xw, tt = ws + j;
        const long long f0 = (static_cast<long long>(b) * C + c) * T;
        const int o = static_cast<int>((f0 + ws) & 7);
        st[c * a.rs + o + j] = (tt >= 0 && tt < T) ? a.x[f0 + tt] : __float2bfloat16_rn(0.0f);
      }
    }
  };

  int tile = blockIdx.x;
  for (int e = tid; e < P.total; e += kThreads) ptx::cp_async16(smem + e, a.pk + e, 16);
  if (tile < tiles) stage_x(tile, stages);
  ptx::cp_async_commit();

  const float* dwb = cv + K * kCp;
  const float* nw = dwb + kCp;
  const float* nb = nw + kCp;
  const float* b2 = nb + kCp;

  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    bf16* st = stages + (it & 1) * stage_elems;
    const int b = tile / tiles_per_row, t0 = (tile - b * tiles_per_row) * kS, ws = t0 - a.sp;
    const long long fb = static_cast<long long>(b) * C * T;  // flat index of (b, 0, 0)
    ptx::cp_async_wait<0>();
    __syncthreads();  // this tile's stage has landed; the last tile's stores are done
    if (tile + gridDim.x < tiles) stage_x(tile + gridDim.x, stages + ((it + 1) & 1) * stage_elems);
    ptx::cp_async_commit();
    if (a.fast && (ws < 0 || ws + a.xw > T)) {  // zero the staged columns outside [0, T)
      for (int e = tid; e < C * a.xw; e += kThreads) {
        const int c = e / a.xw, j = e - c * a.xw, tt = ws + j;
        if (tt < 0 || tt >= T)
          st[c * a.rs + static_cast<int>((fb + static_cast<long long>(c) * T + ws) & 7) + j] =
              __float2bfloat16_rn(0.0f);
      }
      __syncthreads();
    }

    // 1. depthwise conv and ChannelNorm of this warp's 16 columns, in pw1's
    //    A-fragment layout: v[ks][h][e][r] is channel 16 ks + 8 h + 2 t + e,
    //    row g + 8 r
    float v[kP][2][2][2];
    const int j0 = a.sp - a.halo + 16 * warp;  // window column of tap 0, row 0
#pragma unroll
    for (int ks = 0; ks < kP; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cb = 16 * ks + 8 * h + 2 * t;
        const bf16* row[2];
        bool ok[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = cb + e;
          ok[e] = c < C;
          const int cc = ok[e] ? c : 0;
          row[e] = st + cc * a.rs +
                   static_cast<int>((fb + static_cast<long long>(cc) * T + ws) & 7) + j0 + g;
          v[ks][h][e][0] = v[ks][h][e][1] = dwb[cb + e];
        }
        for (int k = 0; k < K; ++k) {
          const int off = k * a.dil;  // window column j0 + off + row
          const float2 w = *reinterpret_cast<const float2*>(cv + k * kCp + cb);
          const float wk[2] = {w.x, w.y};
          if (j0 + off >= 0 && j0 + off + 15 < a.xw) {  // warp-uniform: in the stage
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (ok[e]) {
                v[ks][h][e][0] = fmaf(__bfloat162float(row[e][off]), wk[e], v[ks][h][e][0]);
                v[ks][h][e][1] = fmaf(__bfloat162float(row[e][off + 8]), wk[e], v[ks][h][e][1]);
              }
          } else {  // a halo wider than the stage: device memory, zero outside [0, T)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (ok[e]) {
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                  const int tt = ws + j0 + off + g + 8 * r;
                  const float xv = (tt >= 0 && tt < T)
                      ? __bfloat162float(a.x[fb + static_cast<long long>(cb + e) * T + tt])
                      : 0.0f;
                  v[ks][h][e][r] = fmaf(xv, wk[e], v[ks][h][e][r]);
                }
              }
          }
        }
      }
    if (a.norm) {  // moments of rows g and g + 8 over the C channels: quad shuffles
      float u[2], q[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float s = 0.0f;
#pragma unroll
        for (int ks = 0; ks < kP; ++ks)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) s += v[ks][h][e][r];  // zero past C
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        u[r] = s / C;
        float d2 = 0.0f;
#pragma unroll
        for (int ks = 0; ks < kP; ++ks)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (16 * ks + 8 * h + 2 * t + e < C) {
                const float dv = v[ks][h][e][r] - u[r];
                d2 = fmaf(dv, dv, d2);
              }
        d2 += __shfl_xor_sync(0xffffffffu, d2, 1);
        d2 += __shfl_xor_sync(0xffffffffu, d2, 2);
        q[r] = sqrtf(d2 / C + kNormEps);
      }
      const float rq[2] = {__frcp_rn(q[0]), __frcp_rn(q[1])};
#pragma unroll
      for (int ks = 0; ks < kP; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 16 * ks + 8 * h + 2 * t + e;
#pragma unroll
            for (int r = 0; r < 2; ++r)
              v[ks][h][e][r] =
                  c < C ? l3ac::quotient(v[ks][h][e][r] - u[r], q[r], rq[r]) * nw[c] + nb[c]
                        : 0.0f;
          }
    }
    uint32_t af[kP][4];
#pragma unroll
    for (int ks = 0; ks < kP; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          af[ks][2 * h + r] = ptx::bf16x2_rn(v[ks][h][0][r], v[ks][h][1][r]);

    // 2. the hidden units, 32 a step: pw1, b1 and the activation, pw2
    float acc[2 * kP][4];
#pragma unroll
    for (int n = 0; n < 2 * kP; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;
#pragma unroll 1
    for (int si = 0; si < a.steps; ++si) {
      float s1[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s1[n][i] = 0.0f;
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int ks = 0; ks < kP; ++ks) {
          const uint4 w = w1f[((2 * si + p) * kP + ks) * 32 + lane];
          const uint32_t b0[2] = {w.x, w.y}, b1[2] = {w.z, w.w};
          ptx::mma_bf16(s1[2 * p], af[ks], b0);
          ptx::mma_bf16(s1[2 * p + 1], af[ks], b1);
        }
      // s1[n][i]: row g + 8 (i >> 1), hidden unit 32 si + 8 n + 2 t + (i & 1)
      float y[16];
      const float4* hs = hv + kStep * si + 2 * t;
      if (a.snake) {
        float al[16], dd[16], rc[16];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 hu = hs[8 * n + e];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * n + 2 * r + e;
              y[i] = s1[n][2 * r + e] + hu.x;
              al[i] = hu.y;
              dd[i] = hu.z;
              rc[i] = hu.w;
            }
          }
        l3ac::snake2_ilp(y, al, dd, rc);
      } else {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float bias = hs[8 * n + e].x;
#pragma unroll
            for (int r = 0; r < 2; ++r) y[4 * n + 2 * r + e] = l3ac::gelu(s1[n][2 * r + e] + bias);
          }
      }
      // bf16(h) as pw2's A fragments of k16 steps 2 si and 2 si + 1
      uint32_t hf[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = 2 * kk + (i >> 1), r = i & 1;
          hf[kk][i] = ptx::bf16x2_rn(y[4 * n + 2 * r], y[4 * n + 2 * r + 1]);
        }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          const uint4 w = w2f[((2 * si + kk) * kP + p) * 32 + lane];
          const uint32_t b0[2] = {w.x, w.y}, b1[2] = {w.z, w.w};
          ptx::mma_bf16(acc[2 * p], hf[kk], b0);
          ptx::mma_bf16(acc[2 * p + 1], hf[kk], b1);
        }
    }

    if (a.part != nullptr) {  // TP mode: sum + b2' in fp32, unrounded, no residual
#pragma unroll
      for (int n = 0; n < 2 * kP; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * t + e;
          if (c >= C) continue;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int tt = t0 + 16 * warp + g + 8 * r;
            if (tt < T) a.part[fb + static_cast<long long>(c) * T + tt] = acc[n][2 * r + e] + b2[c];
          }
        }
      continue;  // the stage is not written: the next tile's barrier suffices
    }

    // 3. out = bf16(x + (sum + b2')) over the staged x, then stored
    __syncthreads();  // every warp's depthwise reads of this stage are done
#pragma unroll
    for (int n = 0; n < 2 * kP; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n + 2 * t + e;
        if (c >= C) continue;
        bf16* xr = st + c * a.rs + static_cast<int>((fb + static_cast<long long>(c) * T + ws) & 7) +
                   a.sp + 16 * warp + g;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          xr[8 * r] =
              __float2bfloat16_rn(__bfloat162float(xr[8 * r]) + (acc[n][2 * r + e] + b2[c]));
      }
    __syncthreads();
    const int cols = T - t0 < kS ? T - t0 : kS;
    if (a.fast) {
      constexpr int kPieces = kS / 8 + 1;
      for (int e = tid; e < C * kPieces; e += kThreads) {
        const int c = e / kPieces, k = e - c * kPieces;
        const long long f = fb + static_cast<long long>(c) * T + t0;  // flat index of column 0
        const int o = static_cast<int>(f & 7);
        const int lo = 8 * k - o, hi = lo + 8;  // this piece's columns relative to t0
        if (hi <= 0 || lo >= cols) continue;
        const bf16* src = st + c * a.rs + a.sp + 8 * k;  // the piece's first element, aligned
        bf16* dst = a.out + (f - o) + 8 * k;
        if (lo >= 0 && hi <= cols) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int i = 0; i < 8; ++i)
            if (lo + i >= 0 && lo + i < cols) dst[i] = src[i];
        }
      }
    } else {
      for (int e = tid; e < C * kS; e += kThreads) {
        const int c = e / kS, j = e - c * kS;
        if (j >= cols) continue;
        const long long f = fb + static_cast<long long>(c) * T + t0;
        a.out[f + j] = st[c * a.rs + static_cast<int>((f - a.sp) & 7) + a.sp + j];
      }
    }
  }
}

template <int kP>
cudaError_t launch_at(Args a, cudaStream_t stream) {
  const Packed P(kP, a.steps, a.K);
  const int fixed = 16 * P.total;
  // the widest staged halo that fits two stages beside the weights
  int sp = (a.halo + 7) / 8 * 8;
  while (sp > 0 && fixed + stage_bytes(a.C, kS + 2 * sp + 8) > kSmemMax) sp -= 8;
  a.sp = sp;
  a.xw = kS + 2 * sp;
  a.rs = a.xw + 8;
  const int smem = fixed + stage_bytes(a.C, a.rs);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(narrow_bf16_kernel<kP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, narrow_bf16_kernel<kP>,
                                                           kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = static_cast<long long>(a.B) * l3ac::ceil_div(a.T, kS);
  const int grid = static_cast<int>(tiles < sms * per_sm ? tiles : sms * per_sm);
  narrow_bf16_kernel<kP><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int steps_for(int H) { return (H + kStep - 1) / kStep; }

}  // namespace

// x, out: (B, C, T) bf16, 1 <= C <= 96, out not aliasing x; pk: narrow_pack's
// buffer (16-byte aligned; the wrapper checks its size) for this unit, its K
// taps, with (norm) or without ChannelNorm, snake or (snake 0) exact GELU, and
// H hidden units (4C, or a tensor-parallel shard of them). part non-null: the
// tensor-parallel mode, the shard's fp32 sum without the residual into part
// (B, C, T), out unused. Returns the CUDA error code (invalid value for a
// shape it does not take).
extern "C" int l3ac_conv_unit_narrow_bf16(const void* x, void* out, const void* pk, int B, int C,
                                          int T, int K, int dil, int norm, int snake, int H,
                                          float* part, void* stream) {
  if (B < 1 || C < 1 || C > kMaxC || T < 1 || K < 1 || K % 2 == 0 || dil < 1 || H < 1 ||
      !aligned16(pk) || static_cast<long long>(B) * C * T >= (1LL << 40))
    return cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<const uint4*>(pk),
         B, C, T, K, dil, norm, snake, steps_for(H), (K - 1) * dil / 2, 0, 0, 0,
         aligned16(x) && (part != nullptr || aligned16(out)), part};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((C + 15) / 16) {
    case 1: return launch_at<1>(a, s);
    case 2: return launch_at<2>(a, s);
    case 3: return launch_at<3>(a, s);
    case 4: return launch_at<4>(a, s);
    case 5: return launch_at<5>(a, s);
    default: return launch_at<6>(a, s);
  }
}
