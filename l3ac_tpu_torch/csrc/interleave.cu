// s-fold interleaved store of bf16 data: out[n, p, l] = x[n, l] for p < s.
//
// Replaces the TPU probe tools/test_interleave.py (pallas_calls :79 and :102;
// bodies kA :69, kB :74, kC :92, kD :96). x is viewed as (N, L) and out as
// (N, s, L):
//   (B, C, T), the probe's lane layout:    N = B C T, L = 1,
//     out[b, c, t s + p] = x[b, c, t]
//   (B, T, C), the probe's sublane layout: N = B T, L = C,
//     out[b, t s + p, c] = x[b, t, c]
// A pure copy of 16-bit words, so the output is bit-equal to the plain version.
// Every input element is covered: the probe's grid covers T // 3840 tiles of
// T = 79920 and leaves its last 6240 output columns unwritten; this kernel
// has no tile remainder.
//
// Bound on the H100: bytes, 2 N L (1 + s) moved and no arithmetic. Two store
// strategies, the Hopper counterparts of the probe's two:
//   strided (A, D): one thread per input element and s separate 2-byte stores
//     at stride L. Each warp store writes one phase: a strided pattern whose
//     holes the other phases' stores fill.
//   packed (B, C): one thread per vector of V words of the output, built in
//     registers and written with one store; consecutive threads write
//     consecutive vectors, so each warp store is one contiguous run. With
//     L = 1 the vector is the s copies of one element (V = gcd(s, 8): for
//     s = 2 one 32-bit store of two equal halves); with L > 1 it is V =
//     gcd(L, 8) channels of one copy of one row (16 bytes at C = 24).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride beyond 16 blocks per SM

template <int V> struct Words;
template <> struct Words<1> { using T = unsigned short; };
template <> struct Words<2> { using T = unsigned int; };
template <> struct Words<4> { using T = uint2; };
template <> struct Words<8> { using T = uint4; };

__global__ void __launch_bounds__(kThreads)
interleave_strided(const unsigned short* __restrict__ x, unsigned short* __restrict__ out,
                   long long n_in, int L, int s) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; e < n_in;
       e += step) {
    const long long n = e / L, l = e - n * L;
    const unsigned short v = x[e];
    unsigned short* o = out + n * s * L + l;
    for (int p = 0; p < s; ++p) o[static_cast<long long>(p) * L] = v;
  }
}

// V divides s (L = 1) or L (L > 1), so a vector never straddles two input rows.
template <int V>
__global__ void __launch_bounds__(kThreads)
interleave_packed(const unsigned short* __restrict__ x, unsigned short* __restrict__ out,
                  long long n_vec, int L, int s) {
  using T = typename Words<V>::T;
  union {
    T v;
    unsigned short w[V];
  } pk;
  const long long row = static_cast<long long>(s) * L;  // output words per input row
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; k < n_vec;
       k += step) {
    const long long o = k * V;
    const long long n = o / row;
    if (L == 1) {
      const unsigned short v = x[n];
#pragma unroll
      for (int j = 0; j < V; ++j) pk.w[j] = v;
    } else {
      pk.v = *reinterpret_cast<const T*>(x + n * L + o % L);
    }
    reinterpret_cast<T*>(out)[k] = pk.v;
  }
}

int blocks_for(long long items) {
  const int b = l3ac::ceil_div(items, kThreads);
  return b < kMaxBlocks ? b : kMaxBlocks;
}

int largest_pow2_divisor(long long v, int cap) {
  int d = cap;
  while (v % d != 0) d /= 2;
  return d;
}

template <int V>
cudaError_t launch_packed(const unsigned short* x, unsigned short* out, long long N, int L,
                          int s, cudaStream_t stream) {
  const long long n_vec = N * s * L / V;
  interleave_packed<V><<<blocks_for(n_vec), kThreads, 0, stream>>>(x, out, n_vec, L, s);
  return cudaGetLastError();
}

}  // namespace

// x: N L bf16 words, out: N s L, both contiguous and 16-byte aligned, out
// not aliasing x; packed selects the store strategy. Returns the CUDA error
// code.
extern "C" int l3ac_interleave(const void* x, void* out, long long N, int L, int s,
                               int packed, void* stream) {
  if (N < 1 || L < 1 || s < 1) return cudaErrorInvalidValue;
  const auto* xw = static_cast<const unsigned short*>(x);
  auto* ow = static_cast<unsigned short*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!packed) {
    interleave_strided<<<blocks_for(N * L), kThreads, 0, st>>>(xw, ow, N * L, L, s);
    return cudaGetLastError();
  }
  switch (largest_pow2_divisor(L == 1 ? s : L, 8)) {
    case 1: return launch_packed<1>(xw, ow, N, L, s, st);
    case 2: return launch_packed<2>(xw, ow, N, L, s, st);
    case 4: return launch_packed<4>(xw, ow, N, L, s, st);
    default: return launch_packed<8>(xw, ow, N, L, s, st);
  }
}
