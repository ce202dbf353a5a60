// The small-range erf and GELU of csrc/common.cuh (erf_small, gelu_small)
// against the library's (erff, and gelu on erff) at every float of their
// range: the largest distance of erf_small in units in the last place of
// erff's value, and the largest absolute difference of the GELUs (an ulp
// count means nothing where a GELU is near 0). Built only by
// tools/first_block_variants.py --bf16.
#include <cstring>

#include "common.cuh"

namespace {

// distance in ulps of two finite floats, through the integers that order them
__device__ __forceinline__ unsigned ulps(float a, float b) {
  auto ord = [](float f) {
    const int i = __float_as_int(f);
    return i < 0 ? static_cast<long long>(static_cast<int>(0x80000000u) - i) : i;
  };
  const long long d = ord(a) - ord(b);
  return static_cast<unsigned>(d < 0 ? -d : d);
}

__global__ void erf_check_kernel(unsigned hi, unsigned* out) {
  unsigned m0 = 0, m1 = 0;
  for (unsigned u = blockIdx.x * blockDim.x + threadIdx.x; u <= hi; u += gridDim.x * blockDim.x)
    for (int neg = 0; neg < 2; ++neg) {
      const float x = __uint_as_float(u | (neg ? 0x80000000u : 0u));
      if (l3ac::erf_is_small(x)) m0 = max(m0, ulps(erff(x), l3ac::erf_small(x)));
      // gelu_small's range: x / sqrt 2 in erff's small range; a non-negative
      // float's bits order as the float does
      if (l3ac::erf_is_small(x * l3ac::kInvSqrt2))
        m1 = max(m1, __float_as_uint(fabsf(l3ac::gelu(x) - l3ac::gelu_small(x))));
    }
  atomicMax(out, m0);
  atomicMax(out + 1, m1);
}

}  // namespace

// out: two unsigned ints on the card, zeroed by the caller: the largest ulp
// distance of erf_small from erff, and the bits of the largest absolute
// difference of gelu_small from gelu, over the floats of [-bound, bound] in
// their range.
extern "C" int l3ac_erf_check(float bound, unsigned* out, void* stream) {
  unsigned hi = 0;
  std::memcpy(&hi, &bound, sizeof(hi));
  erf_check_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(hi, out);
  return cudaGetLastError();
}
