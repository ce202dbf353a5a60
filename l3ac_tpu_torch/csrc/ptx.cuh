// The PTX the tensor-core kernels (tc_gemm.cuh, conv_unit_narrow.cu,
// conv_unit_stages.cu) are built from, one small device function each:
// asynchronous copies into shared memory, ldmatrix, the TF32 and bf16 mma,
// and the TF32 and bf16 roundings. Kept apart so that a host twin of exactly
// these functions can stand in for them when the kernels are rehearsed
// without a card (.claude/skills/verify/SKILL.md).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace l3ac::ptx {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; the bytes from src_bytes (0 or 16) on are zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared; zero when src_bytes is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 b16 matrices, i.e. four 8-row x 4-word tiles (fp32, or bf16
// pairs): lanes 8q..8q+7 give the row addresses of tile q; lane l receives
// word l % 4 of row l / 4 of tile q in r[q].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += A (16 x 8, row) * B (8 x 8, col), TF32 operands, fp32 sums. Lane l,
// g = l / 4, t = l % 4: a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]},
// b = {B[t][g], B[t+4][g]}, d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A (16 x 16, row) * B (16 x 8, col), bf16 operands, fp32 sums. Lane l,
// g = l / 4, t = l % 4, each register two bf16 (lower k in the low half):
// a = {A[g][2t..2t+1], A[g+8][2t..], A[g][2t+8..2t+9], A[g+8][2t+8..]},
// b = {B[2t..2t+1][g], B[2t+8..2t+9][g]}, d as for mma_tf32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two fp32 -> a bf16 pair, round to nearest even; lo in the low half
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// fp32 -> TF32, round to nearest with ties away from zero, as the bits of an
// fp32 whose 13 low mantissa bits are zero: the rounding of cvt.rna.tf32.f32
// for every finite x, done as two integer operations (add half an ulp to the
// magnitude bits, clear the 13 low bits).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

}  // namespace l3ac::ptx
