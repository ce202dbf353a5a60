// Host entry points of the wgmma core (gemm_sm90.cuh) that belong to no one
// kernel: the weights' tensor maps, built once and kept with the prepared
// weights, and the host cost of encoding one map.
#include <chrono>

#include "gemm_sm90.cuh"

// The tensor map of a prepared weight w (N, K) for the port's configuration
// of its kind (int8: Int8Config, bf16: Bf16Config), into out (128 bytes,
// 64-byte aligned). Returns the CUDA error code (the weight must admit the
// TMA route: K % 8 == 0, int8 K % 16 == 0, 16-byte aligned).
extern "C" int l3ac_sm90_weight_map(const void* w, int int8, int N, int K, void* out) {
  namespace sm90 = l3ac::sm90;
  if (!sm90::aligned(out, 64)) return cudaErrorInvalidValue;
  CUtensorMap* m = static_cast<CUtensorMap*>(out);
  return int8 ? sm90::weight_map<sm90::Int8Config>(m, w, N, K)
              : sm90::weight_map<sm90::Bf16Config>(m, w, N, K);
}

// Seconds per encoding of a bf16 (rows, K) activation's map, the per-call
// host cost of the TMA route, over iters encodings; negative on an error.
extern "C" double l3ac_sm90_encode_seconds(const void* base, int rows, int K, int iters) {
  alignas(64) CUtensorMap m;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (l3ac::sm90::encode_map(&m, base, rows, K, l3ac::sm90::Bf16Config::kBM, false) != cudaSuccess)
      return -1.0;
  const std::chrono::duration<double> dt = std::chrono::steady_clock::now() - t0;
  return iters > 0 ? dt.count() / iters : 0.0;
}
