// C entry points shared by every kernel wrapper.
#include <cuda_runtime.h>

extern "C" const char* l3ac_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
