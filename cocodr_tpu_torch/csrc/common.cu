// C entry points shared by all kernels of the library.
#include <cuda_runtime.h>

// Text of a cudaError_t returned by any cocodr_* entry point.
extern "C" const char* cocodr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
