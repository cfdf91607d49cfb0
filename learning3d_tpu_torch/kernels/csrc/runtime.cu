// Helpers the Python side binds beside the kernels.

#include <cuda_runtime.h>

// The message for a CUDA error code that a kernel entry returned.
extern "C" const char* l3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
