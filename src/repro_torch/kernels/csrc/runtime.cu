// Error text for the CUDA error codes the kernels' C functions return.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
