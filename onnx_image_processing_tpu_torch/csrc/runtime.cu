// Error text for the kernels' C entry points. Holds no kernel: each entry
// point returns cudaGetLastError() as an int, and the Python wrappers turn a
// non-zero value into an exception with this text.

#include <cuda_runtime.h>

extern "C" const char* oip_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
