// Error text for the C entry points of the other sources: each returns
// cudaGetLastError() as an int, and the Python side turns a non-zero code
// into a message with this function.

#include <cuda_runtime.h>

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
