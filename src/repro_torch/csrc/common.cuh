// Shared by the port's kernel libraries: each .cu file builds into its own
// shared library with a plain C interface, loaded with ctypes.
#pragma once

#include <cuda_runtime.h>

// The name of a CUDA error code that a launcher returned.
extern "C" const char* fedcd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
