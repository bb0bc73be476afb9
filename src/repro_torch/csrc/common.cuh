// Shared by every kernel library of repro_torch. Each .cu file builds into a
// shared library of its own with a plain C interface, loaded with ctypes
// (repro_torch/kernels/_build.py). A launch function returns
// cudaGetLastError() right after the launch, so a launch the driver refused
// (too many threads, too much shared memory) reaches the Python wrapper as a
// non-zero code instead of vanishing.
#pragma once
#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
