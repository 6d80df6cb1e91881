// Shared by every kernel library of the port: each source is built into
// its own shared library with a plain C interface (loaded with ctypes), so
// each exports the same error-string helper for its wrapper.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch-time status of the kernel just enqueued: a refused launch (bad
// configuration, too many resources) never runs, and a later synchronise
// would not report it.
inline int repro_launch_status() {
  return static_cast<int>(cudaGetLastError());
}
