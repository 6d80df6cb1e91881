// Shared by every kernel library of the port: each source is built into
// its own shared library with a plain C interface (loaded with ctypes), so
// each exports the same error-string helper for its wrapper.  The Eq. 3-4
// element step lives here too, so that every kernel that quantizes rounds
// alike.
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

// Blocks for a grid-stride loop over `work` items, `threads` a block: as
// many as the work needs, at most `blocks_per_sm` on each SM of the current
// device (its SM count read once per device and cached), at least one.
// Returns the CUDA error of the query.
inline cudaError_t repro_grid(int64_t work, int threads, int blocks_per_sm,
                              unsigned* grid) {
  constexpr int kMaxDevices = 64;
  static int sms[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms[dev] = count;
  }
  const int64_t cap = static_cast<int64_t>(sms[dev]) * blocks_per_sm;
  const int64_t want = (work + threads - 1) / threads;
  *grid = static_cast<unsigned>(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

// True when every pointer starts on a 16-byte boundary (float4 access).
template <class... P>
inline bool repro_aligned16(const P*... p) {
  return ((reinterpret_cast<uintptr_t>(p) | ...) & 15) == 0;
}

// Eq. 3-4's grid step: max(u_max - u_min, 1e-20) / L, IEEE division.
__device__ __forceinline__ float repro_quant_step(float u_min, float u_max,
                                                  float L) {
  return fmaxf(__fsub_rn(u_max, u_min), 1e-20f) / L;
}

// Eq. 3-4 for one element v with its uniform r:
//   t = clip((|v| - u_min) / step, 0, L);  lo = floor(t)
//   level = clip(lo + (r < t - lo), 0, L)
//   q = (u_min + level * step) * sign(v)
// The caller zeroes q and the level where the element is not sent.  The
// products and sums are __fmul_rn / __fadd_rn / __fsub_rn, never
// contracted into an FMA, and '/' and floorf are exact without
// --use_fast_math, so the level equals the plain version's bit for bit.
__device__ __forceinline__ void repro_quantize_element(
    float v, float r, float u_min, float step, float L, float* q,
    float* level) {
  const float av = fabsf(v);
  const float t = fminf(fmaxf(__fsub_rn(av, u_min) / step, 0.0f), L);
  const float lo = floorf(t);
  const float up = r < __fsub_rn(t, lo) ? 1.0f : 0.0f;
  const float lvl = fminf(fmaxf(__fadd_rn(lo, up), 0.0f), L);
  const float sgn = v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
  *q = __fmul_rn(__fadd_rn(u_min, __fmul_rn(lvl, step)), sgn);
  *level = lvl;
}
