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

// The norm kernel's table of segments (sparsify.SegmentTable) as the
// element-wise kernels read it.  The host rows hold REPRO_ROW_FIELDS int64
// each: offset, K, C, sK, sC, out_base, tile_base, part_base, ktiles.  A
// segment is a dense (K, C) view over storage offsets [offset, offset + K*C)
// from the base pointers: kernel-fastest (sK = 1, element j of the segment
// is kernel j % K: a C-order leaf read as its transpose) or row-major
// (sK = C, kernel j / C).  Its K norms sit at norms[out_base ...].  The
// table rides into a kernel by value, as a __grid_constant__ parameter.
constexpr int REPRO_MAX_SEGMENTS = 64;
constexpr int REPRO_ROW_FIELDS = 9;

struct ReproLaneSegment {
  uint32_t offset;    // first storage offset
  uint32_t div;       // kernel j % div (rem) or j / div, j = p - offset
  uint32_t rem;
  uint32_t out_base;  // first norm
};

struct ReproLaneTable {
  ReproLaneSegment seg[REPRO_MAX_SEGMENTS];
  int32_t n;
};

// Fills `t` from `n_seg` host rows over n storage offsets; returns
// cudaErrorInvalidValue past the table's cap or the kernels' 32-bit
// offsets, else 0.
inline int repro_lane_table(const int64_t* rows, int n_seg, int64_t n,
                            ReproLaneTable* t) {
  if (n_seg < 1 || n_seg > REPRO_MAX_SEGMENTS || n < 0 || n > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  t->n = n_seg;
  for (int i = 0; i < n_seg; ++i) {
    const int64_t* r = rows + static_cast<int64_t>(i) * REPRO_ROW_FIELDS;
    const int64_t K = r[1], sK = r[3];
    ReproLaneSegment& g = t->seg[i];
    g.offset = static_cast<uint32_t>(r[0]);
    g.rem = sK == 1;
    const int64_t div = g.rem ? K : sK;
    g.div = static_cast<uint32_t>(div < 1 ? 1 : div);   // empty segments
    g.out_base = static_cast<uint32_t>(r[5]);
  }
  return 0;
}

// The norm index of storage offset p; s is the thread's segment, which
// only moves forward as its offsets grow (empty segments share the next
// one's offset and are passed over).  Leaf offsets need not be 16-byte
// aligned, so each lane of a float4 step looks its own kernel up.
__device__ __forceinline__ uint32_t repro_kernel_of(const ReproLaneTable& t,
                                                    uint32_t p, int& s) {
  while (s + 1 < t.n && p >= t.seg[s + 1].offset) ++s;
  const ReproLaneSegment& g = t.seg[s];
  const uint32_t j = p - g.offset;
  return g.out_base + (g.rem ? j % g.div : j / g.div);
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
