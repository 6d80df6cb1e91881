// AIO aggregation (paper Eq. 5), batched and streaming.
//
// Batched:
//   out[j] = sum_i w_i m_ij u_ij / sum_i w_i m_ij   where the sum is > 0,
//   else 0.
//
// Replaces: repro/kernels/aio_agg.py:aio_aggregate (pl.pallas_call at :62).
//
// Inputs: u, m (I, N) float32 row-major, w (I,) float32; output (N,).
//
// Bound on an H100 (3.35 TB/s): bytes.  (2 I + 1) * 4 B * N: for 12
// devices and the fmnist-cnn update (N = 1,663,370), 166 MB, about 50 us.
//
// Design: one thread per column j.  It walks the I devices in order and
// carries num and den in registers, so each element of u and m is read
// once, coalesced across the warp, and nothing but the output is written.
// The TPU kernel held the whole device axis in one VMEM tile; here it is a
// loop in registers.  The products and sums use __fmul_rn / __fadd_rn (no
// FMA contraction) and '/' is IEEE division (no --use_fast_math), in the
// same order as the port's plain version, which loops over devices too:
// the two agree bit for bit.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
aio_kernel(const float* __restrict__ u, const float* __restrict__ m,
           const float* __restrict__ w, float* __restrict__ out, int I,
           int64_t N) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (j >= N) return;
  float num = 0.0f;
  float den = 0.0f;
  for (int i = 0; i < I; ++i) {
    const int64_t at = static_cast<int64_t>(i) * N + j;
    const float wm = __fmul_rn(w[i], m[at]);
    num = __fadd_rn(num, __fmul_rn(wm, u[at]));
    den = __fadd_rn(den, wm);
  }
  out[j] = den > 0.0f ? num / fmaxf(den, 1e-12f) : 0.0f;
}

}  // namespace

extern "C" int aio_aggregate_f32(const float* u, const float* m,
                                 const float* w, float* out, int64_t I,
                                 int64_t N, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((N + THREADS - 1) / THREADS);
  aio_kernel<<<grid, THREADS, 0, stream>>>(u, m, w, out,
                                           static_cast<int>(I), N);
  return repro_launch_status();
}

namespace {

// Streaming (the PartialAgg monoid of core/aggregation.py), in place:
//   absorb: num[j] += w m[j] u[j];  den[j] += w m[j]
//   merge:  num_a[j] += num_b[j];   den_a[j] += den_b[j]
//
// Replaces: repro/kernels/aio_agg.py:aio_absorb (pl.pallas_call at :108)
// and aio_merge (:143).  The TPU kernels alias their outputs onto the
// accumulator operands ({1: 0, 2: 1} and {0: 0, 1: 1}) and are donated;
// here the accumulator is read and written through one pointer per plane,
// never declared __restrict__, and nothing is allocated.
//
// Bound on an H100 (3.35 TB/s): bytes.  Absorb reads num, den, u, m and
// writes num, den; merge reads four planes and writes two: 24 B per
// element each, 39.9 MB for the fmnist-cnn update (N = 1,663,370), about
// 11.9 us.
//
// Design (absorb): one thread per element, coalesced.  wm = w * m is
// rounded first, then num + wm * u, with __fmul_rn / __fadd_rn (no FMA
// contraction), as the plain version computes it: the two agree bit for
// bit.  w arrives by value as a float32, the reference's
// jnp.float32(weight).  merge has its own design, below.
__global__ void __launch_bounds__(THREADS)
absorb_kernel(float* num, float* den, const float* __restrict__ u,
              const float* __restrict__ m, float w, int64_t N) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (j >= N) return;
  const float wm = __fmul_rn(w, m[j]);
  num[j] = __fadd_rn(num[j], __fmul_rn(wm, u[j]));
  den[j] = __fadd_rn(den[j], wm);
}

// merge, redesigned for the H100.  Its 24 B per element are about 12 us at
// the HBM rate, while one launch through a wrapper costs the host more than
// that: the design keeps the device side at the byte rate and leaves the
// rest to the wrapper's lean launch path (kernels/build.py).
//
// Design: a grid-stride loop over a grid sized from the SM count (read once
// per device and cached), so a launch costs the same few thousand threads
// whatever N is.  When all four planes are 16-byte aligned, each thread
// moves float4s, one 16-byte load or store per plane per step, and the
// first block adds the N % 4 tail with scalar accesses; a misaligned view
// (a plane that starts off a 16-byte boundary) takes the scalar loop.  Both
// loops are the kernel.  Each element is one __fadd_rn, so the result is
// the plain version's bit for bit.  The a-side pointers are read and
// written in place and are not __restrict__.
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_BLOCKS_PER_SM = 8;   // 2048 threads: a full H100 SM
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__global__ void __launch_bounds__(MERGE_THREADS)
merge_vec4_kernel(float* num_a, float* den_a, const float* num_b,
                  const float* den_b, int64_t N) {
  const int64_t n4 = N / 4;
  float4* na = reinterpret_cast<float4*>(num_a);
  float4* da = reinterpret_cast<float4*>(den_a);
  const float4* nb = reinterpret_cast<const float4*>(num_b);
  const float4* db = reinterpret_cast<const float4*>(den_b);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * MERGE_THREADS;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * MERGE_THREADS +
                   threadIdx.x;
       i < n4; i += stride) {
    na[i] = add4(na[i], nb[i]);
    da[i] = add4(da[i], db[i]);
  }
  const int64_t j = 4 * n4 + threadIdx.x;
  if (blockIdx.x == 0 && j < N) {
    num_a[j] = __fadd_rn(num_a[j], num_b[j]);
    den_a[j] = __fadd_rn(den_a[j], den_b[j]);
  }
}

__global__ void __launch_bounds__(MERGE_THREADS)
merge_scalar_kernel(float* num_a, float* den_a, const float* num_b,
                    const float* den_b, int64_t N) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * MERGE_THREADS;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * MERGE_THREADS +
                   threadIdx.x;
       j < N; j += stride) {
    num_a[j] = __fadd_rn(num_a[j], num_b[j]);
    den_a[j] = __fadd_rn(den_a[j], den_b[j]);
  }
}

// Blocks that fill every SM of the current device once, read once per
// device and cached; returns the CUDA error of the query.
cudaError_t merge_grid_cap(int* cap) {
  static int cached[MAX_DEVICES] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cached[dev] = sms * MERGE_BLOCKS_PER_SM;
  }
  *cap = cached[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" int aio_absorb_f32(float* num, float* den, const float* u,
                              const float* m, float w, int64_t N,
                              cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((N + THREADS - 1) / THREADS);
  absorb_kernel<<<grid, THREADS, 0, stream>>>(num, den, u, m, w, N);
  return repro_launch_status();
}

extern "C" int aio_merge_f32(float* num_a, float* den_a, const float* num_b,
                             const float* den_b, int64_t N,
                             cudaStream_t stream) {
  int cap = 0;
  const cudaError_t err = merge_grid_cap(&cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec4 = ((reinterpret_cast<uintptr_t>(num_a) |
                      reinterpret_cast<uintptr_t>(den_a) |
                      reinterpret_cast<uintptr_t>(num_b) |
                      reinterpret_cast<uintptr_t>(den_b)) & 15) == 0;
  const int64_t work = vec4 ? N / 4 : N;
  const int64_t want = (work + MERGE_THREADS - 1) / MERGE_THREADS;
  const unsigned grid = static_cast<unsigned>(
      want < 1 ? 1 : (want < cap ? want : cap));
  if (vec4)
    merge_vec4_kernel<<<grid, MERGE_THREADS, 0, stream>>>(num_a, den_a, num_b,
                                                          den_b, N);
  else
    merge_scalar_kernel<<<grid, MERGE_THREADS, 0, stream>>>(
        num_a, den_a, num_b, den_b, N);
  return repro_launch_status();
}
