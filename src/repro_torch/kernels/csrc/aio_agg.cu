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
//   absorb: num[j] += (w m[j]) u[j];  den[j] += w m[j]
//   merge:  num_a[j] += num_b[j];     den_a[j] += den_b[j]
//
// Replaces: repro/kernels/aio_agg.py:aio_absorb (pl.pallas_call at :108)
// and aio_merge (:143).  The TPU kernels alias their outputs onto the
// accumulator operands ({1: 0, 2: 1} and {0: 0, 1: 1}) and are donated;
// here the accumulator is read and written through one pointer per plane,
// never declared __restrict__, and nothing is allocated.
//
// Bound on an H100 (3.35 TB/s): bytes.  Each reads four planes and writes
// two: 24 B per element, 39.9 MB for the fmnist-cnn update
// (N = 1,663,370), about 11.9 us.
//
// Design, for the H100: one launch through the wrapper costs the host
// about as much as these bytes cost the device, so the device side stays at
// the byte rate and the wrappers take the lean launch path
// (kernels/build.py).  Both are one template over the element step: a
// grid-stride loop over a grid sized from the SM count, so a launch costs
// the same few thousand threads whatever N is.  When all four planes are
// 16-byte aligned each thread moves float4s, one 16-byte load or store per
// plane per step, and the first block does the N % 4 tail with scalar
// accesses; a plane that starts off a 16-byte boundary takes the scalar
// loop.  Absorb rounds wm = w * m first, then num + wm * u, with
// __fmul_rn / __fadd_rn (no FMA contraction), as the plain version
// computes it; merge is one __fadd_rn a plane.  Both agree with the plain
// versions bit for bit.  w arrives by value as a float32, the reference's
// jnp.float32(weight).
constexpr int STREAM_THREADS = 256;
constexpr int STREAM_BLOCKS_PER_SM = 8;   // 2048 threads: a full H100 SM

struct Absorb {
  float w;
  __device__ __forceinline__ void operator()(float& num, float& den, float u,
                                             float m) const {
    const float wm = __fmul_rn(w, m);
    num = __fadd_rn(num, __fmul_rn(wm, u));
    den = __fadd_rn(den, wm);
  }
};

struct Merge {
  __device__ __forceinline__ void operator()(float& num_a, float& den_a,
                                             float num_b, float den_b) const {
    num_a = __fadd_rn(num_a, num_b);
    den_a = __fadd_rn(den_a, den_b);
  }
};

// a0, a1: the accumulator planes, updated in place; b0, b1: read only.
template <class Op>
__global__ void __launch_bounds__(STREAM_THREADS)
stream_vec4_kernel(float* a0, float* a1, const float* b0, const float* b1,
                   int64_t N, Op op) {
  const int64_t n4 = N / 4;
  float4* a0v = reinterpret_cast<float4*>(a0);
  float4* a1v = reinterpret_cast<float4*>(a1);
  const float4* b0v = reinterpret_cast<const float4*>(b0);
  const float4* b1v = reinterpret_cast<const float4*>(b1);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * STREAM_THREADS;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * STREAM_THREADS +
                   threadIdx.x;
       i < n4; i += stride) {
    float4 x = a0v[i];
    float4 y = a1v[i];
    const float4 u = b0v[i];
    const float4 v = b1v[i];
    op(x.x, y.x, u.x, v.x);
    op(x.y, y.y, u.y, v.y);
    op(x.z, y.z, u.z, v.z);
    op(x.w, y.w, u.w, v.w);
    a0v[i] = x;
    a1v[i] = y;
  }
  const int64_t j = 4 * n4 + threadIdx.x;
  if (blockIdx.x == 0 && j < N) op(a0[j], a1[j], b0[j], b1[j]);
}

template <class Op>
__global__ void __launch_bounds__(STREAM_THREADS)
stream_scalar_kernel(float* a0, float* a1, const float* b0, const float* b1,
                     int64_t N, Op op) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * STREAM_THREADS;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * STREAM_THREADS +
                   threadIdx.x;
       j < N; j += stride)
    op(a0[j], a1[j], b0[j], b1[j]);
}

template <class Op>
int launch_stream(float* a0, float* a1, const float* b0, const float* b1,
                  int64_t N, Op op, cudaStream_t stream) {
  const bool vec4 = repro_aligned16(a0, a1, b0, b1);
  unsigned grid = 0;
  const cudaError_t err = repro_grid(vec4 ? N / 4 : N, STREAM_THREADS,
                                     STREAM_BLOCKS_PER_SM, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec4)
    stream_vec4_kernel<<<grid, STREAM_THREADS, 0, stream>>>(a0, a1, b0, b1,
                                                            N, op);
  else
    stream_scalar_kernel<<<grid, STREAM_THREADS, 0, stream>>>(a0, a1, b0, b1,
                                                              N, op);
  return repro_launch_status();
}

}  // namespace

extern "C" int aio_absorb_f32(float* num, float* den, const float* u,
                              const float* m, float w, int64_t N,
                              cudaStream_t stream) {
  return launch_stream(num, den, u, m, N, Absorb{w}, stream);
}

extern "C" int aio_merge_f32(float* num_a, float* den_a, const float* num_b,
                             const float* den_b, int64_t N,
                             cudaStream_t stream) {
  return launch_stream(num_a, den_a, num_b, den_b, N, Merge{}, stream);
}
