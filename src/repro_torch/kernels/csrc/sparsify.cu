// Kernel-wise sparsification (FGC Eq. 2): the per-kernel sums of squares
// and L2 norms, and the threshold step that zeroes the kernels below thr.
//
// Replaces: repro/kernels/sparsify.py:kernel_sumsq (pl.pallas_call at :47)
// and kernel_l2 (:58, sqrt of the former), as one kernel with an optional
// sqrt epilogue; and threshold_apply (:70, pl.pallas_call at :83), below.
//
// Input: a (K, C) float32 view with arbitrary element strides (sK, sC).
// The main path hands each leaf's C-order (C, K) buffer over as its
// transpose, strides (1, K), without a copy: neighbouring threads of a warp
// take neighbouring kernels and so read neighbouring addresses.
//
// Bound on an H100 (3.35 TB/s): bytes.  One read of the update (4 B per
// element, N = 1,663,370 for fmnist-cnn: 6.65 MB, about 2.0 us) plus K
// outputs; one FMA per element.
//
// Design: a block of ROWS x SLICES threads covers ROWS kernels; each of the
// SLICES threads of a kernel sums the columns c = slice, slice + SLICES, ...
// in order, and the SLICES partial sums are added in slice order by one
// thread.  No atomics and a fixed order: the norms are the same from run to
// run, so the order-statistic threshold taken from them is stable.  The
// TPU kernel carried the column sum across a sequential grid axis; here the
// loop inside the block takes that axis's place.
// Built without --use_fast_math, so sqrtf is IEEE round-to-nearest: the
// keep test norms >= thr compares these values exactly.
#include "common.cuh"

namespace {

constexpr int ROWS = 32;    // kernels per block (threadIdx.x)
constexpr int SLICES = 32;  // column slices per kernel (threadIdx.y)
constexpr int THREADS = 256;  // threshold_kernel: one thread per element

__global__ void __launch_bounds__(ROWS * SLICES)
sumsq_kernel(const float* __restrict__ x, float* __restrict__ out,
             int64_t K, int64_t C, int64_t sK, int64_t sC, int take_sqrt) {
  __shared__ float part[SLICES][ROWS + 1];
  const int64_t k = static_cast<int64_t>(blockIdx.x) * ROWS + threadIdx.x;
  float acc = 0.0f;
  if (k < K) {
    const float* row = x + k * sK;
#pragma unroll 4
    for (int64_t c = threadIdx.y; c < C; c += SLICES) {
      const float v = row[c * sC];
      acc += v * v;
    }
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && k < K) {
    float s = 0.0f;
    for (int j = 0; j < SLICES; ++j) s += part[j][threadIdx.x];
    out[k] = take_sqrt ? sqrtf(s) : s;
  }
}

// threshold_apply: out = x * (norms[k] >= thr) for a dense (K, C) view x,
// and keep[k] = (norms[k] >= thr) as float32 (K,).
//
// Bound on an H100 (3.35 TB/s): bytes.  8 B per element (read x, write
// out) plus 8 B per kernel (read norms, write keep): 13.3 MB for the
// fmnist-cnn update, about 4.0 us.
//
// Design: as fused_compress.cu, x is kernel-fastest (strides (1, K), the
// main path's transposed view of a C-order leaf) or row-major (strides
// (C, 1)); one thread per storage offset, the kernel id offset % K or
// offset / C, and out in x's own layout, so the leaves' outputs written
// into one flat buffer are the flat masked vector.  The first K threads
// also write keep, one element each.  x * keep is __fmul_rn, as the plain
// version's product rounds.
__global__ void __launch_bounds__(THREADS)
threshold_kernel(const float* __restrict__ x, const float* __restrict__ norms,
                 float* __restrict__ out, float* __restrict__ keep,
                 uint32_t n, uint32_t K, uint32_t C, int kernel_fastest,
                 float thr) {
  const uint32_t o = blockIdx.x * THREADS + threadIdx.x;
  if (o >= n) return;
  const uint32_t k = kernel_fastest ? o % K : o / C;
  out[o] = __fmul_rn(x[o], norms[k] >= thr ? 1.0f : 0.0f);
  if (o < K) keep[o] = norms[o] >= thr ? 1.0f : 0.0f;
}

}  // namespace

extern "C" int threshold_apply_f32(const float* x, const float* norms,
                                   float* out, float* keep, int64_t n,
                                   int64_t K, int64_t C, int kernel_fastest,
                                   float thr, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  threshold_kernel<<<grid, THREADS, 0, stream>>>(
      x, norms, out, keep, static_cast<uint32_t>(n),
      static_cast<uint32_t>(K), static_cast<uint32_t>(C), kernel_fastest,
      thr);
  return repro_launch_status();
}

extern "C" int kernel_sumsq_f32(const float* x, float* out, int64_t K,
                                int64_t C, int64_t sK, int64_t sC,
                                int take_sqrt, cudaStream_t stream) {
  const dim3 block(ROWS, SLICES);
  const dim3 grid(static_cast<unsigned>((K + ROWS - 1) / ROWS));
  sumsq_kernel<<<grid, block, 0, stream>>>(x, out, K, C, sK, sC, take_sqrt);
  return repro_launch_status();
}
