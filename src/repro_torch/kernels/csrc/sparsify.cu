// Kernel-wise sums of squares and L2 norms (FGC Eq. 2's norms).
//
// Replaces: repro/kernels/sparsify.py:kernel_sumsq (pl.pallas_call at :47)
// and kernel_l2 (:58, sqrt of the former), as one kernel with an optional
// sqrt epilogue.
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

}  // namespace

extern "C" int kernel_sumsq_f32(const float* x, float* out, int64_t K,
                                int64_t C, int64_t sK, int64_t sC,
                                int take_sqrt, cudaStream_t stream) {
  const dim3 block(ROWS, SLICES);
  const dim3 grid(static_cast<unsigned>((K + ROWS - 1) / ROWS));
  sumsq_kernel<<<grid, block, 0, stream>>>(x, out, K, C, sK, sC, take_sqrt);
  return repro_launch_status();
}
