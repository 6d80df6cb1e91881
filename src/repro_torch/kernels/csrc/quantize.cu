// Probabilistic quantization (FGC Eq. 3-4) over a flat vector.
//
// Replaces: repro/kernels/quantize.py:prob_quantize (pl.pallas_call at :55).
//
// Per element of flat float32 v, mask and rand (N,), with the scalars
// (u_min, u_max, L) passed as kernel arguments: the Eq. 3-4 element step
// of common.cuh (the one fused_compress.cu runs too), then
//   q = lvl = 0 where mask == 0.
// Writes q (float32) and the level index lvl (int32), both (N,).
//
// Bound on an H100 (3.35 TB/s): bytes.  20 B per element (read v, mask and
// rand, write q and lvl): 33.3 MB for the fmnist-cnn update
// (N = 1,663,370), about 9.9 us.
//
// Design: one thread per element; every load and store is coalesced.  The
// TPU kernel tiled the vector into (8, 128) VMEM blocks; here the grid is
// simply ceil(N / 256) blocks.  The main path (the beta planner) runs it
// once per (rho, L) over the masked update, with the mask broadcast from
// the keep vector of threshold_apply.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
quantize_kernel(const float* __restrict__ v, const float* __restrict__ mask,
                const float* __restrict__ rand, float* __restrict__ q,
                int32_t* __restrict__ lvl, uint32_t n, float u_min,
                float u_max, float L) {
  const uint32_t o = blockIdx.x * THREADS + threadIdx.x;
  if (o >= n) return;
  float qv, level;
  repro_quantize_element(v[o], rand[o], u_min,
                         repro_quant_step(u_min, u_max, L), L, &qv, &level);
  const bool sent = mask[o] > 0.0f;
  q[o] = sent ? qv : 0.0f;
  lvl[o] = sent ? static_cast<int32_t>(level) : 0;
}

}  // namespace

extern "C" int prob_quantize_f32(const float* v, const float* mask,
                                 const float* rand, float* q, int32_t* lvl,
                                 int64_t n, float u_min, float u_max, float L,
                                 cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  quantize_kernel<<<grid, THREADS, 0, stream>>>(
      v, mask, rand, q, lvl, static_cast<uint32_t>(n), u_min, u_max, L);
  return repro_launch_status();
}
