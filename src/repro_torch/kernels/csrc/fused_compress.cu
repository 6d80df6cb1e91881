// Fused kernel-wise sparsification and probabilistic quantization (FGC in
// one pass: Eq. 2 then Eq. 3-4).
//
// Replaces: repro/kernels/fused_compress.py:fused_sparsify_quantize
// (pl.pallas_call at :62), which is threshold_apply (sparsify.py:70)
// followed by prob_quantize (quantize.py:39).
//
// Per element of a (K, C) float32 view x, with per-kernel norms (K,) and
// the scalars (thr, u_min, u_max, L) passed as kernel arguments:
//   keep = norms[k] >= thr;  v = x * keep;  av = |v|
//   step = max(u_max - u_min, 1e-20) / L
//   t = clip((av - u_min) / step, 0, L);  lo = floor(t)
//   lvl = clip(lo + (rand < t - lo), 0, L)
//   q = (u_min + lvl * step) * sign(v), and q = lvl = 0 where av == 0.
// Writes q (float32) and lvl (int32) in x's own layout.
//
// Bound on an H100 (3.35 TB/s): bytes.  16 B per element (read x and rand,
// write q and lvl; the norms are K floats): 26.6 MB for the fmnist-cnn
// update, about 7.9 us.
//
// Design: x must be dense, either kernel-fastest (strides (1, K): the main
// path's transposed view of a C-order leaf) or row-major (strides (C, 1)).
// One thread per storage offset, so every load and store is coalesced
// whatever the layout; the kernel id is offset % K or offset / C.  rand, q
// and lvl share x's layout.
// Exactness: built without --use_fast_math, so '/' is IEEE division and
// floorf is exact; the level index must equal the reference's bit for bit.
// -fmad=false is not used: v = x * keep and the Eq. 3-4 step (shared with
// quantize.cu through common.cuh) are written with __fmul_rn / __fadd_rn /
// __fsub_rn, which are never contracted into an FMA, so q rounds exactly
// as the unfused PyTorch version does.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
fused_kernel(const float* __restrict__ x, const float* __restrict__ rand,
             const float* __restrict__ norms, float* __restrict__ q,
             int32_t* __restrict__ lvl, uint32_t n, uint32_t K, uint32_t C,
             int kernel_fastest, float thr, float u_min, float u_max,
             float L) {
  const uint32_t o = blockIdx.x * THREADS + threadIdx.x;
  if (o >= n) return;
  const uint32_t k = kernel_fastest ? o % K : o / C;
  const float keep = norms[k] >= thr ? 1.0f : 0.0f;
  const float v = __fmul_rn(x[o], keep);
  float qv, level;
  repro_quantize_element(v, rand[o], u_min, repro_quant_step(u_min, u_max, L),
                         L, &qv, &level);
  const bool nz = fabsf(v) > 0.0f;
  q[o] = nz ? qv : 0.0f;
  lvl[o] = nz ? static_cast<int32_t>(level) : 0;
}

}  // namespace

extern "C" int fused_sparsify_quantize_f32(
    const float* x, const float* rand, const float* norms, float* q,
    int32_t* lvl, int64_t n, int64_t K, int64_t C, int kernel_fastest,
    float thr, float u_min, float u_max, float L, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  fused_kernel<<<grid, THREADS, 0, stream>>>(
      x, rand, norms, q, lvl, static_cast<uint32_t>(n),
      static_cast<uint32_t>(K), static_cast<uint32_t>(C), kernel_fastest,
      thr, u_min, u_max, L);
  return repro_launch_status();
}
