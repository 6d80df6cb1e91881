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
// Design, for the H100: the main path (the beta planner) runs it once per
// (rho, L) over the masked update, with the mask broadcast from the keep
// vector of threshold_apply: 80 launches a fit, each worth about 10 us of
// bytes, so the wrapper takes the lean launch path (kernels/build.py) and
// the kernel the shape of fused_compress.cu's: a grid-stride loop on a grid
// sized from the SM count (8 blocks per SM).  When v, mask, rand, q and lvl
// all start on 16-byte boundaries each thread moves float4s (int4 for lvl)
// and the first block does the n % 4 tail with scalar accesses; otherwise
// the scalar loop runs.  The TPU kernel tiled the vector into (8, 128) VMEM
// blocks.  The element step is common.cuh's, so the level indices equal
// the plain version's bit for bit.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;   // 2048 threads: a full H100 SM

struct Scalars {
  float u_min, u_max, L;
};

__device__ __forceinline__ void quantize(float v, float m, float r,
                                         const Scalars& c, float step,
                                         float& q, int32_t& lvl) {
  float qv, level;
  repro_quantize_element(v, r, c.u_min, step, c.L, &qv, &level);
  const bool sent = m > 0.0f;
  q = sent ? qv : 0.0f;
  lvl = sent ? static_cast<int32_t>(level) : 0;
}

__global__ void __launch_bounds__(THREADS)
quantize_vec4_kernel(const float* __restrict__ v,
                     const float* __restrict__ mask,
                     const float* __restrict__ rand, float* __restrict__ q,
                     int32_t* __restrict__ lvl, uint32_t n, Scalars c) {
  const uint32_t n4 = n / 4;
  const float4* v4 = reinterpret_cast<const float4*>(v);
  const float4* m4 = reinterpret_cast<const float4*>(mask);
  const float4* r4 = reinterpret_cast<const float4*>(rand);
  float4* q4 = reinterpret_cast<float4*>(q);
  int4* l4 = reinterpret_cast<int4*>(lvl);
  const float step = repro_quant_step(c.u_min, c.u_max, c.L);
  for (uint32_t i = blockIdx.x * THREADS + threadIdx.x; i < n4;
       i += gridDim.x * THREADS) {
    const float4 vv = v4[i];
    const float4 mv = m4[i];
    const float4 rv = r4[i];
    float4 qv;
    int4 lv;
    quantize(vv.x, mv.x, rv.x, c, step, qv.x, lv.x);
    quantize(vv.y, mv.y, rv.y, c, step, qv.y, lv.y);
    quantize(vv.z, mv.z, rv.z, c, step, qv.z, lv.z);
    quantize(vv.w, mv.w, rv.w, c, step, qv.w, lv.w);
    q4[i] = qv;
    l4[i] = lv;
  }
  const uint32_t p = 4 * n4 + threadIdx.x;
  if (blockIdx.x == 0 && p < n)
    quantize(v[p], mask[p], rand[p], c, step, q[p], lvl[p]);
}

__global__ void __launch_bounds__(THREADS)
quantize_scalar_kernel(const float* __restrict__ v,
                       const float* __restrict__ mask,
                       const float* __restrict__ rand, float* __restrict__ q,
                       int32_t* __restrict__ lvl, uint32_t n, Scalars c) {
  const float step = repro_quant_step(c.u_min, c.u_max, c.L);
  for (uint32_t p = blockIdx.x * THREADS + threadIdx.x; p < n;
       p += gridDim.x * THREADS)
    quantize(v[p], mask[p], rand[p], c, step, q[p], lvl[p]);
}

}  // namespace

// v, mask, rand: the inputs, n floats each; q, lvl: the outputs.  One
// launch on `stream`.
extern "C" int prob_quantize_f32(const float* v, const float* mask,
                                 const float* rand, float* q, int32_t* lvl,
                                 int64_t n, float u_min, float u_max, float L,
                                 cudaStream_t stream) {
  if (n < 0 || n > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = repro_aligned16(v, mask, rand, q, lvl);
  unsigned grid = 0;
  const cudaError_t err = repro_grid(vec4 ? n / 4 : n, THREADS,
                                     BLOCKS_PER_SM, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Scalars c{u_min, u_max, L};
  if (vec4)
    quantize_vec4_kernel<<<grid, THREADS, 0, stream>>>(
        v, mask, rand, q, lvl, static_cast<uint32_t>(n), c);
  else
    quantize_scalar_kernel<<<grid, THREADS, 0, stream>>>(
        v, mask, rand, q, lvl, static_cast<uint32_t>(n), c);
  return repro_launch_status();
}
