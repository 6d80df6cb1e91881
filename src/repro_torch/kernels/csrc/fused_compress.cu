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
// Input: the norm kernel's table of segments (sparsify.cu, the same host
// rows), laid end to end over storage offsets [0, n) from the base
// pointers, each a dense (K, C) view: kernel-fastest (sK = 1, element j of
// the segment is kernel j % K: a C-order leaf, the reference's "element i
// belongs to kernel i % k") or row-major (sK = C, kernel j / C).  Its K
// norms sit at norms[out_base ...].  The main path hands the whole flat
// update over in one launch, one segment per leaf, and gets the flat q and
// lvl back; a single view is a one-segment table.  x, rand, q and lvl share
// one storage layout, so element p of each sits at offset p.
//
// Bound on an H100 (3.35 TB/s): bytes.  16 B per element (read x and rand,
// write q and lvl) plus 4 B per kernel: 26.6 MB for the fmnist-cnn update
// (N = 1,663,370, K = 622), about 7.9 us.
//
// Design, for the H100: one launch per update, a flat grid-stride loop over
// storage offsets on a grid sized from the SM count, so the 10- to
// 512-element leaves share blocks with the rest instead of each costing a
// launch.  Leaf offsets are not 16-byte aligned (the fmnist-cnn leaves
// start at 0, 32, 832, 896, 52096, 52608, 1658240, 1658250), so a float4
// step can straddle two leaves: every lane finds its own segment, by a scan
// that only moves forward as the thread's offsets grow, and its own kernel
// id (the lane table and repro_kernel_of of common.cuh, which sparsify.cu's
// threshold step reads too).  When x, rand, q and lvl all start on 16-byte
// boundaries each thread moves float4s (int4 for lvl) and the first block
// does the n % 4 tail with scalar accesses; otherwise the scalar loop runs.
// Exactness: built without --use_fast_math, so '/' is IEEE division and
// floorf is exact; the level index must equal the reference's bit for bit.
// v = x * keep and the Eq. 3-4 step (shared with quantize.cu through
// common.cuh) are written with __fmul_rn / __fadd_rn / __fsub_rn, which
// are never contracted into an FMA, so q rounds exactly as the unfused
// PyTorch version does.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;   // 2048 threads: a full H100 SM

struct Scalars {
  float thr, u_min, u_max, L;
};

__device__ __forceinline__ void compress(float x, float r, float norm,
                                         const Scalars& c, float step,
                                         float& q, int32_t& lvl) {
  const float v = __fmul_rn(x, norm >= c.thr ? 1.0f : 0.0f);
  float qv, level;
  repro_quantize_element(v, r, c.u_min, step, c.L, &qv, &level);
  const bool nz = fabsf(v) > 0.0f;
  q = nz ? qv : 0.0f;
  lvl = nz ? static_cast<int32_t>(level) : 0;
}

__global__ void __launch_bounds__(THREADS)
fused_vec4_kernel(const float* __restrict__ x,
                  const float* __restrict__ rand,
                  const float* __restrict__ norms, float* __restrict__ q,
                  int32_t* __restrict__ lvl, uint32_t n, Scalars c,
                  const __grid_constant__ ReproLaneTable t) {
  const uint32_t n4 = n / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* r4 = reinterpret_cast<const float4*>(rand);
  float4* q4 = reinterpret_cast<float4*>(q);
  int4* l4 = reinterpret_cast<int4*>(lvl);
  const float step = repro_quant_step(c.u_min, c.u_max, c.L);
  int s = 0;
  for (uint32_t i = blockIdx.x * THREADS + threadIdx.x; i < n4;
       i += gridDim.x * THREADS) {
    const float4 xv = x4[i];
    const float4 rv = r4[i];
    const uint32_t p = 4 * i;
    float4 qv;
    int4 lv;
    compress(xv.x, rv.x, norms[repro_kernel_of(t, p, s)], c, step,
             qv.x, lv.x);
    compress(xv.y, rv.y, norms[repro_kernel_of(t, p + 1, s)], c, step,
             qv.y, lv.y);
    compress(xv.z, rv.z, norms[repro_kernel_of(t, p + 2, s)], c, step,
             qv.z, lv.z);
    compress(xv.w, rv.w, norms[repro_kernel_of(t, p + 3, s)], c, step,
             qv.w, lv.w);
    q4[i] = qv;
    l4[i] = lv;
  }
  const uint32_t p = 4 * n4 + threadIdx.x;
  if (blockIdx.x == 0 && p < n)
    compress(x[p], rand[p], norms[repro_kernel_of(t, p, s)], c, step,
             q[p], lvl[p]);
}

__global__ void __launch_bounds__(THREADS)
fused_scalar_kernel(const float* __restrict__ x,
                    const float* __restrict__ rand,
                    const float* __restrict__ norms, float* __restrict__ q,
                    int32_t* __restrict__ lvl, uint32_t n, Scalars c,
                    const __grid_constant__ ReproLaneTable t) {
  const float step = repro_quant_step(c.u_min, c.u_max, c.L);
  int s = 0;
  for (uint32_t p = blockIdx.x * THREADS + threadIdx.x; p < n;
       p += gridDim.x * THREADS)
    compress(x[p], rand[p], norms[repro_kernel_of(t, p, s)], c, step,
             q[p], lvl[p]);
}

}  // namespace

// x, rand: the inputs at storage offsets [0, n); q, lvl: the outputs, same
// offsets; norms: the table's k_total norms; rows: n_seg x
// REPRO_ROW_FIELDS int64 (common.cuh).  One launch on `stream`.
extern "C" int fused_sparsify_quantize_f32(
    const float* x, const float* rand, const float* norms, float* q,
    int32_t* lvl, const int64_t* rows, int n_seg, int64_t n, float thr,
    float u_min, float u_max, float L, cudaStream_t stream) {
  ReproLaneTable t;
  const int bad = repro_lane_table(rows, n_seg, n, &t);
  if (bad) return bad;
  const Scalars c{thr, u_min, u_max, L};
  const bool vec4 = repro_aligned16(x, rand, q, lvl);
  unsigned grid = 0;
  const cudaError_t err = repro_grid(vec4 ? n / 4 : n, THREADS,
                                     BLOCKS_PER_SM, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec4)
    fused_vec4_kernel<<<grid, THREADS, 0, stream>>>(
        x, rand, norms, q, lvl, static_cast<uint32_t>(n), c, t);
  else
    fused_scalar_kernel<<<grid, THREADS, 0, stream>>>(
        x, rand, norms, q, lvl, static_cast<uint32_t>(n), c, t);
  return repro_launch_status();
}
