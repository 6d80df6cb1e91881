// Kernel-wise sparsification (FGC Eq. 2): the per-kernel sums of squares
// and L2 norms, and the threshold step that zeroes the kernels below thr.
//
// Replaces: repro/kernels/sparsify.py:kernel_sumsq (pl.pallas_call at :47)
// and kernel_l2 (:58, sqrt of the former), as one kernel with an optional
// sqrt epilogue; and threshold_apply (:70, pl.pallas_call at :83), below,
// over the same table.
//
// Norms, redesigned for the H100.  Input: a table of segments over one base
// pointer, each a (K, C) float32 view with element strides (sK, sC) whose
// element (k, c) sits at offset + k*sK + c*sC, and whose K results go to
// out[out_base + k].  The main path hands the whole flat update over as one
// table, one segment per leaf: a C-order leaf (..., K) is its transposed
// view, strides (1, K), so element (k, c) sits at offset + c*K + k; a 1-D
// leaf is one kernel, K = 1.  A single (K, C) view with any strides is a
// one-segment table.  The table rides into the kernels by value, as a
// __grid_constant__ parameter copied from a host array inside the C entry:
// no device tensor and no host-to-device copy per call.
//
// Bound on an H100 (3.35 TB/s): bytes.  One read of the update (4 B per
// element, N = 1,663,370 for fmnist-cnn: 6.65 MB, about 2.0 us) plus K
// outputs; one FMA per element.
//
// Design: the work items are tiles of ROWS neighbouring kernels x CHUNK
// columns over all segments, one block each, so the (3136, 512) dense leaf
// alone, 96 % of the update, spans 16 x 13 = 208 blocks on the 132 SMs (one
// launch per leaf over K / 32 blocks gave it 16).  In a tile, the ROWS
// threads of a warp take neighbouring kernels and so read neighbouring
// addresses; the SLICES threads of a kernel sum the tile's columns
// c0 + slice, c0 + slice + SLICES, ... in order, and one thread adds the
// SLICES partial sums in slice order and writes the tile's partial sum to a
// scratch buffer.  A second launch from the same C entry adds each kernel's
// partial sums in chunk order and applies the optional sqrt.  No atomics
// and a fixed order: two calls on the same input give bitwise-equal norms,
// so the order-statistic threshold taken from them is stable.  The TPU
// kernel carried the column sum across a sequential grid axis; here the
// chunk loop of the second pass takes that axis's place.
// Built without --use_fast_math, so sqrtf is IEEE round-to-nearest: the
// keep test norms >= thr compares these values exactly.
#include "common.cuh"

namespace {

constexpr int ROWS = 32;      // kernels per tile (threadIdx.x)
constexpr int SLICES = 8;     // threads per kernel in a tile (threadIdx.y)
constexpr int CHUNK = 256;    // columns per tile
constexpr int COMBINE = 256;  // combine_kernel: one thread per kernel
constexpr int THREADS = 256;  // threshold kernels: grid-stride loops
constexpr int BLOCKS_PER_SM = 8;
// The host table's rows (common.cuh): REPRO_ROW_FIELDS int64 each, in this
// order: offset, K, C, sK, sC, out_base, tile_base, part_base, ktiles

struct Segment {
  int64_t offset;     // element offset of (0, 0) from the base pointer
  int64_t sK, sC;     // element strides
  int64_t part_base;  // first partial sum in the scratch buffer
  int32_t K, C;
  int32_t out_base;   // first output
  int32_t tile_base;  // first tile (block) of the tiles pass
  int32_t ktiles;     // tiles along K: ceil(K / ROWS)
  int32_t pad;
};

struct Table {
  Segment seg[REPRO_MAX_SEGMENTS];
  int32_t n;
};

// The last segment whose first index (by field) is <= i.  Segments with no
// tiles or no kernels share their first index with the next one and are
// passed over.
__device__ __forceinline__ int tile_segment(const Table& t, int64_t i) {
  int s = 0;
  while (s + 1 < t.n && i >= t.seg[s + 1].tile_base) ++s;
  return s;
}

__device__ __forceinline__ int out_segment(const Table& t, int64_t i) {
  int s = 0;
  while (s + 1 < t.n && i >= t.seg[s + 1].out_base) ++s;
  return s;
}

__global__ void __launch_bounds__(ROWS * SLICES)
tile_sumsq_kernel(const float* __restrict__ x, float* __restrict__ part,
                  const __grid_constant__ Table t) {
  __shared__ float red[SLICES][ROWS + 1];
  const Segment& g = t.seg[tile_segment(t, blockIdx.x)];
  const int local = static_cast<int>(blockIdx.x) - g.tile_base;
  const int kt = local % g.ktiles;
  const int ct = local / g.ktiles;
  const int64_t k = static_cast<int64_t>(kt) * ROWS + threadIdx.x;
  const int64_t c0 = static_cast<int64_t>(ct) * CHUNK;
  const int64_t c1 = c0 + CHUNK < g.C ? c0 + CHUNK : g.C;
  float acc = 0.0f;
  if (k < g.K) {
    const float* row = x + g.offset + k * g.sK;
#pragma unroll 4
    for (int64_t c = c0 + threadIdx.y; c < c1; c += SLICES) {
      const float v = row[c * g.sC];
      acc += v * v;
    }
  }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && k < g.K) {
    float s = 0.0f;
    for (int j = 0; j < SLICES; ++j) s += red[j][threadIdx.x];
    part[g.part_base + static_cast<int64_t>(ct) * g.K + k] = s;
  }
}

__global__ void __launch_bounds__(COMBINE)
combine_kernel(const float* __restrict__ part, float* __restrict__ out,
               int64_t k_total, int take_sqrt,
               const __grid_constant__ Table t) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * COMBINE + threadIdx.x;
  if (i >= k_total) return;
  const Segment& g = t.seg[out_segment(t, i)];
  const int64_t k = i - g.out_base;
  const int64_t chunks = (static_cast<int64_t>(g.C) + CHUNK - 1) / CHUNK;
  float s = 0.0f;
  for (int64_t ch = 0; ch < chunks; ++ch) s += part[g.part_base + ch * g.K + k];
  out[i] = take_sqrt ? sqrtf(s) : s;
}

// threshold_apply: out = x * (norms[k] >= thr) per element, and keep[k] =
// (norms[k] >= thr) as float32, over the table's segments (the lane table
// of common.cuh: storage offsets [0, n) from the base pointers x and out,
// k_total norms and keep flags).
//
// Bound on an H100 (3.35 TB/s): bytes.  8 B per element (read x, write
// out) plus 8 B per kernel (read norms, write keep): 13.3 MB for the
// fmnist-cnn update (N = 1,663,370, K = 622), about 4.0 us.
//
// Design, for the H100, as fused_compress.cu's: the step is element-wise,
// so one launch takes the whole flat update (the beta planner's Eq. 2 step,
// once per rho) in a grid-stride loop over storage offsets on a grid sized
// from the SM count; the 10- to 512-element leaves share blocks with the
// rest instead of each costing a launch.  Every lane finds its own leaf and
// kernel id (repro_kernel_of), since leaf offsets are not 16-byte aligned.
// When x and out start on 16-byte boundaries each thread moves float4s and
// the first block does the n % 4 tail; otherwise the scalar loop runs.  A
// second grid-stride loop writes keep.  x * keep is __fmul_rn, as the
// plain version's product rounds.  A single dense view is a one-segment
// table.
__device__ __forceinline__ float masked(float x, const float* norms,
                                        uint32_t k, float thr) {
  return __fmul_rn(x, norms[k] >= thr ? 1.0f : 0.0f);
}

__device__ __forceinline__ void write_keep(const float* __restrict__ norms,
                                           float* __restrict__ keep,
                                           uint32_t k_total, float thr) {
  for (uint32_t i = blockIdx.x * THREADS + threadIdx.x; i < k_total;
       i += gridDim.x * THREADS)
    keep[i] = norms[i] >= thr ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(THREADS)
threshold_vec4_kernel(const float* __restrict__ x,
                      const float* __restrict__ norms,
                      float* __restrict__ out, float* __restrict__ keep,
                      uint32_t n, uint32_t k_total, float thr,
                      const __grid_constant__ ReproLaneTable t) {
  const uint32_t n4 = n / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  int s = 0;
  for (uint32_t i = blockIdx.x * THREADS + threadIdx.x; i < n4;
       i += gridDim.x * THREADS) {
    const float4 xv = x4[i];
    const uint32_t p = 4 * i;
    float4 ov;
    ov.x = masked(xv.x, norms, repro_kernel_of(t, p, s), thr);
    ov.y = masked(xv.y, norms, repro_kernel_of(t, p + 1, s), thr);
    ov.z = masked(xv.z, norms, repro_kernel_of(t, p + 2, s), thr);
    ov.w = masked(xv.w, norms, repro_kernel_of(t, p + 3, s), thr);
    o4[i] = ov;
  }
  const uint32_t p = 4 * n4 + threadIdx.x;
  if (blockIdx.x == 0 && p < n)
    out[p] = masked(x[p], norms, repro_kernel_of(t, p, s), thr);
  write_keep(norms, keep, k_total, thr);
}

__global__ void __launch_bounds__(THREADS)
threshold_scalar_kernel(const float* __restrict__ x,
                        const float* __restrict__ norms,
                        float* __restrict__ out, float* __restrict__ keep,
                        uint32_t n, uint32_t k_total, float thr,
                        const __grid_constant__ ReproLaneTable t) {
  int s = 0;
  for (uint32_t p = blockIdx.x * THREADS + threadIdx.x; p < n;
       p += gridDim.x * THREADS)
    out[p] = masked(x[p], norms, repro_kernel_of(t, p, s), thr);
  write_keep(norms, keep, k_total, thr);
}

}  // namespace

// x, out: the input and output at storage offsets [0, n); norms, keep:
// k_total floats each; rows: n_seg x REPRO_ROW_FIELDS int64.  One launch
// on `stream`.
extern "C" int threshold_apply_segments_f32(const float* x,
                                            const float* norms, float* out,
                                            float* keep, const int64_t* rows,
                                            int n_seg, int64_t n,
                                            int64_t k_total, float thr,
                                            cudaStream_t stream) {
  ReproLaneTable t;
  const int bad = repro_lane_table(rows, n_seg, n, &t);
  if (bad) return bad;
  if (k_total < 0 || k_total > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = repro_aligned16(x, out);
  const int64_t work = vec4 ? n / 4 : n;
  unsigned grid = 0;
  const cudaError_t err = repro_grid(work > k_total ? work : k_total, THREADS,
                                     BLOCKS_PER_SM, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec4)
    threshold_vec4_kernel<<<grid, THREADS, 0, stream>>>(
        x, norms, out, keep, static_cast<uint32_t>(n),
        static_cast<uint32_t>(k_total), thr, t);
  else
    threshold_scalar_kernel<<<grid, THREADS, 0, stream>>>(
        x, norms, out, keep, static_cast<uint32_t>(n),
        static_cast<uint32_t>(k_total), thr, t);
  return repro_launch_status();
}

// x: the base pointer; rows: n_seg x REPRO_ROW_FIELDS int64 (see above);
// part: scratch of one float per (chunk, kernel) of every segment; out:
// k_total floats.  Two launches on one stream: the tiles, then the
// combine.
extern "C" int kernel_sumsq_segments_f32(const float* x, float* out,
                                         float* part, const int64_t* rows,
                                         int n_seg, int64_t n_tiles,
                                         int64_t k_total, int take_sqrt,
                                         cudaStream_t stream) {
  if (n_seg < 1 || n_seg > REPRO_MAX_SEGMENTS || n_tiles < 0 ||
      n_tiles > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  Table t;
  t.n = n_seg;
  for (int i = 0; i < n_seg; ++i) {
    const int64_t* r = rows + static_cast<int64_t>(i) * REPRO_ROW_FIELDS;
    Segment& g = t.seg[i];
    g.offset = r[0];
    g.K = static_cast<int32_t>(r[1]);
    g.C = static_cast<int32_t>(r[2]);
    g.sK = r[3];
    g.sC = r[4];
    g.out_base = static_cast<int32_t>(r[5]);
    g.tile_base = static_cast<int32_t>(r[6]);
    g.part_base = r[7];
    g.ktiles = static_cast<int32_t>(r[8]);
    g.pad = 0;
  }
  if (n_tiles > 0) {
    tile_sumsq_kernel<<<static_cast<unsigned>(n_tiles), dim3(ROWS, SLICES), 0,
                        stream>>>(x, part, t);
    const int status = repro_launch_status();
    if (status != 0) return status;
  }
  if (k_total > 0) {
    const unsigned grid =
        static_cast<unsigned>((k_total + COMBINE - 1) / COMBINE);
    combine_kernel<<<grid, COMBINE, 0, stream>>>(part, out, k_total,
                                                 take_sqrt, t);
  }
  return repro_launch_status();
}
