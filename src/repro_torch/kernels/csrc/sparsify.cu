// Kernel-wise sparsification (FGC Eq. 2): the per-kernel sums of squares
// and L2 norms, and the threshold step that zeroes the kernels below thr.
//
// Replaces: repro/kernels/sparsify.py:kernel_sumsq (pl.pallas_call at :47)
// and kernel_l2 (:58, sqrt of the former), as one kernel with an optional
// sqrt epilogue; and threshold_apply (:70, pl.pallas_call at :83), below.
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
constexpr int THREADS = 256;  // threshold_kernel: one thread per element
constexpr int MAX_SEGMENTS = 64;
// int64 fields per segment row of the host table, in this order:
// offset, K, C, sK, sC, out_base, tile_base, part_base, ktiles
constexpr int ROW_FIELDS = 9;

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
  Segment seg[MAX_SEGMENTS];
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

// x: the base pointer; rows: n_seg x ROW_FIELDS int64 (see above); part:
// scratch of one float per (chunk, kernel) of every segment; out: k_total
// floats.  Two launches on one stream: the tiles, then the combine.
extern "C" int kernel_sumsq_segments_f32(const float* x, float* out,
                                         float* part, const int64_t* rows,
                                         int n_seg, int64_t n_tiles,
                                         int64_t k_total, int take_sqrt,
                                         cudaStream_t stream) {
  if (n_seg < 1 || n_seg > MAX_SEGMENTS || n_tiles < 0 ||
      n_tiles > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  Table t;
  t.n = n_seg;
  for (int i = 0; i < n_seg; ++i) {
    const int64_t* r = rows + static_cast<int64_t>(i) * ROW_FIELDS;
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
