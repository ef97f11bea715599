// Exact Smith-Waterman / Gotoh scores over the whole-DB ragged tile stream.
//
// Three kernels share the strip walk of sw_walk.cuh (layout, recurrence,
// strip-mining and the bound on the card are described there):
//
//   sw_ragged_kernel        replaces swimm_tpu/ops/pallas_scorer.py
//                           _dp_ragged_kernel (via score_tiles): a query of
//                           at most 2048 padded rows against every block.
//   sw_ragged_qtile_kernel  replaces swimm_tpu/ops/longquery.py
//                           _dp_ragged_tile_kernel (via _score_tiles_one_qtile):
//                           one query tile of a long query, with the H/F
//                           boundary rows carried in and out through device
//                           memory.
//   sw_ragged_packed_kernel replaces swimm_tpu/ops/pallas_scorer.py
//                           _dp_packed_kernel (via score_tiles_packed): a
//                           PACKED multi-query profile, one score plane per
//                           query.
//
// Layout. tiles is (T, jt, V) int8, block-major: the tiles of one block
// (one output row) are consecutive, so a block's codes are one contiguous
// (npos, V) array with npos = n_tiles * jt. Each CUDA block finds its tile
// range in row_start (n_rows + 1 entries, computed once per DB by the
// wrapper) — the TPU kernel's scalar-prefetched outrow map is not needed.
//
// Long queries. sw_ragged_qtile_kernel is the same walk with the carries
// read at the tile's first strip and written at its last. Unlike the TPU
// kernel, which carries a global-ramp column cummax ("gcar"), this port
// carries real bottom-row H and real F into the next row; the carries are
// internal to score_tiles_long, whose contract is its output. At a block's
// first db position the H boundary is 0 and E starts at NEG.
//
// Packed profiles. The profile is several queries one under the other,
// each 8-row aligned and followed by an 8-row separator group whose
// profile is a large negative score for every code, then a separator tail;
// seg_of_group (a runtime input, so one kernel serves every pack layout)
// gives each 8-row group a nondecreasing segment id: 2s for query s, 2s+1
// for its separator, a last odd id for the tail. The TPU kernel keeps the
// queries apart with a segmented cummax (an offset per segment id and a
// poisoned add at segment starts), which its vector unit needs; here F is
// a scalar chain, so the walk only caps F at NEG at the first row of
// every group whose id differs from the group above — query starts,
// separator starts and the tail start alike. Separator rows then hold
// H = 0 (no diagonal, no F from above, E <= 0), so the next query's first
// row sees the boundary of a query run alone, and the diagonal needs no
// special case. A thread owns its (block, lane) through all strips, so it
// folds each group's maximum into its query's plane with a plain
// read-max-write; the wrapper zero-fills the planes. The packed kernel
// does the same integer work per cell as sw_ragged_kernel (the cap is
// one min per 8 rows) and is bound by instruction rate like it.

#include <climits>

#include "sw_walk.cuh"

namespace {

using namespace sw;

// The DB block this CUDA block takes. The packed DB is sorted by length,
// so rows are taken last first: the longest blocks start at once and the
// short ones fill in behind them, instead of the longest block starting
// last and running on alone after every other has finished.
__device__ __forceinline__ int block_row() {
  return gridDim.x - 1 - blockIdx.x;
}

// This thread's lane of block `row`: offset of its first position in the
// (T, jt, V) stream, and the block's position count.
__device__ __forceinline__ int64_t block_span(
    const int64_t* __restrict__ row_start, int row, int jt, int V,
    int64_t* npos) {
  const int64_t t0 = row_start[row];
  *npos = (row_start[row + 1] - t0) * jt;
  return t0 * jt * V + threadIdx.x;
}

// Kernel 1: whole query, optional saturating ceiling (H clamped at
// ceiling; a lane whose exact score reaches the ceiling reports exactly
// ceiling). ch/cf are scratch (unused when m fits one strip).
__global__ void sw_ragged_kernel(const int8_t* __restrict__ tiles,
                                 const int64_t* __restrict__ row_start,
                                 int V, int jt, const int* __restrict__ qp,
                                 int m, int goe, int ge, int has_ceiling,
                                 int ceiling, int* ch, int* cf,
                                 int* __restrict__ out) {
  int64_t npos;
  const int row = block_row();
  const int64_t base = block_span(row_start, row, jt, V, &npos);
  int* chb = ch ? ch + base : nullptr;
  int* cfb = cf ? cf + base : nullptr;
  const int smax =
      has_ceiling
          ? walk_block<true>(tiles + base, npos, V, qp, m, goe, ge, ceiling,
                             chb, cfb, false, false)
          : walk_block<false>(tiles + base, npos, V, qp, m, goe, ge, 0, chb,
                              cfb, false, false);
  out[(int64_t)row * V + threadIdx.x] = smax;
}

// Kernel 2: one query tile of tile_m rows; ch/cf hold the row above the
// tile on entry (H bottom row, F into the first row) and the tile's own
// bottom row on exit (updated in place).
__global__ void sw_ragged_qtile_kernel(const int8_t* __restrict__ tiles,
                                       const int64_t* __restrict__ row_start,
                                       int V, int jt,
                                       const int* __restrict__ qp, int m,
                                       int goe, int ge, int* ch, int* cf,
                                       int* __restrict__ out) {
  int64_t npos;
  const int row = block_row();
  const int64_t base = block_span(row_start, row, jt, V, &npos);
  const int smax = walk_block<false>(tiles + base, npos, V, qp, m, goe, ge,
                                     0, ch + base, cf + base, true, true);
  out[(int64_t)row * V + threadIdx.x] = smax;
}

// One strip of a packed profile: groups g0 .. g0 + R/8 - 1. planes points
// at this thread's lane of the block's plane 0 (plane stride V).
template <int R>
__device__ __forceinline__ void packed_strip(
    bool rd, bool wr, const int8_t* codes, int64_t npos, int V,
    const int* prof, int goe, int ge, int* ch, int* cf,
    const int* __restrict__ seg_of_group, int g0, int n_planes,
    int* planes) {
  constexpr int G = R / SEG_ROWS;
  int seg[G], fcap[G], gmax[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    seg[g] = seg_of_group[g0 + g];
    const bool starts = g0 + g == 0 || seg_of_group[g0 + g - 1] != seg[g];
    fcap[g] = starts ? NEG : INT_MAX;
  }
  strip_dispatch<R, false, true>(rd, wr, codes, npos, V, prof, goe, ge, 0,
                                 ch, cf, 0, fcap, gmax);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    // even ids are queries (plane id / 2); odd ids (separators, tail) and
    // ids past the planes are dropped
    const int s = seg[g];
    if (s >= 0 && !(s & 1) && s / 2 < n_planes) {
      int* o = planes + (int64_t)(s / 2) * V;
      *o = max(*o, gmax[g]);
    }
  }
}

// Kernel 3: packed multi-query profile of m rows (m % 8 == 0; packs are
// multiples of 64), seg_of_group (m / 8,) int32 nondecreasing. out is
// (n_rows, n_planes, V) int32, zero on entry. ch/cf are scratch (unused
// when m fits one strip).
__global__ void sw_ragged_packed_kernel(
    const int8_t* __restrict__ tiles, const int64_t* __restrict__ row_start,
    int V, int jt, const int* __restrict__ qp, int m,
    const int* __restrict__ seg_of_group, int n_planes, int goe, int ge,
    int* ch, int* cf, int* out) {
  __shared__ int prof[STRIP * TABLE_CODES];
  int64_t npos;
  const int row = block_row();
  const int64_t base = block_span(row_start, row, jt, V, &npos);
  const int8_t* codes = tiles + base;
  int* chb = ch ? ch + base : nullptr;
  int* cfb = cf ? cf + base : nullptr;
  int* planes = out + (int64_t)row * n_planes * V + threadIdx.x;
  const int n_full = m / STRIP;
  const int n_strips = n_full + (m % STRIP) / STRIP_TAIL;
  for (int s = 0; s < n_strips; ++s) {
    const bool rd = s > 0;
    const bool wr = s < n_strips - 1;
    if (s < n_full) {
      stage_profile<STRIP>(prof, qp, m, s * STRIP);
      packed_strip<STRIP>(rd, wr, codes, npos, V, prof, goe, ge, chb, cfb,
                          seg_of_group, s * (STRIP / SEG_ROWS), n_planes,
                          planes);
    } else {
      const int r0 = n_full * STRIP + (s - n_full) * STRIP_TAIL;
      stage_profile<STRIP_TAIL>(prof, qp, m, r0);
      packed_strip<STRIP_TAIL>(rd, wr, codes, npos, V, prof, goe, ge, chb,
                               cfb, seg_of_group, r0 / SEG_ROWS, n_planes,
                               planes);
    }
  }
}

}  // namespace

extern "C" int sw_ragged_launch(const void* tiles, const void* row_start,
                                int n_rows, int V, int jt, const void* qp,
                                int m, int goe, int ge, int has_ceiling,
                                int ceiling, void* ch, void* cf, void* out,
                                void* stream) {
  if (n_rows > 0) {
    sw_ragged_kernel<<<n_rows, V, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(tiles),
        static_cast<const int64_t*>(row_start), V, jt,
        static_cast<const int*>(qp), m, goe, ge, has_ceiling, ceiling,
        static_cast<int*>(ch), static_cast<int*>(cf), static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sw_ragged_qtile_launch(const void* tiles, const void* row_start,
                                      int n_rows, int V, int jt,
                                      const void* qp, int m, int goe, int ge,
                                      void* ch, void* cf, void* out,
                                      void* stream) {
  if (n_rows > 0) {
    sw_ragged_qtile_kernel<<<n_rows, V, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(tiles),
        static_cast<const int64_t*>(row_start), V, jt,
        static_cast<const int*>(qp), m, goe, ge, static_cast<int*>(ch),
        static_cast<int*>(cf), static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sw_ragged_packed_launch(const void* tiles,
                                       const void* row_start, int n_rows,
                                       int V, int jt, const void* qp, int m,
                                       const void* seg_of_group, int n_planes,
                                       int goe, int ge, void* ch, void* cf,
                                       void* out, void* stream) {
  if (n_rows > 0) {
    sw_ragged_packed_kernel<<<n_rows, V, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(tiles),
        static_cast<const int64_t*>(row_start), V, jt,
        static_cast<const int*>(qp), m,
        static_cast<const int*>(seg_of_group), n_planes, goe, ge,
        static_cast<int*>(ch), static_cast<int*>(cf), static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
