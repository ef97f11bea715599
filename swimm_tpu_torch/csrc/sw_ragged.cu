// Exact Smith-Waterman / Gotoh scores over the whole-DB ragged tile stream.
//
// Layout, recurrence, strip-mining and the bound on the card are described
// in sw_walk.cuh; what bounded the first design on the card, and the walk
// with cooperating workers that answers it, in sw_walk_hg.cuh. Three
// kernels, all on that walk:
//
//   sw_ragged_kernel        replaces swimm_tpu/ops/pallas_scorer.py
//                           _dp_ragged_kernel (via score_tiles): a query of
//                           at most 2048 padded rows against every block,
//                           two workers to a block on the walk of
//                           sw_walk_hg.cuh.
//   sw_ragged_qtile_kernel  replaces swimm_tpu/ops/longquery.py
//                           _dp_ragged_tile_kernel (via _score_tiles_one_qtile):
//                           one query tile of a long query, with the H/F
//                           boundary rows carried in and out through device
//                           memory, in place, on the carry form of the walk
//                           of sw_walk_hg.cuh (four workers to a block).
//   sw_ragged_packed_kernel replaces swimm_tpu/ops/pallas_scorer.py
//                           _dp_packed_kernel (via score_tiles_packed): a
//                           PACKED multi-query profile, one score plane per
//                           query, on the packed form of the walk of
//                           sw_walk_hg.cuh.
//
// Layout. tiles is (T, jt, V) int8, block-major: the tiles of one block
// (one output row) are consecutive, so a block's codes are one contiguous
// (npos, V) array with npos = n_tiles * jt. Each CUDA block finds its tile
// range in row_start (n_rows + 1 entries, computed once per DB by the
// wrapper) — the TPU kernel's scalar-prefetched outrow map is not needed.
//
// Long queries. sw_ragged_qtile_kernel reads the carries at the tile's
// first strip and writes them at its last, and its workers hand the
// boundary between rounds on through the same two streams (sw_walk_hg.cuh,
// the carry form): it needs no strip scratch. Unlike the TPU kernel, which
// carries a global-ramp column cummax ("gcar"), this port carries real
// bottom-row H and real F into the next row; the carries are internal to
// score_tiles_long, whose contract is its output. At a block's first db
// position the H boundary is 0 and E starts at NEG.
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
// special case. The packed kernel does the same integer work per cell as
// sw_ragged_kernel (the cap is one min per 8 rows, the maxima are kept per
// group) on the same schedule of two workers per DB block. The strips of
// one lane now belong to two threads a step apart, and one query's rows
// may lie in both, so each strip's group maxima go to the query's plane by
// an atomic maximum; the wrapper zero-fills the planes.

#include "sw_walk.cuh"
#include "sw_walk_hg.cuh"

namespace {

using namespace sw;

// Workers per DB block of sw_ragged_qtile_kernel: a 1024-row query tile is
// 32 strips, which four workers share in eight full rounds (two workers:
// 0.24% slower; sw_walk_hg.cuh).
constexpr int QTILE_WORKERS = 4;

// The DB block this CUDA block takes. The packed DB is sorted by length,
// so rows are taken last first: the longest blocks start at once and the
// short ones fill in behind them, instead of the longest block starting
// last and running on alone after every other has finished.
__device__ __forceinline__ int block_row() {
  return gridDim.x - 1 - blockIdx.x;
}

// Block `row`: offset of its first position in the (T, jt, V) stream, and
// its position count.
__device__ __forceinline__ int64_t block_span(
    const int64_t* __restrict__ row_start, int row, int jt, int V,
    int* npos) {
  const int64_t t0 = row_start[row];
  *npos = static_cast<int>(row_start[row + 1] - t0) * jt;
  return t0 * jt * V;
}

// Kernel 1: whole query, optional saturating ceiling (H clamped at
// ceiling; a lane whose exact score reaches the ceiling reports exactly
// ceiling): two kernels chosen by the launcher, not one branch, so neither
// carries the other's registers. blockDim.x / V workers share one DB block
// (sw_walk_hg.cuh); carry is scratch, one (hg, F) pair per (db position,
// lane), unused when every strip has a worker of its own. At most
// HG_MAX_THREADS threads, so at most 128 registers.
template <bool CEIL>
__global__ void __launch_bounds__(HG_MAX_THREADS, 1)
sw_ragged_kernel(const int8_t* __restrict__ tiles,
                 const int64_t* __restrict__ row_start, int V, int jt,
                 const int* __restrict__ qp, int m, int goe, int ge,
                 int ceiling, int2* carry, int* __restrict__ out) {
  extern __shared__ int smem[];
  int npos;
  const int row = block_row();
  const int64_t base = block_span(row_start, row, jt, V, &npos);
  const int smax = hg_walk_block<CEIL, false>(
      tiles + base, npos, V, qp, m, goe, ge, ceiling,
      carry ? carry + base : nullptr, smem, PackedPlanes{});
  if (threadIdx.x < V) out[(int64_t)row * V + threadIdx.x] = smax;
}

// Kernel 2: one query tile of m rows; ch/cf hold the row above the tile on
// entry (real H of its bottom row, the F entering its first row) and the
// tile's own bottom row on exit, updated in place. They may alias each
// other's reads and writes inside the walk, so neither is __restrict__.
// At most QTILE_WORKERS workers; the thread limit as kernel 1.
__global__ void __launch_bounds__(HG_MAX_THREADS, 1)
sw_ragged_qtile_kernel(const int8_t* __restrict__ tiles,
                       const int64_t* __restrict__ row_start, int V, int jt,
                       const int* __restrict__ qp, int m, int goe, int ge,
                       int* ch, int* cf, int* __restrict__ out) {
  extern __shared__ int smem[];
  int npos;
  const int row = block_row();
  const int64_t base = block_span(row_start, row, jt, V, &npos);
  const int smax = hg_walk_block<false, false>(
      tiles + base, npos, V, qp, m, goe, ge, 0, HRows{ch + base, cf + base},
      smem, PackedPlanes{});
  if (threadIdx.x < V) out[(int64_t)row * V + threadIdx.x] = smax;
}

// Kernel 3: packed multi-query profile of m rows (m % 8 == 0; packs are
// multiples of 64), seg_of_group (m / 8,) int32 nondecreasing. out is
// (n_rows, n_planes, V) int32, zero on entry. Workers, carry and the thread
// limit as kernel 1.
__global__ void __launch_bounds__(HG_MAX_THREADS, 1)
sw_ragged_packed_kernel(const int8_t* __restrict__ tiles,
                        const int64_t* __restrict__ row_start, int V, int jt,
                        const int* __restrict__ qp, int m,
                        const int* __restrict__ seg_of_group, int n_planes,
                        int goe, int ge, int2* carry, int* out) {
  extern __shared__ int smem[];
  int npos;
  const int row = block_row();
  const int64_t base = block_span(row_start, row, jt, V, &npos);
  const PackedPlanes pk{seg_of_group, n_planes,
                        out + (int64_t)row * n_planes * V + threadIdx.x % V};
  hg_walk_block<false, true>(tiles + base, npos, V, qp, m, goe, ge, 0,
                             carry ? carry + base : nullptr, smem, pk);
}

template <bool CEIL>
int launch_ragged(const void* tiles, const void* row_start, int n_rows, int V,
                  int jt, const void* qp, int m, int goe, int ge, int ceiling,
                  void* carry, void* out, void* stream) {
  int threads;
  size_t shared;
  const cudaError_t err =
      hg_launch_shape(sw_ragged_kernel<CEIL>, V, m, HG_MAX_WORKERS,
                      &threads, &shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  sw_ragged_kernel<CEIL><<<n_rows, threads, shared,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(tiles),
      static_cast<const int64_t*>(row_start), V, jt,
      static_cast<const int*>(qp), m, goe, ge, ceiling,
      static_cast<int2*>(carry), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sw_ragged_launch(const void* tiles, const void* row_start,
                                int n_rows, int V, int jt, const void* qp,
                                int m, int goe, int ge, int has_ceiling,
                                int ceiling, void* carry, void* out,
                                void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  return has_ceiling
             ? launch_ragged<true>(tiles, row_start, n_rows, V, jt, qp, m, goe,
                                   ge, ceiling, carry, out, stream)
             : launch_ragged<false>(tiles, row_start, n_rows, V, jt, qp, m,
                                    goe, ge, 0, carry, out, stream);
}

extern "C" int sw_ragged_qtile_launch(const void* tiles, const void* row_start,
                                      int n_rows, int V, int jt,
                                      const void* qp, int m, int goe, int ge,
                                      void* ch, void* cf, void* out,
                                      void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  int threads;
  size_t shared;
  const cudaError_t err = hg_launch_shape(sw_ragged_qtile_kernel, V, m,
                                          QTILE_WORKERS, &threads, &shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  sw_ragged_qtile_kernel<<<n_rows, threads, shared,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(tiles),
      static_cast<const int64_t*>(row_start), V, jt,
      static_cast<const int*>(qp), m, goe, ge, static_cast<int*>(ch),
      static_cast<int*>(cf), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sw_ragged_packed_launch(const void* tiles,
                                       const void* row_start, int n_rows,
                                       int V, int jt, const void* qp, int m,
                                       const void* seg_of_group, int n_planes,
                                       int goe, int ge, void* carry,
                                       void* out, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  int threads;
  size_t shared;
  const cudaError_t err =
      hg_launch_shape(sw_ragged_packed_kernel, V, m, HG_MAX_WORKERS,
                      &threads, &shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  sw_ragged_packed_kernel<<<n_rows, threads, shared,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(tiles),
      static_cast<const int64_t*>(row_start), V, jt,
      static_cast<const int*>(qp), m, static_cast<const int*>(seg_of_group),
      n_planes, goe, ge, static_cast<int2*>(carry), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
