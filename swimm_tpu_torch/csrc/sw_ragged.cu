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
//                           on the walk of sw_walk_hg.cuh: in int32
//                           lanes (<CEIL>, two workers to a block; the
//                           ladder's ceilings, the fallback, the
//                           re-score) or in 16-bit lane pairs (<false,
//                           true>, the pair form: scorer.py says when
//                           each runs); the pair form also on the split
//                           walk (<false, true, true>: a long DB block
//                           walked by several CUDA blocks, where
//                           scorer.split_plan splits one).
//   sw_ragged_qtile_kernel  replaces swimm_tpu/ops/longquery.py
//                           _dp_ragged_tile_kernel (via _score_tiles_one_qtile):
//                           one query tile of a long query, with the H/F
//                           boundary rows carried in and out through device
//                           memory, in place, on the carry form of the walk
//                           of sw_walk_hg.cuh (four workers to a block); in
//                           int32 lanes (<false>) or in 16-bit lane pairs
//                           (<true>, the pair form: longquery.py says when
//                           each runs).
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

// Each lane's maximum H out of the pair form's maximum of hg = H - goe of
// lanes 2u (low half) and 2u + 1 (high half), by the threads u < V / 2.
__device__ __forceinline__ void store_pair_max(int* out, int V, unsigned gm,
                                               int goe) {
  if (threadIdx.x < V / 2)
    reinterpret_cast<int2*>(out)[threadIdx.x] =
        make_int2(static_cast<short>(gm & 0xFFFFu) + goe,
                  static_cast<short>(gm >> 16) + goe);
}

// Kernel 1: whole query, optional saturating ceiling (H clamped at
// ceiling; a lane whose exact score reaches the ceiling reports exactly
// ceiling): kernels chosen by the launcher, not one branch, so none
// carries another's registers. blockDim.x / V workers share one DB block
// (sw_walk_hg.cuh); carry is scratch, one (hg, F) pair per (db position,
// lane), unused when every strip has a worker of its own. At most
// HG_MAX_THREADS threads, so at most 128 registers. PAIRS: the pair form
// (sw_walk_hg.cuh, whole-query edges), two lanes a thread, at most
// WHOLE_PAIR_WORKERS workers of V / 2 threads, no ceiling; carry is then
// two (T, jt, V / 2) int32 streams of lane pairs, H and after it F, and
// each lane's maximum H goes out, exact in every lane that stays below
// 32,767 minus the largest profile entry and at least that in every other.
template <bool CEIL, bool PAIRS = false>
__global__ void __launch_bounds__(HG_MAX_THREADS, 1)
sw_ragged_kernel(const int8_t* __restrict__ tiles,
                 const int64_t* __restrict__ row_start, int V, int jt,
                 const int* __restrict__ qp, int m, int goe, int ge,
                 int ceiling, int2* carry, int* __restrict__ out) {
  extern __shared__ int smem[];
  int npos;
  const int row = block_row();
  const int64_t base = block_span(row_start, row, jt, V, &npos);
  if constexpr (PAIRS) {
    static_assert(!CEIL, "the pair form has no ceiling");
    unsigned* const ch = reinterpret_cast<unsigned*>(carry);
    // the F stream follows the H stream: T * jt * V / 2 words
    const int64_t words = row_start[gridDim.x] * jt * (V / 2);
    const unsigned gm = hg_walk_block_pairs<true>(
        tiles + base, npos, V, qp, m, goe, ge,
        ch ? PairRows{ch + base / 2, ch + words + base / 2}
           : PairRows{nullptr, nullptr},
        smem);
    store_pair_max(out + (int64_t)row * V, V, gm, goe);
  } else {
    const int smax = hg_walk_block<CEIL, false>(
        tiles + base, npos, V, qp, m, goe, ge, ceiling,
        carry ? carry + base : nullptr, smem, PackedPlanes{});
    if (threadIdx.x < V) out[(int64_t)row * V + threadIdx.x] = smax;
  }
}

// Kernel 1's pair form on the split walk (sw_walk_hg.cuh): a DB block may
// be walked by two or four CUDA blocks, its parts. block_map holds one
// entry per CUDA block, row << 4 | part << 2 | (parts - 1): the DB blocks
// split first, longest first, a DB block's parts adjacent and part 0 first,
// then the others, longest first (built on the host: ops/scorer.py
// split_plan). CUDA block b takes entry b, so where the card starts CUDA
// blocks in order of blockIdx.x, as it does, it spreads the longest DB
// blocks over its SMs as it does the unsplit kernel's (entries taken in
// the order CUDA blocks start let the longest share SMs, and the last
// window ran slower than unsplit: PERF.md §6). done holds a progress word
// per entry, then a gate word per entry (that of a DB block's part 0 is
// its gate), all zero on entry. out is zero on entry: the parts of a split
// DB block fold their lanes' maxima into it by an atomic maximum (H >= 0);
// a DB block walked by one CUDA block stores them.
//
// Forward progress, in any start order. A part waits only on parts of its
// own DB block, and only once all of them have passed its gate, that is,
// are running (sw_walk_hg.cuh, "The gate"); a DB block whose parts do not
// all start within SPLIT_GATE_NS of each other is walked by one of them
// alone. A DB block of one part waits on nothing. Speed needs more: the
// planner gives the split DB blocks no more parts in all than the launch's
// slots (sw_ragged_split_slots) and puts them first, so that they start in
// the first wave, side by side.
//
// A separate template instance, overloading the unsplit kernel, so
// sw_ragged_kernel<false, true> keeps its name and its code, and profiles
// count both under kernel 1's name.
template <bool CEIL, bool PAIRS, bool SPLIT>
__global__ void __launch_bounds__(HG_MAX_THREADS, 1)
sw_ragged_kernel(const int8_t* __restrict__ tiles,
                 const int64_t* __restrict__ row_start, int V, int jt,
                 const int* __restrict__ qp, int m, int goe, int ge,
                 int n_rows, const int* __restrict__ block_map, int* done,
                 unsigned* carry, int* out) {
  static_assert(!CEIL && PAIRS && SPLIT,
                "the split walk is kernel 1's pair form");
  extern __shared__ int smem[];
  __shared__ int seen;
  const int job = blockIdx.x;   // the entry this CUDA block takes
  const int entry = block_map[job];
  const int row = entry >> 4;
  int part = (entry >> 2) & 3;
  int parts = (entry & 3) + 1;
  if (parts > 1) {   // the gate: done's second half, at part 0's entry
    __shared__ int turn;
    if (threadIdx.x == 0)
      turn = split_gate(done + gridDim.x + job - part, parts);
    __syncthreads();
    if (turn == GATE_LEAVE) return;
    if (turn == GATE_ALONE) part = 0, parts = 1;
  }
  int npos;
  const int64_t base = block_span(row_start, row, jt, V, &npos);
  // the F stream follows the H stream: T * jt * V / 2 words
  const int64_t words = row_start[n_rows] * jt * (V / 2);
  const unsigned gm = hg_walk_block_pairs<true, true>(
      tiles + base, npos, V, qp, m, goe, ge,
      carry ? PairRows{carry + base / 2, carry + words + base / 2}
            : PairRows{nullptr, nullptr},
      smem,
      PairSplit{part, parts, done + job,
                done + (part > 0 ? job - 1 : job + parts - 1), &seen});
  if (parts == 1) {
    store_pair_max(out + (int64_t)row * V, V, gm, goe);
  } else if (threadIdx.x < V / 2) {
    int* const o = out + (int64_t)row * V + 2 * threadIdx.x;
    atomicMax(o, static_cast<short>(gm & 0xFFFFu) + goe);
    atomicMax(o + 1, static_cast<short>(gm >> 16) + goe);
  }
}

// Kernel 2: one query tile of m rows; ch/cf hold the row above the tile on
// entry (real H of its bottom row, the F entering its first row) and the
// tile's own bottom row on exit, updated in place. They may alias each
// other's reads and writes inside the walk, so neither is __restrict__.
// At most QTILE_WORKERS workers; the thread limit as kernel 1. PAIRS: the
// pair form (sw_walk_hg.cuh), two lanes a thread, at most
// QTILE_PAIR_WORKERS workers of V / 2 threads, ch/cf two (T, jt, V / 2)
// streams of lane pairs, and each lane's maximum H over the tile's rows out,
// exact in every lane that stays below 32,767 minus the largest profile
// entry and at least that in every other.
template <bool PAIRS>
__global__ void __launch_bounds__(HG_MAX_THREADS, 1)
sw_ragged_qtile_kernel(const int8_t* __restrict__ tiles,
                       const int64_t* __restrict__ row_start, int V, int jt,
                       const int* __restrict__ qp, int m, int goe, int ge,
                       int* ch, int* cf, int* __restrict__ out) {
  extern __shared__ int smem[];
  int npos;
  const int row = block_row();
  const int64_t base = block_span(row_start, row, jt, V, &npos);
  if constexpr (PAIRS) {
    const unsigned gm = hg_walk_block_pairs<false>(
        tiles + base, npos, V, qp, m, goe, ge,
        PairRows{reinterpret_cast<unsigned*>(ch) + base / 2,
                 reinterpret_cast<unsigned*>(cf) + base / 2},
        smem);
    store_pair_max(out + (int64_t)row * V, V, gm, goe);
  } else {
    const int smax = hg_walk_block<false, false>(
        tiles + base, npos, V, qp, m, goe, ge, 0,
        HRows{ch + base, cf + base}, smem, PackedPlanes{});
    if (threadIdx.x < V) out[(int64_t)row * V + threadIdx.x] = smax;
  }
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

template <bool PAIRS>
int launch_qtile(const void* tiles, const void* row_start, int n_rows, int V,
                 int jt, const void* qp, int m, int goe, int ge, void* ch,
                 void* cf, void* out, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  if (PAIRS && V % 64) return static_cast<int>(cudaErrorInvalidValue);
  int threads;
  size_t shared;
  // the pair form's workers are V / 2 threads
  const cudaError_t err =
      PAIRS ? hg_launch_shape(sw_ragged_qtile_kernel<true>, V / 2, m,
                              QTILE_PAIR_WORKERS, &threads, &shared,
                              pair_shared_ints)
            : hg_launch_shape(sw_ragged_qtile_kernel<false>, V, m,
                              QTILE_WORKERS, &threads, &shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  sw_ragged_qtile_kernel<PAIRS><<<n_rows, threads, shared,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(tiles),
      static_cast<const int64_t*>(row_start), V, jt,
      static_cast<const int*>(qp), m, goe, ge, static_cast<int*>(ch),
      static_cast<int*>(cf), static_cast<int*>(out));
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

// The pair form of kernel 1: V % 64 == 0, no ceiling, carry null (a
// one-strip profile) or two (T, jt, V / 2) int32 streams of lane pairs, H
// then F; the caller keeps the profile and the gaps inside the 16-bit range
// (scorer.pair_form_fits).
extern "C" int sw_ragged_pairs_launch(const void* tiles, const void* row_start,
                                      int n_rows, int V, int jt,
                                      const void* qp, int m, int goe, int ge,
                                      void* carry, void* out, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  if (V % 64) return static_cast<int>(cudaErrorInvalidValue);
  int threads;
  size_t shared;
  // workers of V / 2 threads
  const cudaError_t err =
      hg_launch_shape(sw_ragged_kernel<false, true>, V / 2, m,
                      WHOLE_PAIR_WORKERS, &threads, &shared,
                      pair_shared_ints);
  if (err != cudaSuccess) return static_cast<int>(err);
  sw_ragged_kernel<false, true><<<n_rows, threads, shared,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(tiles),
      static_cast<const int64_t*>(row_start), V, jt,
      static_cast<const int*>(qp), m, goe, ge, 0, static_cast<int2*>(carry),
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The pair form of kernel 1 on the split walk: n_blocks CUDA blocks, one per
// entry of block_map, over the n_rows DB blocks of row_start; done
// (2 * n_blocks int32: progress words, then gate words) and out zero on
// entry; the rest as
// sw_ragged_pairs_launch. The parts' hand-off needs the lock step of at
// least two workers a CUDA block: an m of fewer than two strips is refused.
extern "C" int sw_ragged_split_launch(const void* tiles, const void* row_start,
                                      int n_rows, int n_blocks, int V, int jt,
                                      const void* qp, int m, int goe, int ge,
                                      const void* block_map, void* done,
                                      void* carry, void* out, void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaGetLastError());
  if (V % 64) return static_cast<int>(cudaErrorInvalidValue);
  int threads;
  size_t shared;
  const cudaError_t err =
      hg_launch_shape(sw_ragged_kernel<false, true, true>, V / 2, m,
                      WHOLE_PAIR_WORKERS, &threads, &shared,
                      pair_shared_ints);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (threads < V) return static_cast<int>(cudaErrorInvalidValue);
  sw_ragged_kernel<false, true, true><<<n_blocks, threads, shared,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(tiles),
      static_cast<const int64_t*>(row_start), V, jt,
      static_cast<const int*>(qp), m, goe, ge, n_rows,
      static_cast<const int*>(block_map), static_cast<int*>(done),
      static_cast<unsigned*>(carry), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The split walk's slots on the current device: the CUDA blocks of its
// launch shape for V lanes and an m-row profile that the card holds at
// once (SMs times resident blocks per SM), into *slots.
extern "C" int sw_ragged_split_slots(int V, int m, int* slots) {
  if (V % 64) return static_cast<int>(cudaErrorInvalidValue);
  int threads, per_sm, dev, sms;
  size_t shared;
  cudaError_t err =
      hg_launch_shape(sw_ragged_kernel<false, true, true>, V / 2, m,
                      WHOLE_PAIR_WORKERS, &threads, &shared,
                      pair_shared_ints);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sw_ragged_kernel<false, true, true>, threads, shared);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) *slots = per_sm * sms;
  return static_cast<int>(err);
}

extern "C" int sw_ragged_qtile_launch(const void* tiles, const void* row_start,
                                      int n_rows, int V, int jt,
                                      const void* qp, int m, int goe, int ge,
                                      void* ch, void* cf, void* out,
                                      void* stream) {
  return launch_qtile<false>(tiles, row_start, n_rows, V, jt, qp, m, goe, ge,
                             ch, cf, out, stream);
}

// The pair form of kernel 2: V % 64 == 0, ch/cf (T, jt, V / 2) int32 lane
// pairs; the caller keeps the profile and the gaps inside the 16-bit range
// (scorer.pair_form_fits).
extern "C" int sw_ragged_qtile_pairs_launch(const void* tiles,
                                            const void* row_start, int n_rows,
                                            int V, int jt, const void* qp,
                                            int m, int goe, int ge, void* ch,
                                            void* cf, void* out,
                                            void* stream) {
  return launch_qtile<true>(tiles, row_start, n_rows, V, jt, qp, m, goe, ge,
                            ch, cf, out, stream);
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
