// Exact Smith-Waterman / Gotoh scores of one query against rectangular
// chunks of the packed database: codes (B, L, V) int8, B blocks of V lanes,
// every block padded to the same L db positions.
//
// Two kernels, both on the walk of sw_walk_hg.cuh (layout, recurrence and
// the bound on the card in sw_walk.cuh):
//
//   sw_chunk_kernel        replaces swimm_tpu/ops/pallas_scorer.py
//                          _dp_kernel (via score_chunk): a query of at most
//                          2048 padded rows, optional saturating ceiling,
//                          against a LIST of chunks (two workers to a
//                          block).
//   sw_chunk_qtile_kernel  replaces swimm_tpu/ops/longquery.py
//                          _dp_tile_kernel (via _score_tile, driven by
//                          score_chunk_long): one query tile of a long
//                          query against a LIST of chunks, with the H/F
//                          boundary rows carried in and out through two
//                          int32 streams shaped like each chunk's codes, on
//                          the carry form of the walk (four workers to a
//                          block, as sw_ragged_qtile_kernel).
//
// The TPU kernels run a (B, L / jt) grid in order and keep the DP state of
// one block in scratch memory from one grid step to the next; here one
// CUDA block owns one chunk block b and loops over its L positions, and
// nothing crosses CUDA blocks. The TPU's lanes_per_block regrouping of the
// lane axis and its jt_steps tile height have no counterpart: a lane is a
// thread of each worker whatever V is. As in sw_ragged.cu the carries hold
// real bottom-row H and the real F entering the next row (int32), not the
// TPU's float32 global-ramp cummax; they are internal to score_chunk_long,
// whose contract is its output.
//
// Both kernels do the integer work of the ragged kernels per DP cell and
// are bound by instruction rate like them. What bounded both on the card
// at first was not the walk but their launches: one grid of B blocks per
// chunk (and query tile), one after another on one stream, and the tail of
// a length-sorted DB is chunks of one to three blocks, each of which held
// 1-3 of the card's 132 SMs while every other chunk waited (55 launches
// for a 448-row query over a 570,000-sequence DB took 287 ms, eight times
// the stream kernel's time for the same cells; NVIDIA H100 80GB HBM3, 700
// W). So each kernel takes a device table of chunk descriptors (ChunkDesc:
// the ADDRESSES of a chunk's codes, carries and output, its B and its L --
// a chunk is any contiguous tensor, and a list of chunks need not be one
// allocation) and a map from CUDA block to (chunk, block within the
// chunk), longest L first, so that the long blocks start at once and the
// short ones fill in behind them: one launch over every block of every
// chunk, the grid of the whole-DB stream kernels. One CUDA block still
// owns one (chunk, b). codes0 is the lowest codes address of the list, and
// each chunk's codes are addressed from it: only from a const __restrict__
// kernel parameter does the compiler learn that the walk's loads of the
// codes never alias its carry stores. On the strip walk, with the address
// taken from the descriptor alone, the query-tile kernel compiled to 95
// registers, not 114, and took 121 ms, not 96, for a 1024-row tile over
// that DB. On the carry form of the hg walk it takes 74.5 ms, as
// sw_ragged_qtile_kernel does for the same cells (75.2 ms; PERF.md
// section 6).

#include "sw_walk_hg.cuh"

namespace {

using namespace sw;

// One chunk of a list, as the kernel sees it (a row of six int64 in the
// table the wrapper uploads).
struct ChunkDesc {
  const int8_t* codes;   // (B, L, V) int8
  int* ch;               // kernel 5: (B, L, V) int32 carry, bottom-row H;
                         // kernel 4: (B, L, V) int2 (hg, F) strip scratch,
                         // or null when every strip has a worker of its own
  int* cf;               // kernel 5: (B, L, V) int32 carry, F entering the
                         // next row; kernel 4: unused, null
  int* out;              // (B, V) int32 scores
  int64_t B;
  int64_t L;
};

// Kernel 4: whole query against block block_map[blockIdx.x] = (chunk, b)
// of a list of chunks, optional saturating ceiling: two kernels chosen by
// the launcher, as sw_ragged_kernel, whose walk, workers and thread limit
// it shares.
template <bool CEIL>
__global__ void __launch_bounds__(HG_MAX_THREADS, 1)
sw_chunk_kernel(const int8_t* __restrict__ codes0,
                const ChunkDesc* __restrict__ desc,
                const int2* __restrict__ block_map, int V,
                const int* __restrict__ qp, int m, int goe, int ge,
                int ceiling) {
  extern __shared__ int smem[];
  const int2 cb = block_map[blockIdx.x];
  const ChunkDesc d = desc[cb.x];
  const int64_t base = (int64_t)cb.y * d.L * V;
  int2* carry = d.ch ? reinterpret_cast<int2*>(d.ch) + base : nullptr;
  const int smax = hg_walk_block<CEIL, false>(
      codes0 + (d.codes - codes0) + base, static_cast<int>(d.L), V, qp, m,
      goe, ge, ceiling, carry, smem, PackedPlanes{});
  if (threadIdx.x < V) d.out[(int64_t)cb.y * V + threadIdx.x] = smax;
}

// Kernel 5: one query tile against block block_map[blockIdx.x] = (chunk,
// b) of a list of chunks, on the carry form of the walk, as
// sw_ragged_qtile_kernel, whose workers (QTILE_WORKERS) and thread limit it
// shares; the chunk's ch/cf hold the row above the tile on entry (real H of
// its bottom row, the F entering its first row) and the tile's own bottom
// row on exit, updated in place. They may alias each other's reads and
// writes inside the walk, so neither is __restrict__.
__global__ void __launch_bounds__(HG_MAX_THREADS, 1)
sw_chunk_qtile_kernel(const int8_t* __restrict__ codes0,
                      const ChunkDesc* __restrict__ desc,
                      const int2* __restrict__ block_map, int V,
                      const int* __restrict__ qp, int m, int goe, int ge) {
  extern __shared__ int smem[];
  const int2 cb = block_map[blockIdx.x];
  const ChunkDesc d = desc[cb.x];
  const int64_t base = (int64_t)cb.y * d.L * V;
  const int smax = hg_walk_block<false, false>(
      codes0 + (d.codes - codes0) + base, static_cast<int>(d.L), V, qp, m,
      goe, ge, 0, HRows{d.ch + base, d.cf + base}, smem, PackedPlanes{});
  if (threadIdx.x < V) d.out[(int64_t)cb.y * V + threadIdx.x] = smax;
}

template <bool CEIL>
int launch_chunks(const void* codes0, const void* desc, const void* block_map,
                  int n_blocks, int V, const void* qp, int m, int goe, int ge,
                  int ceiling, void* stream) {
  int threads;
  size_t shared;
  const cudaError_t err =
      hg_launch_shape(sw_chunk_kernel<CEIL>, V, m, HG_MAX_WORKERS,
                      &threads, &shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  sw_chunk_kernel<CEIL><<<n_blocks, threads, shared,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes0), static_cast<const ChunkDesc*>(desc),
      static_cast<const int2*>(block_map), V, static_cast<const int*>(qp), m,
      goe, ge, ceiling);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sw_chunk_launch(const void* codes0, const void* desc,
                               const void* block_map, int n_blocks, int V,
                               const void* qp, int m, int goe, int ge,
                               int has_ceiling, int ceiling, void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaGetLastError());
  return has_ceiling
             ? launch_chunks<true>(codes0, desc, block_map, n_blocks, V, qp,
                                   m, goe, ge, ceiling, stream)
             : launch_chunks<false>(codes0, desc, block_map, n_blocks, V, qp,
                                    m, goe, ge, 0, stream);
}

extern "C" int sw_chunk_qtile_launch(const void* codes0, const void* desc,
                                     const void* block_map, int n_blocks,
                                     int V, const void* qp, int m, int goe,
                                     int ge, void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaGetLastError());
  int threads;
  size_t shared;
  const cudaError_t err = hg_launch_shape(sw_chunk_qtile_kernel, V, m,
                                          QTILE_WORKERS, &threads, &shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  sw_chunk_qtile_kernel<<<n_blocks, threads, shared,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes0), static_cast<const ChunkDesc*>(desc),
      static_cast<const int2*>(block_map), V, static_cast<const int*>(qp), m,
      goe, ge);
  return static_cast<int>(cudaGetLastError());
}
