// Exact Smith-Waterman / Gotoh scores of one query against one rectangular
// chunk of the packed database: codes (B, L, V) int8, B blocks of V lanes,
// every block padded to the same L db positions.
//
// Two kernels share the strip walk of sw_walk.cuh (recurrence,
// strip-mining and the bound on the card are described there):
//
//   sw_chunk_kernel        replaces swimm_tpu/ops/pallas_scorer.py
//                          _dp_kernel (via score_chunk): a query of at most
//                          2048 padded rows, optional saturating ceiling.
//   sw_chunk_qtile_kernel  replaces swimm_tpu/ops/longquery.py
//                          _dp_tile_kernel (via _score_tile, driven by
//                          score_chunk_long): one query tile of a long
//                          query, with the H/F boundary rows carried in and
//                          out through two (B, L, V) int32 streams.
//
// The TPU kernels run a (B, L / jt) grid in order and keep the DP state of
// one block in scratch memory from one grid step to the next; here one
// CUDA block owns one chunk block b and loops over its L positions, one
// thread per lane, so the grid is (B) and nothing crosses CUDA blocks. The
// TPU's lanes_per_block regrouping of the lane axis and its jt_steps tile
// height have no counterpart: a lane is a thread whatever V is. As in
// sw_ragged.cu the carries hold real bottom-row H and the real F entering
// the next row (int32), not the TPU's float32 global-ramp cummax; they are
// internal to score_chunk_long, whose contract is its output.
//
// Both kernels do the integer work of the ragged kernels per DP cell and
// are bound by instruction rate like them; a chunk of few blocks leaves
// most of the card's SMs idle, which the whole-DB stream kernels avoid by
// taking every block of every chunk in one launch.

#include "sw_walk.cuh"

namespace {

using namespace sw;

// Kernel 4: whole query against chunk block blockIdx.x. ch/cf are scratch
// shaped like codes (unused when m fits one strip).
__global__ void sw_chunk_kernel(const int8_t* __restrict__ codes, int L,
                                int V, const int* __restrict__ qp, int m,
                                int goe, int ge, int has_ceiling,
                                int ceiling, int* ch, int* cf,
                                int* __restrict__ out) {
  const int64_t base = (int64_t)blockIdx.x * L * V + threadIdx.x;
  int* chb = ch ? ch + base : nullptr;
  int* cfb = cf ? cf + base : nullptr;
  const int smax =
      has_ceiling
          ? walk_block<true>(codes + base, L, V, qp, m, goe, ge, ceiling,
                             chb, cfb, false, false)
          : walk_block<false>(codes + base, L, V, qp, m, goe, ge, 0, chb,
                              cfb, false, false);
  out[(int64_t)blockIdx.x * V + threadIdx.x] = smax;
}

// Kernel 5: one query tile against chunk block blockIdx.x; ch/cf (B, L, V)
// hold the row above the tile on entry (H bottom row, F into the first
// row) and the tile's own bottom row on exit (updated in place).
__global__ void sw_chunk_qtile_kernel(const int8_t* __restrict__ codes,
                                      int L, int V,
                                      const int* __restrict__ qp, int m,
                                      int goe, int ge, int* ch, int* cf,
                                      int* __restrict__ out) {
  const int64_t base = (int64_t)blockIdx.x * L * V + threadIdx.x;
  const int smax = walk_block<false>(codes + base, L, V, qp, m, goe, ge, 0,
                                     ch + base, cf + base, true, true);
  out[(int64_t)blockIdx.x * V + threadIdx.x] = smax;
}

}  // namespace

extern "C" int sw_chunk_launch(const void* codes, int B, int L, int V,
                               const void* qp, int m, int goe, int ge,
                               int has_ceiling, int ceiling, void* ch,
                               void* cf, void* out, void* stream) {
  if (B > 0) {
    sw_chunk_kernel<<<B, V, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(codes), L, V, static_cast<const int*>(qp),
        m, goe, ge, has_ceiling, ceiling, static_cast<int*>(ch),
        static_cast<int*>(cf), static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sw_chunk_qtile_launch(const void* codes, int B, int L, int V,
                                     const void* qp, int m, int goe, int ge,
                                     void* ch, void* cf, void* out,
                                     void* stream) {
  if (B > 0) {
    sw_chunk_qtile_kernel<<<B, V, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(codes), L, V, static_cast<const int*>(qp),
        m, goe, ge, static_cast<int*>(ch), static_cast<int*>(cf),
        static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
