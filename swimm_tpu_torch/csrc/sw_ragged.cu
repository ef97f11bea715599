// Exact Smith-Waterman / Gotoh scores over the whole-DB ragged tile stream.
//
// Two kernels share one strip walk (strip_walk below):
//
//   sw_ragged_kernel        replaces swimm_tpu/ops/pallas_scorer.py
//                           _dp_ragged_kernel (via score_tiles): a query of
//                           at most 2048 padded rows against every block.
//   sw_ragged_qtile_kernel  replaces swimm_tpu/ops/longquery.py
//                           _dp_ragged_tile_kernel (via _score_tiles_one_qtile):
//                           one query tile of a long query, with the H/F
//                           boundary rows carried in and out through device
//                           memory.
//
// Layout. tiles is (T, jt, V) int8, block-major: the tiles of one block
// (one output row) are consecutive, so a block's codes are one contiguous
// (npos, V) array with npos = n_tiles * jt. One CUDA block per DB block,
// one thread per lane (blockDim.x == V); at each db position the V threads
// read V consecutive bytes, so loads coalesce. Each CUDA block finds its
// tile range in row_start (n_rows + 1 entries, computed once per DB by the
// wrapper) — the TPU kernel's scalar-prefetched outrow map is not needed.
//
// Recurrence (int32 throughout; gap of length k costs open + k * extend):
//   E(i,j) = max(H(i,j-1) - goe, E(i,j-1) - ge)
//   F(i,j) = max(H(i-1,j) - goe, F(i-1,j) - ge)
//   H(i,j) = max(0, H(i-1,j-1) + S(q_i, d_j), E(i,j), F(i,j))
// A thread walks its lane's F chain down the query rows sequentially, so
// the TPU design's two-pass exclusive-cummax F, its ramped state and its
// one-hot MXU profile matmul are all unnecessary here.
//
// Strip-mining. The query is cut into strips of R rows (32, then 8 for the
// remainder; m % 8 == 0). A strip's H and E live in registers while the
// thread sweeps the block's whole db length; the strip's bottom-row H and
// the F entering the next row are written per db position to a carry
// stream laid out like tiles (int32), and the next strip reads them back.
// The same thread writes and reads each carry entry, so no synchronisation
// is needed and the update is in place. The strip's 32 x R slice of the
// profile is staged in shared memory as prof[r][code] (conflict-free: equal
// codes broadcast, different codes hit different banks); the whole (32, m)
// int32 profile would exceed the 227 KB a block may use at m = 2048.
//
// Long queries. sw_ragged_qtile_kernel is the same walk with the carries
// read at the tile's first strip and written at its last. Unlike the TPU
// kernel, which carries a global-ramp column cummax ("gcar"), this port
// carries real bottom-row H and real F into the next row; the carries are
// internal to score_tiles_long, whose contract is its output. At a block's
// first db position the H boundary is 0 and E starts at NEG.
//
// Bound on the H100. Per DP cell the walk issues about 11 int32 ALU
// operations (E: 2 sub + max; H: add + 3 max; F: 2 sub + max; running max)
// plus one shared-memory profile load, against 1 byte of tiles per
// (db position, lane) read once per strip and 8 bytes of carry read and
// written per strip boundary — at R = 32 that is well under a byte per
// cell, so the kernel is bound by integer issue, not by device memory.
// The design keeps every DP value in registers and touches device memory
// only once per strip; making the integer work cheaper (DPX
// __viaddmax_s32 / __vimax3_s32, 16-bit lanes) is left to later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TABLE_CODES = 32;
constexpr int NEG = -(1 << 28);   // E/F floor: E - ge and F - ge chains
                                  // restart from >= -goe every step, so
                                  // NEG - ge can never wrap
constexpr int STRIP = 32;         // rows per full strip
constexpr int STRIP_TAIL = 8;     // rows per remainder strip (m % 8 == 0)

// Stage profile rows [r0, r0 + R) as prof[r * 32 + code].
template <int R>
__device__ __forceinline__ void stage_profile(int* __restrict__ prof,
                                              const int* __restrict__ qp,
                                              int m, int r0) {
  __syncthreads();                    // previous strip done reading prof
  for (int idx = threadIdx.x; idx < R * TABLE_CODES; idx += blockDim.x) {
    const int r = idx / TABLE_CODES;
    const int c = idx % TABLE_CODES;
    prof[idx] = qp[(int64_t)c * m + r0 + r];
  }
  __syncthreads();
}

// Sweep one strip of R query rows over a block's npos db positions for
// lane v. codes/ch/cf point at the block's first position (stride V).
// READ: the row above comes from the carry (else H = 0, F = NEG).
// WRITE: store the strip's bottom-row H and the F entering the next row.
template <int R, bool READ, bool WRITE, bool CEIL>
__device__ __forceinline__ int strip_walk(const int8_t* __restrict__ codes,
                                          int64_t npos, int V,
                                          const int* __restrict__ prof,
                                          int goe, int ge, int ceiling,
                                          int* __restrict__ ch,
                                          int* __restrict__ cf, int smax) {
  int h[R], e[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    h[r] = 0;
    e[r] = NEG;
  }
  int diag_top = 0;                   // H(row above, j - 1)
  for (int64_t p = 0; p < npos; ++p) {
    const int64_t off = p * V;
    const int code = codes[off] & (TABLE_CODES - 1);
    int f = NEG;                      // F entering the strip's first row
    int diag = diag_top;
    if (READ) {
      diag_top = ch[off];
      f = cf[off];
    }
    const int* __restrict__ col = prof + code;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int er = max(h[r] - goe, e[r] - ge);
      int hn = max(max(diag + col[r * TABLE_CODES], er), max(f, 0));
      if (CEIL) hn = min(hn, ceiling);
      diag = h[r];
      h[r] = hn;
      e[r] = er;
      smax = max(smax, hn);
      f = max(hn - goe, f - ge);
    }
    if (WRITE) {
      ch[off] = h[R - 1];
      cf[off] = f;
    }
  }
  return smax;
}

template <int R, bool CEIL>
__device__ __forceinline__ int strip_dispatch(bool rd, bool wr,
                                              const int8_t* codes,
                                              int64_t npos, int V,
                                              const int* prof, int goe,
                                              int ge, int ceiling, int* ch,
                                              int* cf, int smax) {
  if (rd && wr)
    return strip_walk<R, true, true, CEIL>(codes, npos, V, prof, goe, ge,
                                           ceiling, ch, cf, smax);
  if (rd)
    return strip_walk<R, true, false, CEIL>(codes, npos, V, prof, goe, ge,
                                            ceiling, ch, cf, smax);
  if (wr)
    return strip_walk<R, false, true, CEIL>(codes, npos, V, prof, goe, ge,
                                            ceiling, ch, cf, smax);
  return strip_walk<R, false, false, CEIL>(codes, npos, V, prof, goe, ge,
                                           ceiling, ch, cf, smax);
}

// Walk every strip of an m-row query over one block. carry_in: the first
// strip reads the carry; carry_out: the last strip writes it.
template <bool CEIL>
__device__ int walk_block(const int8_t* __restrict__ tiles,
                          const int64_t* __restrict__ row_start, int V,
                          int jt, const int* __restrict__ qp, int m, int goe,
                          int ge, int ceiling, int* ch, int* cf,
                          bool carry_in, bool carry_out) {
  __shared__ int prof[STRIP * TABLE_CODES];
  const int row = blockIdx.x;
  const int v = threadIdx.x;
  const int64_t t0 = row_start[row];
  const int64_t npos = (row_start[row + 1] - t0) * jt;
  const int64_t base = t0 * jt * V + v;
  const int8_t* codes = tiles + base;
  int* chb = ch ? ch + base : nullptr;
  int* cfb = cf ? cf + base : nullptr;

  const int n_full = m / STRIP;
  const int n_tail = (m % STRIP) / STRIP_TAIL;
  const int n_strips = n_full + n_tail;
  int smax = 0;
  for (int s = 0; s < n_strips; ++s) {
    const bool rd = s > 0 || carry_in;
    const bool wr = s < n_strips - 1 || carry_out;
    if (s < n_full) {
      stage_profile<STRIP>(prof, qp, m, s * STRIP);
      smax = strip_dispatch<STRIP, CEIL>(rd, wr, codes, npos, V, prof, goe,
                                         ge, ceiling, chb, cfb, smax);
    } else {
      const int r0 = n_full * STRIP + (s - n_full) * STRIP_TAIL;
      stage_profile<STRIP_TAIL>(prof, qp, m, r0);
      smax = strip_dispatch<STRIP_TAIL, CEIL>(rd, wr, codes, npos, V, prof,
                                              goe, ge, ceiling, chb, cfb,
                                              smax);
    }
  }
  return smax;
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
  const int smax =
      has_ceiling
          ? walk_block<true>(tiles, row_start, V, jt, qp, m, goe, ge,
                             ceiling, ch, cf, false, false)
          : walk_block<false>(tiles, row_start, V, jt, qp, m, goe, ge, 0, ch,
                              cf, false, false);
  out[(int64_t)blockIdx.x * V + threadIdx.x] = smax;
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
  const int smax = walk_block<false>(tiles, row_start, V, jt, qp, m, goe, ge,
                                     0, ch, cf, true, true);
  out[(int64_t)blockIdx.x * V + threadIdx.x] = smax;
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
