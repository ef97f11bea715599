// Strip walk shared by every Smith-Waterman / Gotoh kernel of the package
// (sw_ragged.cu over the whole-DB tile stream, sw_chunk.cu over one
// rectangular chunk).
//
// Layout. A block of the database is one contiguous (npos, V) int8 array:
// npos db positions of V lanes (sequences). One CUDA block per DB block,
// one thread per lane (blockDim.x == V); at each db position the V threads
// read V consecutive bytes, so loads coalesce.
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
// stream laid out like the codes (int32), and the next strip reads them
// back. The same thread writes and reads each carry entry, so no
// synchronisation is needed and the update is in place. The strip's
// 32 x R slice of the profile is staged in shared memory as prof[r][code]
// (conflict-free: equal codes broadcast, different codes hit different
// banks); the whole (32, m) int32 profile would exceed the 227 KB a block
// may use at m = 2048.
//
// Bound on the H100. Per DP cell the recurrence is 11 int32 additions and
// maxima (E: 2 sub + max; H: add + 3 max; F: 2 sub + max; running max).
// sm_90 fuses an addition into a maximum (VIADDMNMX) and takes a maximum
// of three (VIMNMX3), and H - goe serves both E at the next column and F at
// the next row, so the shortest sequence is 5.5 instructions plus one
// shared-memory profile load, 6.5 per cell (this source compiles to about
// two more: it computes H - goe twice and F in three instructions),
// against 1 byte of codes per (db position, lane) read once per strip and
// 8 bytes of carry read and written per strip boundary — at R = 32 that is
// well under a byte per cell, so every kernel built on this walk is bound
// by instruction rate, not by device-memory bandwidth. What it is
// sensitive to is device-memory LATENCY: one dependent load per position
// per thread, with only a few warps per SM to hide it, which the
// one-ahead loads in strip_walk take off the critical path. The design
// keeps every DP value in registers and touches device memory only once
// per strip; 16-bit lanes (two cells per instruction) are left to later
// work.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sw {

constexpr int TABLE_CODES = 32;
constexpr int NEG = -(1 << 28);   // E/F floor: E - ge and F - ge chains
                                  // restart from >= -goe every step, so
                                  // NEG - ge can never wrap
constexpr int STRIP = 32;         // rows per full strip
constexpr int STRIP_TAIL = 8;     // rows per remainder strip (m % 8 == 0)
constexpr int SEG_ROWS = 8;       // rows per segment group of a packed
                                  // multi-query profile

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
// SEG (packed multi-query profile): fcap[g] caps the F entering the first
// row of the strip's g-th 8-row group — NEG where the group starts a new
// segment, so that no gap runs from one query into the next, INT_MAX
// elsewhere (a min, not a branch: a branch every 8 rows would cut the
// unrolled rows into separately scheduled pieces) — and the running
// maximum is kept per group and stored to gmax[R / 8] at the end instead
// of being returned.
template <int R, bool READ, bool WRITE, bool CEIL, bool SEG>
__device__ __forceinline__ int strip_walk(const int8_t* __restrict__ codes,
                                          int64_t npos, int V,
                                          const int* __restrict__ prof,
                                          int goe, int ge, int ceiling,
                                          int* __restrict__ ch,
                                          int* __restrict__ cf, int smax,
                                          const int* fcap, int* gmax) {
  constexpr int G = SEG ? R / SEG_ROWS : 1;
  int h[R], e[R], cap[G], gm[G];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    h[r] = 0;
    e[r] = NEG;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    cap[g] = SEG ? fcap[g] : 0;
    gm[g] = 0;
  }
  int diag_top = 0;                   // H(row above, j - 1)
  // The next position's code and carries are loaded one iteration ahead,
  // before this position's carries are stored: a load started where it is
  // needed would wait out the device-memory latency with nothing left to
  // overlap it (the compiler cannot hoist it itself across the stores).
  int code_next = 0, ch_next = 0, cf_next = NEG;
  if (npos > 0) {
    code_next = codes[0];
    if (READ) {
      ch_next = ch[0];
      cf_next = cf[0];
    }
  }
  for (int64_t p = 0; p < npos; ++p) {
    const int64_t off = p * V;
    const int code = code_next & (TABLE_CODES - 1);
    int f = NEG;                      // F entering the strip's first row
    int diag = diag_top;
    if (READ) {
      diag_top = ch_next;
      f = cf_next;
    }
    if (p + 1 < npos) {
      code_next = codes[off + V];
      if (READ) {
        ch_next = ch[off + V];
        cf_next = cf[off + V];
      }
    }
    const int* __restrict__ col = prof + code;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (SEG && r % SEG_ROWS == 0) f = min(f, cap[r / SEG_ROWS]);
      const int er = max(h[r] - goe, e[r] - ge);
      int hn = max(max(diag + col[r * TABLE_CODES], er), max(f, 0));
      if (CEIL) hn = min(hn, ceiling);
      diag = h[r];
      h[r] = hn;
      e[r] = er;
      if (SEG) {
        gm[r / SEG_ROWS] = max(gm[r / SEG_ROWS], hn);
      } else {
        smax = max(smax, hn);
      }
      f = max(hn - goe, f - ge);
    }
    if (WRITE) {
      ch[off] = h[R - 1];
      cf[off] = f;
    }
  }
  if (SEG) {
#pragma unroll
    for (int g = 0; g < G; ++g) gmax[g] = gm[g];
  }
  return smax;
}

template <int R, bool CEIL, bool SEG>
__device__ __forceinline__ int strip_dispatch(bool rd, bool wr,
                                              const int8_t* codes,
                                              int64_t npos, int V,
                                              const int* prof, int goe,
                                              int ge, int ceiling, int* ch,
                                              int* cf, int smax,
                                              const int* fcap, int* gmax) {
  if (rd && wr)
    return strip_walk<R, true, true, CEIL, SEG>(
        codes, npos, V, prof, goe, ge, ceiling, ch, cf, smax, fcap, gmax);
  if (rd)
    return strip_walk<R, true, false, CEIL, SEG>(
        codes, npos, V, prof, goe, ge, ceiling, ch, cf, smax, fcap, gmax);
  if (wr)
    return strip_walk<R, false, true, CEIL, SEG>(
        codes, npos, V, prof, goe, ge, ceiling, ch, cf, smax, fcap, gmax);
  return strip_walk<R, false, false, CEIL, SEG>(
      codes, npos, V, prof, goe, ge, ceiling, ch, cf, smax, fcap, gmax);
}

// Walk every strip of an m-row query over one block of npos positions.
// codes/ch/cf point at this thread's lane of the block's first position.
// carry_in: the first strip reads the carry; carry_out: the last strip
// writes it. Returns the lane's maximum H.
template <bool CEIL>
__device__ int walk_block(const int8_t* __restrict__ codes, int64_t npos,
                          int V, const int* __restrict__ qp, int m, int goe,
                          int ge, int ceiling, int* ch, int* cf,
                          bool carry_in, bool carry_out) {
  __shared__ int prof[STRIP * TABLE_CODES];
  const int n_full = m / STRIP;
  const int n_tail = (m % STRIP) / STRIP_TAIL;
  const int n_strips = n_full + n_tail;
  int smax = 0;
  for (int s = 0; s < n_strips; ++s) {
    const bool rd = s > 0 || carry_in;
    const bool wr = s < n_strips - 1 || carry_out;
    if (s < n_full) {
      stage_profile<STRIP>(prof, qp, m, s * STRIP);
      smax = strip_dispatch<STRIP, CEIL, false>(rd, wr, codes, npos, V, prof,
                                                goe, ge, ceiling, ch, cf,
                                                smax, nullptr, nullptr);
    } else {
      const int r0 = n_full * STRIP + (s - n_full) * STRIP_TAIL;
      stage_profile<STRIP_TAIL>(prof, qp, m, r0);
      smax = strip_dispatch<STRIP_TAIL, CEIL, false>(rd, wr, codes, npos, V,
                                                     prof, goe, ge, ceiling,
                                                     ch, cf, smax, nullptr,
                                                     nullptr);
    }
  }
  return smax;
}

}  // namespace sw
