// Layout, recurrence and constants shared by the package's five
// Smith-Waterman / Gotoh kernels (sw_ragged.cu, sw_chunk.cu). Every kernel
// runs the walk of sw_walk_hg.cuh, which builds on what is set out here.
//
// Layout. A block of the database is one contiguous (npos, V) int8 array:
// npos db positions of V lanes (sequences). A CUDA block takes one DB
// block, with one thread per lane in each of its workers; at each db
// position the V threads of a worker read V consecutive bytes, so loads
// coalesce.
//
// Recurrence (int32 throughout; gap of length k costs open + k * extend):
//   E(i,j) = max(H(i,j-1) - goe, E(i,j-1) - ge)
//   F(i,j) = max(H(i-1,j) - goe, F(i-1,j) - ge)
//   H(i,j) = max(0, H(i-1,j-1) + S(q_i, d_j), E(i,j), F(i,j))
// A thread walks its lane's F chain down the query rows sequentially, so
// the TPU design's two-pass exclusive-cummax F, its ramped state and its
// one-hot MXU profile matmul are all unnecessary here.
//
// Strip-mining. The query is cut into strips of R rows (STRIP = 32, then
// STRIP_TAIL = 8 for the remainder; m % 8 == 0). A strip's H and E live in
// registers while a worker sweeps the block's db positions; the strip's
// bottom row goes to the strip below (through shared memory or a stream in
// device memory laid out like the codes). The strip's 32 x R slice of the
// profile is staged in shared memory as prof[r][code] (conflict-free:
// equal codes broadcast, different codes hit different banks); the whole
// (32, m) int32 profile would exceed the 227 KB a block may use at
// m = 2048.
//
// Bound on the H100. Per DP cell the recurrence is 11 int32 additions and
// maxima (E: 2 sub + max; H: add + 3 max; F: 2 sub + max; running max).
// sm_90 fuses an addition into a maximum (VIADDMNMX) and takes a maximum
// of three (VIMNMX3), and H - goe serves both E at the next column and F at
// the next row, so the shortest sequence is 5.5 instructions plus one
// shared-memory profile load, 6.5 per cell, against 1 byte of codes per
// (db position, lane) read once per strip and 8 bytes of boundary row read
// and written per strip boundary — at R = 32 that is well under a byte per
// cell, so every kernel is bound by instruction rate, not by device-memory
// bandwidth. What it is sensitive to is device-memory LATENCY (one
// dependent load per position per thread) and the latency between
// dependent instructions: sw_walk_hg.cuh says how its walk meets both.
// Kernels 1 and 2 also run in 16-bit lane pairs, two cells per
// instruction (sw_walk_hg.cuh, the pair form); the other kernels keep
// int32 lanes.

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

}  // namespace sw
