// The walk of all five kernels, which score a profile on cooperating
// workers per DB block: sw_ragged_kernel (in int32 lanes, and in the pair
// form below) and sw_ragged_packed_kernel
// (sw_ragged.cu; they replace swimm_tpu/ops/pallas_scorer.py
// _dp_ragged_kernel via score_tiles and _dp_packed_kernel via
// score_tiles_packed), sw_chunk_kernel (sw_chunk.cu; _dp_kernel via
// score_chunk), and in the carry form below sw_ragged_qtile_kernel
// (sw_ragged.cu; swimm_tpu/ops/longquery.py _dp_ragged_tile_kernel via
// _score_tiles_one_qtile) and sw_chunk_qtile_kernel (sw_chunk.cu;
// _dp_tile_kernel via _score_tile). It is the recurrence of sw_walk.cuh,
// rewritten for what bounds it on an H100. The measurements below compare
// it with "the strip walk": one worker (V threads) per DB block, its code
// and carries loaded one position ahead (PERF.md section 6).
//
// What bounds it. Measured on an NVIDIA H100 80GB HBM3 at 700 W: VIADDMNMX
// and VIMNMX3 start at 62 thread-instructions per clock per SM, half of
// what the schedulers can start, VIMNMX at 119, and all three share one
// pipe; additions go elsewhere and overlap them. A warp starts its
// instructions in order, so a lone warp of the strip walk
// advanced one row in ~34 clocks: its F chain is three to four dependent
// instructions per row (H, H - goe, max, F - ge). Sixteen warps per SM hid
// only half of that, and the longest DB block, walked by four warps from
// start to end, took two thirds of the whole launch on its own. The
// kernel is bound by the latency between dependent instructions and by
// the half-rate pipe, not by device memory: 43 GB of carries per launch
// cost a tenth of its time.
//
// The recurrence. The registers hold hg = H - goe, not H: it is what E at
// the next column and F at the next row read. The strip's profile is
// staged with goe already added, so the diagonal term is still one
// addition: (H(i-1,j-1) - goe) + (S + goe) = H(i-1,j-1) + S. H = 0 on the
// row and the column before the matrix is hg = -goe. With
//   t0 = max(H(i-1,j-1) + S, E, 0)      (H without its F term)
// and gap_open >= 0 (so F - goe <= F - ge), F's own recurrence needs no H:
//   F(i+1,j) = max(H - goe, F - ge) = max(t0 - goe, F - ge),
// one instruction per row on the chain; everything else hangs off it:
//   en  = __viaddmax_s32(e, -ge, hg_left)            E        VIADDMNMX
//   t0  = __viaddmax_s32_relu(hg_diag, S + goe, en)           VIADDMNMX.RELU
//   t0g = t0 - goe                                            VIADD
//   hg  = __viaddmax_s32(f, -goe, t0g)               H - goe  VIADDMNMX
//   f   = __viaddmax_s32(f, -ge, t0g)                F below  VIADDMNMX
//   smax = __vimax3_s32(smax, t0, t0')               2 rows   VIMNMX3
// and one shared-memory load: 6.5 instructions per cell, the count of the
// bound. The running maximum is of t0, not of H: an H that comes from F is
// below the H its gap opened from. The ceiling clamps t0 (F <= ceiling -
// goe follows), one more instruction per cell, in a kernel of its own.
// Writing hg as max(t0, f) - goe (two full-rate instructions for one
// half-rate) was 4% slower: instruction slots weigh more than the pipe.
//
// The packed form (PACKED: a profile of several queries one under the
// other, sw_ragged.cu tells the layout) differs in two places. The F that
// enters the first row of an 8-row group is capped, f = min(f, cap[g]),
// with cap[g] = NEG where the group starts a new segment and INT_MAX
// elsewhere, so that no gap runs from one query into the next: a min on the
// chain's input, one instruction per 8 rows, not a branch (a branch every 8
// rows would cut the unrolled rows into separately scheduled pieces). Row 0
// of a strip is a group start, so the cap also meets the F that arrives
// from the worker above through the ring or the carry stream. And the
// running maximum is kept per group, gm[g] = max(gm[g], t0, t0'), the same
// count of instructions. It is still a maximum of t0 and still exact for
// every query: an H that comes from F is no higher than the H its gap
// opened from, and with F capped at every segment start that H lies in the
// same segment, so in the same score plane. The staged profile holds
// SEP_SCORE + goe in separator rows, still far below any DP value, so they
// come out as t0 = 0, hg = -goe, and the next query's first row sees the
// boundary of a query run alone; gap_open = 0 and gap_extend = 0 included.
// When a worker finishes a strip it folds the strip's group maxima into
// the planes (fold_groups).
//
// Cooperating workers. A CUDA block of S * V threads takes one DB block;
// worker k (V threads, one per lane) takes strips k, k + S, ... and runs one
// step of D db positions behind worker k - 1, which hands it the strip's
// bottom row (hg, and the F entering the next row) through a two-slot ring
// in shared memory; only the last worker's bottom row goes to the carry
// stream in device memory, from where worker 0 reads it a round later, so
// those bytes fall by S and a long block is walked by S times the warps.
// All workers step together: one __syncthreads per D positions (every
// producer-consumer pair is one step apart, so two slots per boundary are
// enough). Worker k works item i = t - k at step t; an item is (round,
// step within the round), a round lasts max(ceil(npos / D), S) steps so
// that worker 0 never reads a carry that the last worker has not written.
// With S == 1 a strip is one step of npos positions and nothing
// synchronises but the staging of the profile.
//
// The carry form (a Carry of type HRows: sw_ragged_qtile_kernel and
// sw_chunk_qtile_kernel) walks one query tile of a longer query, whose
// interface is the row above the tile and the tile's own bottom row, as
// real H and the F entering the next row in two int32 streams (ch, cf)
// laid out like the codes, updated in place.
// Every boundary it keeps in device memory is that pair of streams: the
// first strip reads the row above the tile from them, the last strip
// (whichever worker holds it) writes the tile's bottom row into them, and
// the last worker of a round hands its bottom row to worker 0 of the next
// round through them too, so the walk needs no scratch. The ring holds the
// same real-H form (hg + goe stored, H - goe loaded: one addition each per
// db position and strip), so one code path serves both kinds of boundary.
// The in-place hand-off is safe under the lock step: worker 0 reads chunk c
// of a round at step round * P + c, the last worker writes it at round * P
// + c + S - 1, the next round reads it at (round + 1) * P + c >= round * P
// + c + S (P >= S), and a barrier ends every step; where one thread both
// reads and writes a position (S == 1, or worker 0 holding the last
// strip), its load runs HG_AHEAD positions ahead of the store. As the two
// pointers may alias, neither is __restrict__; the codes are addressed
// from the kernel's const __restrict__ parameter (kernel 5 re-bases a
// chunk's codes on it). The carries come out exact: H = hg + goe =
// max(t0, F), and F below = max(t0 - goe, F - ge) = max(H - goe, F - ge)
// for gap_open >= 0. The per-tile maximum is not the
// maximum of t0 there: F also enters from the carry, an H that comes from
// it is an H of this tile's rows, and it need not lie below any t0 of the
// tile. So the carry form keeps the maximum of hg = H - goe itself, one
// VIMNMX3 per two rows as before, and adds goe at the end.
//
// The carry form also reads each code byte unsigned. Read as int8_t (from
// the const __restrict__ parameter), the byte comes in by LDG.E.U8.CONSTANT
// and ptxas places the PRMT that sign-extends it a few instructions after
// the load, so every position waits out the load's latency and the loads
// ahead gain nothing; read as uint8_t the load itself widens it, and the
// code's low five bits, all the walk uses, are the same. Kernel 1's int32
// form and kernel 3 still read it signed and wait (PERF.md §6: ~11% of
// their time; kernel 1's pair form loads a 16-bit code word, which needs
// no widening);
// kernel 4, whose codes address is re-based from a table, gets a plain
// LDG.E.S8, which needs no PRMT, and kernel 5, re-based the same way, a
// plain LDG.E.U8.
//
// S, D and the rest, by measurement on that card (whole-DB stream of
// 50,873 tiles, m = 448; the strip walk: 51.8 ms): S = 1 40.4 ms,
// S = 2 35.6, S = 4 41.5 (14 strips leave two of 16 worker slots idle, and
// a 512-thread block leaves no second block on the SM); D = 16 37.9, D = 32
// 35.6, D = 48 35.9; loads 1, 2, 4 positions ahead 37.2 (before the last
// change to the recurrence), 35.6, 37.9 (registers); 16-row strips (64
// registers, twice the warps) 41.9 with S = 4 and 77.7 with S = 1, where
// the doubled carry traffic does bind. 120-128 registers under
// __launch_bounds__(512, 1): two blocks of 256 threads per SM. The carry
// form (a 1024-row tile, 32 strips, over the whole-DB stream; the strip
// walk: 88.7 ms; tools/walk_variants.py): code bytes signed 84.4 ms
// at S = 2, 85.1 at S = 4; unsigned 75.4 at S = 2, 75.2 at S = 4 (eight
// full rounds), so four workers; the incoming F folded into a maximum of
// t0 in place of the maximum of hg 75.4 (one VIMNMX more per position and
// strip); 123 registers. Kernel 5 on the carry form (the next 1024-row
// tile over the 55 chunks of that DB, one launch; the strip walk: 96.8 ms;
// tools/qtile_variants.py, in turns): 74.5 ms at S = 4, 74.5 at S = 2
// (0.1% faster, within its spread from round to round) while kernel 2
// runs 0.2% slower at S = 2; kernel 2 runs over twenty times as often on
// the main paths, so both keep four workers. 126 registers, no spills.

// The pair form (kernel 2's sw_ragged_qtile_kernel<true>, and kernel 1's
// sw_ragged_kernel<false, true> below) runs the carry form's recurrence in
// 16-bit lane pairs: thread u of a worker holds
// lanes 2u and 2u + 1 in the two halves of every register (hg, e, f, the
// diagonal, the running maximum), so a worker is V / 2 threads, one 16-bit
// load a position brings both lanes' codes, and sm_90's .S16x2 add-max
// forms do two cells an instruction. The staged profile holds S + goe in
// both halves of a word; the pair's entry is lane 2u's word's low half and
// lane 2u + 1's high half, one LOP3 (two 16-bit loads and a PRMT, or a
// table per half, measured no faster). A row for two cells is
//   en  = __viaddmax_s16x2_relu(e, -ge, hg)          E, kept >= 0
//   t0g = __vadd2(__viaddmax_s16x2_relu(diag, S2, en), -goe)
//   hg  = __viaddmax_s16x2(f, -goe, t0g);  f = __viaddmax_s16x2(f, -ge, t0g)
//   gm  = __vimax3_s16x2(gm, hg, hg')                 2 rows
// with __vadd2 of a constant one VIADD, off the half-rate pipe: 2.9
// half-rate instructions a cell by the SASS (roofline.walk_sass_per_cell,
// lanes=2) against the int32 form's 4.8. The carries are lane pairs too,
// (T, jt, V / 2) int32 for H and for F: 4 bytes per (db position, lane)
// against 8. The position loop is unrolled by two, which spares the moves
// that carry hg into the next position's diagonal (0.77 → 0.62 IMAD a
// cell, 127 registers and no spills against 128 and 12 bytes). Measured
// (NVIDIA H100 80GB HBM3, 700 W; one 1,024-row tile over the 50,865-tile
// stream, tools/qtile_variants.py in turns with the parent): int32 form
// 75.16 ms; pair form 53.98 (goe subtracted by a VIADDMNMX), 50.03 (by
// __vadd2), 48.60 (and unrolled by two); two workers 49.68, 49.17 unrolled;
// lock steps of 16 positions 0.6% slower; loads one position ahead 2%
// slower; the join by PRMT or from a 16-bit table no faster.
//
// Kernel 1 in the pair form (WHOLE) walks a whole query, not a tile of
// one. Its first row has no row above: H = 0 and no F, which the first
// strip takes as constants (H = 0 and F = -goe, the pair form's "no F",
// since t0 >= 0) and not from a carry stream: they are exactly the carries
// a fresh first tile of kernel 2 reads, so the two kernels run one
// recurrence. Its last strip writes no row below (nothing follows the
// query). Device memory then holds only the hand-off from the last worker
// of a round to worker 0 of the next: two (T, jt, V / 2) int32 streams of
// lane pairs, H and F, 4 bytes per (db position, lane) against the int32
// form's 8, and none for a one-strip profile (m <= 32). The tests for a
// missing row cost 3.01 half-rate instructions a cell against kernel 2's
// 2.91. Measured (NVIDIA H100 80GB HBM3, 700 W; tools/qtile_variants.py in
// turns with the parent; query 0, m = 448): the whole 50,865-tile stream
// 35.72 ms in the int32 form, 22.54 in the pair form with four workers of
// 64 threads, 22.08 with two; the stream's last 8,192-tile window, its
// longest blocks, 17.05, 9.54 and 12.35 ms. Four workers: two leave no
// worker slot idle at 14 strips, but four walk a long block on twice the
// warps, and the streamed search spends a third of a batch in its last
// window (PERF.md §5). Interior strips on kernel 2's step (no tests): 2.88
// a cell, 22.31 ms, but 9.99 ms on the last window (128 registers); not
// taken.
//
// Why the pair form is exact, and where it stops. .S16x2 additions wrap.
// Every quantity of a lane is bounded by its H: hg = H - goe >= -goe,
// E in [0, H - goe] (clamped at 0: t0 = max(diag, E, 0) is unchanged),
// F >= -goe (after a row; the first tile's F enters as -goe, which acts
// as no F since t0 >= 0), t0 in [0, H]. So every addition but two only
// lowers a value that is at least -goe, and stays >= -2 goe >= -32,768
// while 2 goe <= 32,768 (e - ge, f - goe, f - ge, t0 - goe, H - goe);
// hg + goe, to the carries and the ring, gives back an H of the lane; and
// S + goe fits 16 bits while max S + goe <= 32,767 (the wrapper checks
// both, and V % 64 == 0: scorer.pair_form_fits). The one that can pass
// 32,767 is the diagonal, hg(i-1,j-1) + S + goe = H(i-1,j-1) + S, and only
// if H(i-1,j-1) > 32,767 - S >= T = 32,767 - max S. Take the first
// addition of a lane that wraps: every value before it is exact, so the
// H(i-1,j-1) it read was exact and at least T + 1, and that H is in the
// lane's running maximum of some tile (this one, or the tile above, whose
// bottom row the carry brings in; kernel 1 has one tile, the query). The
// maximum only grows, so the lane reports at least T + 1 in that tile. A
// lane whose maxima all stay below T never wrapped and is exact, scores and
// carries. longquery's score_tiles_long takes the maximum over tiles and
// scores every DB block with a lane at or above T again in int32 (kernel
// 2's int32 form on a sub-stream of those blocks), and scorer's
// score_tiles does the same with kernel 1's int32 form; each skips that
// check when the sum of the profile's row maxima, a bound on every H, is
// below T (BLOSUM62: 11 a row, 22,528 for kernel 1's longest profile of
// 2,048 rows, below its T of 32,756). Lanes never mix: every operation
// works on each half alone (the LOP3 join too).
//
#pragma once

#include <climits>
#include <type_traits>

#include "sw_walk.cuh"

namespace sw {

constexpr int HG_STEP = 32;         // D: db positions per lock step (S > 1)
constexpr int HG_AHEAD = 2;         // positions the loads run ahead
constexpr int HG_MAX_WORKERS = 2;   // S at most (the carry form:
                                    // QTILE_WORKERS)
// S at most in the carry form (sw_ragged_qtile_kernel, sw_chunk_qtile_kernel):
// a 1024-row query tile is 32 strips, which four workers share in eight
// full rounds (two workers: kernel 2 0.2% slower, kernel 5 0.1-0.3% faster;
// see the top of this file).
constexpr int QTILE_WORKERS = 4;
// S at most in the pair form (sw_ragged_qtile_kernel<true>: workers of V / 2
// threads; see the top of this file).
constexpr int QTILE_PAIR_WORKERS = 4;
// S at most in kernel 1's pair form (sw_ragged_kernel<false, true>: four
// against two, see the top of this file).
constexpr int WHOLE_PAIR_WORKERS = 4;
constexpr int HG_MAX_THREADS = 512; // S * V at most, so V at most
constexpr int SEG_ROWS = 8;         // rows per segment group of a packed
                                    // multi-query profile
constexpr int STRIP_GROUPS = STRIP / SEG_ROWS;

// Where the packed form reads its segment ids and keeps its planes.
struct PackedPlanes {
  const int* seg_of_group;   // (m / 8,) nondecreasing segment ids
  int n_planes;
  int* planes;               // the DB block's plane 0 (plane stride V)
};

// A strip boundary row in the carry form: real H and the F entering the
// next row, two int32 streams of stride V (the query tile's carries in
// device memory, or a ring slot in shared memory).
struct HRows {
  int* h;
  int* f;
};

// Loads and stores of a boundary row in either form: an (hg, F) int2 pair
// (null: no row there), or HRows (always there). load_row returns the row
// as stored; above_hg turns its first value into the registers' hg.
__device__ __forceinline__ bool present(const int2* p) { return p != nullptr; }
__device__ __forceinline__ bool present(const HRows&) { return true; }
__device__ __forceinline__ int2 load_row(const int2* p, int64_t a) {
  return p[a];
}
__device__ __forceinline__ int2 load_row(const HRows& p, int64_t a) {
  return make_int2(p.h[a], p.f[a]);
}
__device__ __forceinline__ int above_hg(const int2*, int x, int) { return x; }
__device__ __forceinline__ int above_hg(const HRows&, int x, int goe) {
  return x - goe;
}
__device__ __forceinline__ void store_row(int2* p, int64_t a, int hg, int f,
                                          int) {
  p[a] = make_int2(hg, f);
}
__device__ __forceinline__ void store_row(const HRows& p, int64_t a, int hg,
                                          int f, int goe) {
  p.h[a] = hg + goe;
  p.f[a] = f;
}

// Shared memory of a block of `workers` workers of V lanes, in ints: one
// staged profile strip per worker, then two ring slots of HG_STEP x V
// (hg, F) pairs per boundary between neighbouring workers (in the carry
// form a slot is HG_STEP x V values of H, then as many of F; at least room
// for the final reduction of the workers' maxima).
__host__ __device__ inline size_t hg_shared_ints(int workers, int V) {
  const size_t ring = (size_t)(workers - 1) * 2 * HG_STEP * V * 2;
  const size_t red = workers > 1 ? (size_t)workers * V : 0;
  return (size_t)workers * STRIP * TABLE_CODES + (ring > red ? ring : red);
}

// Barrier over the V threads of worker k (the whole block when it is the
// only worker).
__device__ __forceinline__ void worker_sync(int k, int V, int workers) {
  if (workers == 1) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(k + 1), "r"(V) : "memory");
  }
}

// One step of a strip of R rows for one lane: n db positions from `codes`
// (stride V). top/bot point at this lane's first entry of the row above /
// of this strip's bottom row (stride V; shared or device memory): (hg, F)
// int2 pairs, or null: no row above (H = 0, F = NEG), nothing below; or,
// in the carry form, HRows. hg/e/diag_top carry the strip's state from
// step to step. gm holds the running maximum: one for the lane (G == 1),
// or one per 8-row group of the strip in the packed form (G ==
// STRIP_GROUPS), where cap holds the groups' caps on F. It is a maximum of
// t0, or of hg in the carry form (see the top of this file). The loads
// of a position's code and top row are started HG_AHEAD positions ahead
// of its turn.
template <int R, bool CEIL, int G, class Top, class Bot>
__device__ __forceinline__ void hg_step(int (&hg)[STRIP], int (&e)[STRIP],
                                        int& diag_top, int (&gm)[G],
                                        const int (&cap)[G],
                                        const int8_t* __restrict__ codes,
                                        int n, int V,
                                        const int* __restrict__ prof,
                                        const Top top, const Bot bot, int goe,
                                        int nge, int ceiling) {
  constexpr bool carry_form = std::is_same<Top, HRows>::value;
  // the carry form reads the code bytes unsigned (see the top of this file)
  using Code = std::conditional_t<carry_form, uint8_t, int8_t>;
  const Code* __restrict__ cb = reinterpret_cast<const Code*>(codes);
  int code_q[HG_AHEAD];
  int2 top_q[HG_AHEAD];
#pragma unroll
  for (int a = 0; a < HG_AHEAD; ++a) {
    code_q[a] = 0;
    top_q[a] = make_int2(-goe, NEG);
    if (a < n) {
      code_q[a] = cb[(int64_t)a * V];
      if (present(top)) top_q[a] = load_row(top, (int64_t)a * V);
    }
  }
  for (int j = 0; j < n; ++j) {
    const int code = code_q[0] & (TABLE_CODES - 1);
    int diag = diag_top;
    diag_top = above_hg(top, top_q[0].x, goe);
    int f = top_q[0].y;
#pragma unroll
    for (int a = 0; a + 1 < HG_AHEAD; ++a) {
      code_q[a] = code_q[a + 1];
      top_q[a] = top_q[a + 1];
    }
    if (j + HG_AHEAD < n) {
      code_q[HG_AHEAD - 1] = cb[(int64_t)(j + HG_AHEAD) * V];
      if (present(top))
        top_q[HG_AHEAD - 1] = load_row(top, (int64_t)(j + HG_AHEAD) * V);
    }
    const int* __restrict__ col = prof + code;
    int tprev = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      constexpr bool packed = G > 1;
      const int g = packed ? r / SEG_ROWS : 0;
      if (packed && r % SEG_ROWS == 0) f = min(f, cap[g]);
      const int en = __viaddmax_s32(e[r], nge, hg[r]);
      int t0 = __viaddmax_s32_relu(diag, col[r * TABLE_CODES], en);
      if (CEIL) t0 = min(t0, ceiling);
      if (!carry_form) {
        if (r & 1) {
          gm[g] = __vimax3_s32(gm[g], tprev, t0);
        } else {
          tprev = t0;
        }
      }
      const int t0g = t0 - goe;
      diag = hg[r];
      hg[r] = __viaddmax_s32(f, -goe, t0g);
      e[r] = en;
      f = __viaddmax_s32(f, nge, t0g);
      if (carry_form) {
        if (r & 1) {
          gm[g] = __vimax3_s32(gm[g], tprev, hg[r]);
        } else {
          tprev = hg[r];
        }
      }
    }
    if (present(bot)) store_row(bot, (int64_t)j * V, hg[R - 1], f, goe);
  }
}

// Fold the group maxima of the strip that starts at group g0 (rows / 8
// groups) into this lane's planes: even segment ids are queries (plane id /
// 2); odd ids (separators, the tail) and ids past the planes are dropped.
// The ids are read here and not kept through the strip, to spare its
// registers. Two workers share a lane's planes, and one query's rows may
// span both workers' strips, so the fold is an atomic maximum (a reduction
// without a return value: the thread does not wait for it). A plain
// read-max-write would also be safe under the lock step (no two workers
// finish a strip in the same step, and a barrier ends every step), but it
// was no faster: 84.0 against 84.1 ms for a 1024-row pack over a
// 570,000-sequence stream (NVIDIA H100 80GB HBM3, 700 W), and the atomic
// does not lean on the schedule.
__device__ __forceinline__ void fold_groups(const PackedPlanes& pk, int V,
                                            int g0, int rows,
                                            const int (&gm)[STRIP_GROUPS]) {
#pragma unroll
  for (int g = 0; g < STRIP_GROUPS; ++g) {
    if (g * SEG_ROWS < rows) {
      const int sid = pk.seg_of_group[g0 + g];
      if (sid >= 0 && !(sid & 1) && sid / 2 < pk.n_planes)
        atomicMax(pk.planes + (int64_t)(sid / 2) * V, gm[g]);
    }
  }
}

// Walk every strip of an m-row profile over one DB block of npos positions
// with blockDim.x / V workers. codes points at the block's first position,
// smem at hg_shared_ints() ints. carry points at the block's first position
// of the device-memory boundary rows: an (hg, F) int2 scratch stream, used
// when there are more strips than workers; or, in the carry form, the
// query tile's carries (HRows: the row above the tile on entry, its bottom
// row on exit). Returns the lane's maximum H (over the tile's rows, in the
// carry form) in the threads of worker 0; in the packed form the maxima go
// to pk's planes (this thread's lane of them) and nothing is returned.
template <bool CEIL, bool PACKED, class Carry>
__device__ __forceinline__ int hg_walk_block(
    const int8_t* __restrict__ codes, int npos, int V,
    const int* __restrict__ qp, int m, int goe, int ge, int ceiling,
    const Carry carry, int* smem, const PackedPlanes pk) {
  constexpr bool CARRY = std::is_same<Carry, HRows>::value;
  static_assert(CARRY || std::is_same<Carry, int2*>::value,
                "carry is an int2 scratch stream or HRows");
  static_assert(!(CARRY && (PACKED || CEIL)),
                "the carry form has no packed profile and no ceiling");
  constexpr int G = PACKED ? STRIP_GROUPS : 1;
  const int S = blockDim.x / V;
  const int k = threadIdx.x / V;
  const int v = threadIdx.x - k * V;
  const int n_full = m / STRIP;
  const int n_strips = n_full + (m % STRIP) / STRIP_TAIL;
  const int D = S == 1 ? npos : HG_STEP;     // positions per step
  const int nc = S == 1 ? 1 : (npos + D - 1) / D;
  const int P = nc > S ? nc : S;             // steps per round
  const int n_rounds = (n_strips + S - 1) / S;
  const int n_items = n_rounds * P;
  int* prof = smem + k * (STRIP * TABLE_CODES);
  int2* ring = reinterpret_cast<int2*>(smem + S * (STRIP * TABLE_CODES));
  const int slot = HG_STEP * V;              // pairs per ring slot

  int hg[STRIP], e[STRIP], gm[G], cap[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    gm[g] = CARRY ? -goe : 0;   // H = 0, in the form the maximum is kept
    cap[g] = 0;
  }
  int diag_top = -goe;
  int s = 0, r0 = 0, rows = 0;               // this worker's current strip
  for (int t = 0; t < n_items + S - 1; ++t) {
    const int i = t - k;
    const int round = i / P;
    const int c = i - round * P;
    if (i >= 0 && i < n_items && round * S + k < n_strips && c < nc) {
      if (c == 0) {                          // a new strip for this worker
        s = round * S + k;
        rows = s < n_full ? STRIP : STRIP_TAIL;
        r0 = s < n_full ? s * STRIP
                        : n_full * STRIP + (s - n_full) * STRIP_TAIL;
#pragma unroll
        for (int r = 0; r < STRIP; ++r) {
          hg[r] = -goe;
          e[r] = NEG;
        }
        diag_top = -goe;
        if constexpr (PACKED) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            gm[g] = 0;
            const int gi = r0 / SEG_ROWS + g;
            const bool starts =
                g * SEG_ROWS >= rows || gi == 0 ||
                pk.seg_of_group[gi - 1] != pk.seg_of_group[gi];
            cap[g] = starts ? NEG : INT_MAX;
          }
        }
        worker_sync(k, V, S);                // previous strip done with prof
        for (int idx = v; idx < rows * TABLE_CODES; idx += V) {
          const int r = idx / TABLE_CODES;
          const int cc = idx % TABLE_CODES;
          prof[idx] = qp[(int64_t)cc * m + r0 + r] + goe;
        }
        worker_sync(k, V, S);
      }
      const int p0 = c * D;
      const int n = npos - p0 < D ? npos - p0 : D;
      const int64_t off = (int64_t)p0 * V + v;
      if constexpr (CARRY) {
        // worker 0 reads the carries, the last worker and the holder of
        // the last strip write them; the ring holds real H as they do
        int* const ri = reinterpret_cast<int*>(ring) + v;
        const HRows dev{carry.h + off, carry.f + off};
        HRows top = dev, bot = dev;
        if (k > 0) {
          top.h = ri + ((k - 1) * 2 + ((t - 1) & 1)) * 2 * slot;
          top.f = top.h + slot;
        }
        if (k < S - 1 && s < n_strips - 1) {
          bot.h = ri + (k * 2 + (t & 1)) * 2 * slot;
          bot.f = bot.h + slot;
        }
        if (rows == STRIP) {
          hg_step<STRIP, CEIL>(hg, e, diag_top, gm, cap, codes + off, n, V,
                               prof, top, bot, goe, -ge, ceiling);
        } else {
          hg_step<STRIP_TAIL, CEIL>(hg, e, diag_top, gm, cap, codes + off,
                                    n, V, prof, top, bot, goe, -ge, ceiling);
        }
      } else {
        const int2* top = nullptr;
        if (s > 0)
          top = k > 0 ? ring + ((k - 1) * 2 + ((t - 1) & 1)) * slot + v
                      : carry + off;
        int2* bot = nullptr;
        if (s < n_strips - 1)
          bot = k < S - 1 ? ring + (k * 2 + (t & 1)) * slot + v : carry + off;
        if (rows == STRIP) {
          hg_step<STRIP, CEIL>(hg, e, diag_top, gm, cap, codes + off, n, V,
                               prof, top, bot, goe, -ge, ceiling);
        } else {
          hg_step<STRIP_TAIL, CEIL>(hg, e, diag_top, gm, cap, codes + off,
                                    n, V, prof, top, bot, goe, -ge, ceiling);
        }
      }
      if constexpr (PACKED) {
        if (c == nc - 1)                     // the strip is done
          fold_groups(pk, V, r0 / SEG_ROWS, rows, gm);
      }
    }
    if (S > 1) __syncthreads();
  }
  int smax = CARRY ? gm[0] + goe : gm[0];
  if (!PACKED && S > 1) {                    // fold the workers' maxima
    int* red = reinterpret_cast<int*>(ring);
    red[k * V + v] = smax;
    __syncthreads();
    if (k == 0)
      for (int w = 1; w < S; ++w) smax = max(smax, red[w * V + v]);
  }
  return smax;
}

// Launch shape of a kernel built on hg_walk_block for V lanes and an m-row
// profile: threads per block and dynamic shared memory, which the kernel is
// allowed here. Workers per DB block: as many as max_workers (a constant
// of the kernel), the thread limit and the strip count allow; workers
// synchronise by warps, so lanes that do not fill whole warps get one.
// The pair form passes its V / 2 threads a worker as V, and its own
// shared_ints.
template <class Kernel>
inline cudaError_t hg_launch_shape(
    Kernel kernel, int V, int m, int max_workers, int* threads,
    size_t* shared, size_t (*shared_ints)(int, int) = hg_shared_ints) {
  int workers = HG_MAX_THREADS / V < max_workers ? HG_MAX_THREADS / V
                                                 : max_workers;
  const int n_strips = m / STRIP + (m % STRIP) / STRIP_TAIL;
  if (workers > n_strips) workers = n_strips;
  if (workers < 1 || V % 32) workers = 1;
  *threads = workers * V;
  *shared = shared_ints(workers, V) * sizeof(int);
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*shared));
}

// ---- The pair form (sw_ragged_qtile_kernel<true>; the top of this file
// says why it is exact and what it costs) ----

// The 16-bit value x in both halves of a word.
__device__ __forceinline__ unsigned pair_of(int x) {
  return (static_cast<unsigned>(x) & 0xFFFFu) * 0x10001u;
}

// A strip boundary row in the pair form: real H and the F entering the next
// row of lanes 2u (low half) and 2u + 1 (high half) in one word each, two
// streams of stride W = V / 2 words (the query tile's carries, or a ring
// slot in shared memory).
struct PairRows {
  unsigned* h;
  unsigned* f;
};

// Shared memory of a block of `workers` workers of W threads in the pair
// form, in ints: one staged profile strip per worker, then two ring slots of
// HG_STEP x W words of H and as many of F per boundary between
// neighbouring workers (at least room for the final reduction).
__host__ __device__ inline size_t pair_shared_ints(int workers, int W) {
  const size_t prof = (size_t)STRIP * TABLE_CODES;
  const size_t ring = (size_t)(workers - 1) * 2 * HG_STEP * W * 2;
  const size_t red = workers > 1 ? (size_t)workers * W : 0;
  return (size_t)workers * prof + (ring > red ? ring : red);
}

// hg_step in the pair form: one step of a strip of R rows for lanes 2u and
// 2u + 1, n db positions from `codes` (one 16-bit load a position gives
// both lanes' codes; stride W). top and bot as in the carry form; in the
// whole-query form (WHOLE) a null top.h is no row above (H = 0, F = -goe,
// which acts as no F) and a null bot.h no row below.
template <int R, bool WHOLE>
__device__ __forceinline__ void hg_step_pairs(
    unsigned (&hg)[STRIP], unsigned (&e)[STRIP], unsigned& diag_top,
    unsigned& gm, const uint16_t* __restrict__ codes, int n, int W,
    const unsigned* __restrict__ prof, const PairRows top,
    const PairRows bot, unsigned goe2, unsigned ngoe2, unsigned nge2) {
  unsigned code_q[HG_AHEAD];
  uint2 top_q[HG_AHEAD];
#pragma unroll
  for (int a = 0; a < HG_AHEAD; ++a) {
    code_q[a] = 0;
    top_q[a] = make_uint2(0, ngoe2);
    if (a < n) {
      code_q[a] = codes[(int64_t)a * W];
      if (!WHOLE || top.h)
        top_q[a] = make_uint2(top.h[(int64_t)a * W], top.f[(int64_t)a * W]);
    }
  }
#pragma unroll 2
  for (int j = 0; j < n; ++j) {
    const unsigned code = code_q[0];
    unsigned diag = diag_top;
    diag_top = __vadd2(top_q[0].x, ngoe2);   // H - goe
    unsigned f = top_q[0].y;
#pragma unroll
    for (int a = 0; a + 1 < HG_AHEAD; ++a) {
      code_q[a] = code_q[a + 1];
      top_q[a] = top_q[a + 1];
    }
    if (j + HG_AHEAD < n) {
      const int64_t at = (int64_t)(j + HG_AHEAD) * W;
      code_q[HG_AHEAD - 1] = codes[at];
      if (!WHOLE || top.h)
        top_q[HG_AHEAD - 1] = make_uint2(top.h[at], top.f[at]);
    }
    const unsigned* __restrict__ lo = prof + (code & (TABLE_CODES - 1));
    const unsigned* __restrict__ hi =
        prof + ((code >> 8) & (TABLE_CODES - 1));
    unsigned tprev = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const unsigned en = __viaddmax_s16x2_relu(e[r], nge2, hg[r]);
      // the pair's entries: lane 2u's code picks lo's row, 2u + 1's hi's
      const unsigned s2 = (lo[r * TABLE_CODES] & 0x0000FFFFu) |
                          (hi[r * TABLE_CODES] & 0xFFFF0000u);
      const unsigned t0g = __vadd2(__viaddmax_s16x2_relu(diag, s2, en),
                                   ngoe2);
      diag = hg[r];
      hg[r] = __viaddmax_s16x2(f, ngoe2, t0g);
      e[r] = en;
      f = __viaddmax_s16x2(f, nge2, t0g);
      if (r & 1) {
        gm = __vimax3_s16x2(gm, tprev, hg[r]);
      } else {
        tprev = hg[r];
      }
    }
    if (!WHOLE || bot.h) {
      bot.h[(int64_t)j * W] = __vadd2(hg[R - 1], goe2);   // real H
      bot.f[(int64_t)j * W] = f;
    }
  }
}

// ---- The split walk (kernel 1's pair form, sw_ragged_kernel<false, true,
// true>): one DB block walked by several CUDA blocks ----
//
// A CUDA block walks a DB block no faster than one SM can, so a block much
// longer than its launch's share of positions per SM runs on alone after
// every other SM has finished (the streamed search's last window: PERF.md
// §5). The split walk puts `parts` CUDA blocks ("parts") on such a block,
// S workers each, as one ring of S * parts workers: worker k of part c is
// worker c * S + k of the ring and takes strips c * S + k, c * S + k + S *
// parts, ..., the schedule of hg_walk_block with the ring S * parts long.
// Inside a part the hand-offs stay in the shared-memory ring under the
// lock step. Between the last worker of part c and worker 0 of part c + 1,
// and from part parts - 1 to part 0 a round later, the bottom row goes
// through the carry streams in place, as from the last worker of a round to
// worker 0 of the next in the unsplit walk: every write of a position there
// follows the read of it by the part that wrote it before, through the
// chain of waits below, so each part reads a position before it is written
// again. A round lasts max(ceil(npos / D), S * parts) steps, so that part 0
// never waits on a step that waits on it.
//
// Progress. After every step's barrier a thread of the last worker stores
// the part's count of finished steps with release semantics (a DB block of
// one part waits on nothing and stores none). Before worker
// 0 reads a step's positions from the carries it needs the previous part's
// last worker to have written them: that part's count at least the item's
// step there plus S. Worker 0 keeps the count it last read; only when that
// falls short does one of its threads spin on the count with acquire
// semantics, and worker 0's threads meet at their barrier behind it. A
// count read once covers the steps up to it: the acquire that read it
// follows worker 0's reads of those positions in the round before (they
// precede, through the ring, the writes the count covers), so no stale
// line of them can outlive it.
//
// The gate. The parts wait on each other, so they must all be running at
// once, and CUDA promises neither the order in which a grid's CUDA blocks
// start nor that they are resident together. So no part walks before every
// part of its DB block has started: each adds one to the DB block's gate
// word on arrival (split_gate) and waits for the others. Once all have
// arrived they are all resident, and each wait of the walk is on a part
// that is running. A part that waits SPLIT_GATE_NS without them closes the
// gate and walks the whole DB block alone, as one part (the unsplit
// schedule); a part that finds the gate closed leaves. So a launch finishes
// whatever the start order and whatever other work holds the card's slots:
// a DB block whose parts cannot start together is walked by one CUDA
// block, at the unsplit speed. A wait in the walk of more than
// SPLIT_WAIT_NS can then only be a fault of the walk itself; it traps, so
// the launch fails (and with it the process's CUDA context) instead of
// hanging the card.
constexpr long long SPLIT_WAIT_NS = 5000000000LL;
constexpr long long SPLIT_GATE_NS = 50000LL;
constexpr int GATE_CLOSED = 1 << 30;
enum GateTurn { GATE_WALK, GATE_ALONE, GATE_LEAVE };

// This CUDA block's part of a split DB block, and the progress words.
struct PairSplit {
  int part;          // 0 .. parts - 1
  int parts;         // CUDA blocks on the DB block
  int* done;         // this part's count of finished steps
  const int* prev;   // the count of the part before it in the ring
  int* seen;         // shared: the count of prev that worker 0 last read
};

__device__ __forceinline__ void store_release(int* p, int x) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(x)
               : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int x;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(x) : "l"(p)
               : "memory");
  return x;
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *p >= need (one thread); returns the value read.
__device__ __forceinline__ int wait_for(const int* p, int need) {
  const long long t0 = global_ns();
  int x;
  while ((x = load_acquire(p)) < need) {
    if (global_ns() - t0 > SPLIT_WAIT_NS) __trap();
    __nanosleep(64);
  }
  return x;
}

// One thread of each part of a split DB block, on arrival: its turn at the
// DB block's gate word (zero on entry; see "The gate" above).
__device__ __forceinline__ GateTurn split_gate(int* gate, int parts) {
  int n = atomicAdd(gate, 1);
  if (n & GATE_CLOSED) return GATE_LEAVE;
  ++n;
  const long long t0 = global_ns();
  while (n < parts) {
    if (global_ns() - t0 > SPLIT_GATE_NS) {
      const int was = atomicCAS(gate, n, n | GATE_CLOSED);
      if (was == n) return GATE_ALONE;
      n = was;                       // another part arrived, or closed it
    } else {
      __nanosleep(32);
      n = load_acquire(gate);
    }
    if (n & GATE_CLOSED) return GATE_LEAVE;
  }
  return GATE_WALK;
}

// hg_walk_block's carry form in lane pairs: blockDim.x / (V / 2) workers of
// W = V / 2 threads, thread u of a worker on lanes 2u and 2u + 1, on the
// same schedule (written apart: one schedule for both forms would branch on
// the form at every step, and the other kernels keep their code). codes
// points at the DB block's first position (int8, stride V), carry at its
// first word of the pair carries (stride W). Returns the pair's maximum of
// hg = H - goe over the tile's rows (each half), in the threads of worker 0.
// WHOLE: the profile is a whole query (kernel 1), not a tile of one. The
// first strip then reads no row above and the last strip writes none below,
// so carry is only the scratch through which the last worker of a round
// hands its bottom row to worker 0 of the next (null when no round follows
// another: one strip). SPLIT: the split walk above, this CUDA block being
// part sp.part of sp.parts (S > 1); the maximum returned is over the strips
// of this part.
template <bool WHOLE, bool SPLIT = false>
__device__ __forceinline__ unsigned hg_walk_block_pairs(
    const int8_t* __restrict__ codes, int npos, int V,
    const int* __restrict__ qp, int m, int goe, int ge,
    const PairRows carry, int* smem, const PairSplit sp = PairSplit{}) {
  const int W = V / 2;
  const int S = blockDim.x / W;
  const int k = threadIdx.x / W;
  const int v = threadIdx.x - k * W;
  const int n_full = m / STRIP;
  const int n_strips = n_full + (m % STRIP) / STRIP_TAIL;
  const int ring_len = SPLIT ? S * sp.parts : S;   // workers in the ring
  const int g = SPLIT ? sp.part * S + k : k;       // this worker's place
  const int D = S == 1 ? npos : HG_STEP;     // positions per step
  const int nc = S == 1 ? 1 : (npos + D - 1) / D;
  const int P = nc > ring_len ? nc : ring_len;   // steps per round
  const int n_rounds = (n_strips + ring_len - 1) / ring_len;
  const int n_items = n_rounds * P;
  unsigned* const words = reinterpret_cast<unsigned*>(smem);
  unsigned* prof = words + k * STRIP * TABLE_CODES;
  unsigned* ring = words + S * STRIP * TABLE_CODES;
  const int slot = HG_STEP * W;              // words per ring slot
  const unsigned goe2 = pair_of(goe), ngoe2 = pair_of(-goe),
                 nge2 = pair_of(-ge);
  const uint16_t* __restrict__ cw = reinterpret_cast<const uint16_t*>(codes);

  unsigned hg[STRIP], e[STRIP];
  unsigned gm = ngoe2;                       // H = 0 in both lanes
  unsigned diag_top = ngoe2;
  int s = 0, rows = 0;                       // this worker's current strip
  int seen = -1;                             // SPLIT: the count read last
  for (int t = 0; t < n_items + S - 1; ++t) {
    const int i = t - k;
    const int round = i / P;
    const int c = i - round * P;
    if (i >= 0 && i < n_items && round * ring_len + g < n_strips && c < nc) {
      if (c == 0) {                          // a new strip for this worker
        s = round * ring_len + g;
        rows = s < n_full ? STRIP : STRIP_TAIL;
        const int r0 = s < n_full ? s * STRIP
                                  : n_full * STRIP + (s - n_full) * STRIP_TAIL;
#pragma unroll
        for (int r = 0; r < STRIP; ++r) {
          hg[r] = ngoe2;
          e[r] = 0;                          // E is kept clamped at 0
        }
        diag_top = ngoe2;
        worker_sync(k, W, S);                // previous strip done with prof
        for (int idx = v; idx < rows * TABLE_CODES; idx += W) {
          const int r = idx / TABLE_CODES;
          const int cc = idx % TABLE_CODES;
          prof[idx] = pair_of(qp[(int64_t)cc * m + r0 + r] + goe);
        }
        worker_sync(k, W, S);
      }
      if constexpr (SPLIT) {
        // worker 0 reads the previous part's bottom row from the carries:
        // wait until its last worker has written this item's positions
        // (the same round, or for part 0 the round before)
        const int need = (sp.part > 0 ? i : i - P) + S;
        if (sp.parts > 1 && k == 0 && s > 0 && seen < need) {
          if (v == 0) *sp.seen = wait_for(sp.prev, need);
          worker_sync(0, W, S);
          seen = *sp.seen;
        }
      }
      const int p0 = c * D;
      const int n = npos - p0 < D ? npos - p0 : D;
      const int64_t off = (int64_t)p0 * W + v;
      // worker 0 reads the carries, the last worker and the holder of the
      // last strip write them; the ring holds real H as they do
      unsigned* const ri = ring + v;
      PairRows top{carry.h + off, carry.f + off};
      PairRows bot = top;
      if (k > 0) {
        top.h = ri + ((k - 1) * 2 + ((t - 1) & 1)) * 2 * slot;
        top.f = top.h + slot;
      }
      if (k < S - 1 && s < n_strips - 1) {
        bot.h = ri + (k * 2 + (t & 1)) * 2 * slot;
        bot.f = bot.h + slot;
      }
      if constexpr (WHOLE) {       // the query's own top and bottom rows
        if (s == 0) top.h = nullptr;
        if (s == n_strips - 1) bot.h = nullptr;
      }
      if (rows == STRIP) {
        hg_step_pairs<STRIP, WHOLE>(hg, e, diag_top, gm, cw + off, n, W,
                                    prof, top, bot, goe2, ngoe2, nge2);
      } else {
        hg_step_pairs<STRIP_TAIL, WHOLE>(hg, e, diag_top, gm, cw + off, n, W,
                                         prof, top, bot, goe2, ngoe2, nge2);
      }
    }
    if (S > 1) __syncthreads();
    if constexpr (SPLIT) {   // the step's carry writes are behind the barrier
      if (sp.parts > 1 && threadIdx.x == (S - 1) * W)
        store_release(sp.done, t + 1);
    }
  }
  if (S > 1) {                               // fold the workers' maxima
    unsigned* red = ring;
    red[k * W + v] = gm;
    __syncthreads();
    if (k == 0)
      for (int w = 1; w < S; ++w) gm = __vmaxs2(gm, red[w * W + v]);
  }
  return gm;
}

}  // namespace sw
