// The walk of the four kernels that score a profile on cooperating workers
// per DB block: sw_ragged_kernel and sw_ragged_packed_kernel (sw_ragged.cu;
// they replace swimm_tpu/ops/pallas_scorer.py _dp_ragged_kernel via
// score_tiles and _dp_packed_kernel via score_tiles_packed),
// sw_ragged_qtile_kernel (sw_ragged.cu; swimm_tpu/ops/longquery.py
// _dp_ragged_tile_kernel via _score_tiles_one_qtile, in the carry form
// below) and sw_chunk_kernel (sw_chunk.cu; _dp_kernel via score_chunk). It
// is the recurrence of sw_walk.cuh, rewritten for what bounds it on an
// H100. The chunk query-tile kernel, sw_chunk_qtile_kernel, keeps the walk
// of sw_walk.cuh.
//
// What bounds it. Measured on an NVIDIA H100 80GB HBM3 at 700 W: VIADDMNMX
// and VIMNMX3 start at 62 thread-instructions per clock per SM, half of
// what the schedulers can start, VIMNMX at 119, and all three share one
// pipe; additions go elsewhere and overlap them. A warp starts its
// instructions in order, so a lone warp of the walk of sw_walk.cuh
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
// The carry form (a Carry of type HRows: sw_ragged_qtile_kernel) walks one
// query tile of a longer query, whose interface is the row above the tile
// and the tile's own bottom row, as real H and the F entering the next row
// in two int32 streams (ch, cf) laid out like the codes, updated in place.
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
// from the kernel's const __restrict__ parameter. The carries come out
// exact: H = hg + goe = max(t0, F), and F below = max(t0 - goe, F - ge) =
// max(H - goe, F - ge) for gap_open >= 0. The per-tile maximum is not the
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
// code's low five bits, all the walk uses, are the same. Kernels 1 and 3
// still read it signed and wait (PERF.md §6: ~11% of their time);
// kernel 4, whose codes address is re-based from a table, gets a plain
// LDG.E.S8, which needs no PRMT.
//
// S, D and the rest, by measurement on that card (whole-DB stream of
// 50,873 tiles, m = 448; the walk of sw_walk.cuh: 51.8 ms): S = 1 40.4 ms,
// S = 2 35.6, S = 4 41.5 (14 strips leave two of 16 worker slots idle, and
// a 512-thread block leaves no second block on the SM); D = 16 37.9, D = 32
// 35.6, D = 48 35.9; loads 1, 2, 4 positions ahead 37.2 (before the last
// change to the recurrence), 35.6, 37.9 (registers); 16-row strips (64
// registers, twice the warps) 41.9 with S = 4 and 77.7 with S = 1, where
// the doubled carry traffic does bind. 120-128 registers under
// __launch_bounds__(512, 1): two blocks of 256 threads per SM. The carry
// form (a 1024-row tile, 32 strips, over the whole-DB stream; the walk of
// sw_walk.cuh: 88.7 ms; tools/walk_variants.py): code bytes signed 84.4 ms
// at S = 2, 85.1 at S = 4; unsigned 75.4 at S = 2, 75.2 at S = 4 (eight
// full rounds), so four workers; the incoming F folded into a maximum of
// t0 in place of the maximum of hg 75.4 (one VIMNMX more per position and
// strip); 123 registers.

#pragma once

#include <climits>
#include <type_traits>

#include "sw_walk.cuh"

namespace sw {

constexpr int HG_STEP = 32;         // D: db positions per lock step (S > 1)
constexpr int HG_AHEAD = 2;         // positions the loads run ahead
constexpr int HG_MAX_WORKERS = 2;   // S at most (sw_ragged_qtile_kernel:
                                    // QTILE_WORKERS)
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
// t0, or of hg in the carry form (see the top of this file). As in
// sw_walk.cuh the loads of a position's code and top row are started
// ahead of its turn, here HG_AHEAD positions.
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
template <class Kernel>
inline cudaError_t hg_launch_shape(Kernel kernel, int V, int m,
                                   int max_workers, int* threads,
                                   size_t* shared) {
  int workers = HG_MAX_THREADS / V < max_workers ? HG_MAX_THREADS / V
                                                 : max_workers;
  const int n_strips = m / STRIP + (m % STRIP) / STRIP_TAIL;
  if (workers > n_strips) workers = n_strips;
  if (workers < 1 || V % 32) workers = 1;
  *threads = workers * V;
  *shared = hg_shared_ints(workers, V) * sizeof(int);
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*shared));
}

}  // namespace sw
