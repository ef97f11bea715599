// Smith-Waterman / Gotoh alignments (score AND path) of many (query,
// subject) pairs in one launch: the card's counterpart of the host
// traceback ops/traceback.py sw_align, bit for bit. It is no port of a TPU
// kernel: swimm_tpu aligns its hits on the host.
//
//   sw_align_kernel   one warp per pair: a Gotoh pass that keeps a 4-bit
//                     backpointer per cell, the end cell, then the walk
//                     back to the path, with m8's counts (ops/align.py)
//
// Recurrence (int32; a gap of length k costs open + k * extend), for query
// row i = 1..m and subject column j = 1..n:
//   E(i,j) = max(H(i,j-1) - goe, E(i,j-1) - ge)     gap in the query
//   F(i,j) = max(H(i-1,j) - goe, F(i-1,j) - ge)     gap in the subject
//   H(i,j) = max(0, H(i-1,j-1) + S(q_i, d_j), E(i,j), F(i,j))
// with H = 0 on row 0 and column 0 and E, F = NEG there. The tie rules are
// ops/traceback.py's: H's backpointer is STOP where H = 0, else the
// diagonal where H equals it, else E where H equals E, else F; a gap
// extends only where extending wins strictly; the end cell is the first
// maximum of H in row-major order ((0, 0) when every H is 0); the path
// stops at a STOP cell or at row or column 0.
//
// Schedule. Lane t of the warp holds R consecutive query rows of a pass of
// 32 * R rows, and at step s takes column j = s - t + 1 of all R, so lane t
// gets H and F of the row above its first from lane t - 1 by one shuffle
// (computed at the step before), and keeps that H for the next step's
// diagonal. Lane 0 reads the row above the pass from a boundary row in
// device memory (H and F of the previous pass's last row, written there by
// lane 31 one column at a time; lane 0 reads column j 31 steps before lane
// 31 overwrites it). Each lane keeps its rows' H(i, j-1) and E(i, j-1),
// and each row's largest H with the first column it was reached at.
//
// Backpointers. R = 8, so a lane's rows at one column are one group of 8
// rows, and their eight 4-bit backpointers one 32-bit word, stored at
// every step without a branch: cell (i, j) is nibble (i - 1) % 8 of word
// ((i - 1) / 8) * n + j - 1 of the pair's workspace. Bits 0-1 are H's
// source (0 STOP, 1 diagonal, 2 E, 3 F), bit 2 E extends, bit 3 F extends.
// A step of the walk along the diagonal moves to the word before, in the
// same cache line seven times in eight.
//
// The walk. The warp reduces each lane's first maximum (H, then the
// smaller (i, j) on a tie: its rows' maxima taken in row order) to the end
// cell; lane 0 follows the
// backpointers from it, writes the path's columns last first (0 a residue
// pair, 1 a gap in the query, 2 a gap in the subject) and counts
// identities (equal codes), positives (equal codes or a positive score),
// gap columns, gap runs in each aligned string, and the path's own score,
// which the wrapper holds to the DP's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);   // E/F at row and column 0; E - ge and
                                  // F - ge restart from >= -goe at every
                                  // cell, so NEG - ge never wraps
constexpr int TABLE = 32;         // substitution table stride (codes < 32)
constexpr int R = 8;              // query rows a lane holds in one pass
                                  // (one backpointer word)
constexpr int WARP = 32;
constexpr int DESC = 8;           // int64 words of one pair's descriptor
constexpr int OUT = 12;           // int32 results of one pair

// one pair's descriptor (int64): query offset, m, subject offset, n,
// workspace word offset, boundary-row offset (2 * (n + 1) ints), path
// offset (m + n bytes), unused
enum { D_Q = 0, D_M, D_D, D_N, D_BP, D_ROW, D_PATH };
// one pair's results (int32)
enum {
  O_SCORE = 0, O_QSTART, O_QEND, O_DSTART, O_DEND, O_LENGTH, O_IDENT,
  O_POS, O_GAPS, O_QOPENS, O_DOPENS, O_CHECK
};

// H's source codes (bits 0-1 of a backpointer)
constexpr unsigned STOP = 0, DIAG = 1, FROM_E = 2, FROM_F = 3;

// The first of two maxima in row-major order: (h, i, j) replaces the best
// if its H is larger, or equal at an earlier cell.
__device__ __forceinline__ bool earlier_max(int h, int i, int j, int bh,
                                            int bi, int bj) {
  return h > bh || (h == bh && (i < bi || (i == bi && j < bj)));
}

__global__ void __launch_bounds__(WARP)
sw_align_kernel(const uint8_t* __restrict__ codes,
                const int64_t* __restrict__ desc,
                const int* __restrict__ sub, int A, int goe, int ge,
                unsigned* __restrict__ bp, int* __restrict__ rows,
                uint8_t* __restrict__ path, int* __restrict__ out) {
  __shared__ int s_sub[TABLE * TABLE];
  const int lane = threadIdx.x;
  for (int k = lane; k < TABLE * TABLE; k += WARP) {
    const int a = k / TABLE, b = k % TABLE;
    s_sub[k] = (a < A && b < A) ? sub[a * A + b] : 0;
  }
  __syncwarp();

  const int64_t* d = desc + static_cast<int64_t>(blockIdx.x) * DESC;
  const uint8_t* q = codes + d[D_Q];
  const int m = static_cast<int>(d[D_M]);
  const uint8_t* s = codes + d[D_D];
  const int n = static_cast<int>(d[D_N]);
  unsigned* w = bp + d[D_BP];
  int* row_h = rows + d[D_ROW];
  int* row_f = row_h + n + 1;

  int best = 0, bi = 0, bj = 0;   // this lane's first maximum of H
  if (m > 0 && n > 0) {
    for (int base = 0; base < m; base += WARP * R) {
      const int i0 = base + lane * R + 1;   // this lane's first row
      unsigned* wg = w + static_cast<int64_t>(i0 - 1) / R * n - 1;
      int srow[R];                          // the rows' table offsets
      int hl[R], el[R];                     // H(i, j-1), E(i, j-1)
      int rbest[R], rj[R];                  // each row's first maximum
#pragma unroll
      for (int r = 0; r < R; ++r) {
        srow[r] = TABLE * (i0 + r <= m ? q[i0 + r - 1] : 0);
        hl[r] = 0;
        el[r] = NEG;
        rbest[r] = 0;
        rj[r] = 0;
      }
      int pub_h = 0, pub_f = NEG;   // last row's H, F at the column just done
      int diag0 = 0;                // H(i0 - 1, j - 1)
      const bool last_pass = base + WARP * R >= m;
      // the next step's subject code and (lane 0) boundary row, loaded a
      // step ahead so that no step waits for device memory
      int dc_next = 0, bh_next = 0, bf_next = NEG;
      if (lane == 0) {
        dc_next = s[0];
        if (base) {
          bh_next = row_h[1];
          bf_next = row_f[1];
        }
      }
      for (int step = 0; step < n + WARP - 1; ++step) {
        int up_h = __shfl_up_sync(0xffffffffu, pub_h, 1);
        int up_f = __shfl_up_sync(0xffffffffu, pub_f, 1);
        const int j = step - lane + 1;
        if (j < 1 || j > n) {
          if (j == 0) dc_next = s[0];   // this lane's first column, next
          continue;
        }
        if (lane == 0) {
          up_h = bh_next;
          up_f = bf_next;
          if (base && j < n) {
            bh_next = row_h[j + 1];
            bf_next = row_f[j + 1];
          }
        }
        const int dc = dc_next;
        if (j < n) dc_next = s[j];
        int hd = diag0;   // H(i-1, j-1) of the row being done
        diag0 = up_h;
        unsigned word = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int e_open = hl[r] - goe;
          const int e = max(e_open, el[r] - ge);
          const int f_open = up_h - goe;
          const int f = max(f_open, up_f - ge);
          const int dg = hd + s_sub[srow[r] + dc];
          const int h = max(max(dg, 0), max(e, f));
          const unsigned src = h == 0 ? STOP : h == dg ? DIAG
                               : h == e ? FROM_E : FROM_F;
          // a gap extends where extending beat opening: max is not the open
          word |= (src | (e != e_open ? 4u : 0u) | (f != f_open ? 8u : 0u))
                  << (4 * r);
          if (h > rbest[r]) {
            rbest[r] = h;
            rj[r] = j;
          }
          hd = hl[r];
          hl[r] = h;
          el[r] = e;
          up_h = h;
          up_f = f;
        }
        if (i0 <= m) wg[j] = word;
        pub_h = up_h;
        pub_f = up_f;
        if (lane == WARP - 1 && !last_pass) {
          row_h[j] = up_h;
          row_f[j] = up_f;
        }
      }
      // the rows in order: on a tie the earlier row keeps it
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (i0 + r <= m && rbest[r] > best) {
          best = rbest[r];
          bi = i0 + r;
          bj = rj[r];
        }
      }
      __syncwarp();   // the boundary row, and every backpointer word
    }
  }
  for (int off = WARP / 2; off > 0; off /= 2) {
    const int oh = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
    if (earlier_max(oh, oi, oj, best, bi, bj)) {
      best = oh;
      bi = oi;
      bj = oj;
    }
  }
  __syncwarp();
  if (lane != 0) return;

  uint8_t* p = path + d[D_PATH];
  int i = bi, j = bj, len = 0, ident = 0, pos = 0, gaps = 0;
  int qopens = 0, dopens = 0, check = 0;
  unsigned state = DIAG;   // DIAG: in H; FROM_E, FROM_F: in a gap
  unsigned prev = DIAG;    // the column taken before (later in the path)
  while (i > 0 && j > 0) {
    const unsigned code =
        (w[static_cast<int64_t>(i - 1) / R * n + j - 1] >> (4 * ((i - 1) % R)))
        & 15u;
    if (state == DIAG) {
      const unsigned src = code & 3u;
      if (src == STOP) break;
      if (src != DIAG) {
        state = src;
        continue;
      }
      const int a = q[i - 1], b = s[j - 1];
      const int sc = s_sub[a * TABLE + b];
      check += sc;
      ident += a == b;
      pos += a == b || sc > 0;
      p[len++] = 0;
      prev = DIAG;
      --i;
      --j;
    } else if (state == FROM_E) {   // a gap in the query: takes d_j
      check -= prev == FROM_E ? ge : goe;
      qopens += prev != FROM_E;
      ++gaps;
      p[len++] = 1;
      prev = FROM_E;
      state = (code & 4u) ? FROM_E : DIAG;
      --j;
    } else {                        // a gap in the subject: takes q_i
      check -= prev == FROM_F ? ge : goe;
      dopens += prev != FROM_F;
      ++gaps;
      p[len++] = 2;
      prev = FROM_F;
      state = (code & 8u) ? FROM_F : DIAG;
      --i;
    }
  }
  int* o = out + static_cast<int64_t>(blockIdx.x) * OUT;
  o[O_SCORE] = best;
  o[O_QSTART] = i;
  o[O_QEND] = bi;
  o[O_DSTART] = j;
  o[O_DEND] = bj;
  o[O_LENGTH] = len;
  o[O_IDENT] = ident;
  o[O_POS] = pos;
  o[O_GAPS] = gaps;
  o[O_QOPENS] = qopens;
  o[O_DOPENS] = dopens;
  o[O_CHECK] = check;
}

}  // namespace

// codes: every pair's query and subject codes (uint8, < A <= 32); desc:
// (n_pairs, 8) int64 descriptors; sub: the (A, A) int32 table; bp: the
// backpointer workspace (uint32 words); rows: boundary rows (int32);
// path: m + n bytes a pair; out: (n_pairs, 12) int32.
extern "C" int sw_align_launch(const void* codes, const void* desc,
                               int n_pairs, const void* sub, int A, int goe,
                               int ge, void* bp, void* rows, void* path,
                               void* out, void* stream) {
  if (n_pairs <= 0) return static_cast<int>(cudaGetLastError());
  if (A > TABLE) return static_cast<int>(cudaErrorInvalidValue);
  sw_align_kernel<<<n_pairs, WARP, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int64_t*>(desc),
      static_cast<const int*>(sub), A, goe, ge, static_cast<unsigned*>(bp),
      static_cast<int*>(rows), static_cast<uint8_t*>(path),
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
