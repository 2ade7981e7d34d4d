// Banded DTW (Sakoe-Chiba band, squared local costs) for Hopper (sm_90a).
//
// Replaces: src/repro/core/dtw.py::dtw_distance, the hot loop of every DTW
// query (dtw_knn's chunked refinement). The reference computes it outside
// Pallas, as a fori_loop over the n rows around a lax.scan over the n
// columns: n^2 dependent steps a call, no TPU kernel.
//
// For each (query, candidate) pair, out = D[n-1][n-1] with
//   D[i][j] = c(i, j) + min(D[i-1][j-1], D[i-1][j], D[i][j-1]),  |i - j| <= band,
//   c(i, j) = (cand[j] - query[i]) * (cand[j] - query[i]),
// D = 3.0e38 (the reference's sentinel) outside the band and the matrix, and
// 0 as the one predecessor of (0, 0). Every cell is one rounded subtract,
// one rounded product and one rounded add of an exact minimum
// (__fsub_rn / __fmul_rn / __fadd_rn: nvcc may not contract c + m into an
// fmaf, the trap the notes in ed.cu describe), so a cell's value does not
// depend on the order the cells are evaluated in. Every kernel here (row by
// row, or a wavefront over lanes) and kernels/ref.py::dtw_band_ref
// (anti-diagonal wavefront) agree bit for bit, on the card and on the CPU.
// A cell outside the band or the matrix holds exactly kBig: v1 skips it, v2
// computes it and stores kBig in its place (no such value is ever read).
//
// In band-offset coordinates a row holds W = 2 band + 1 cells, cell o of row
// i at column j = i - band + o; cell o reads cell o (diagonal) and o + 1 (up)
// of row i - 1 and cell o - 1 (left) of its own row.
//
// Bound: operations. 5 FP32 operations a cell (subtract, multiply, two
// minima, add), none of them an FMA, over pairs * (n (2 band + 1) - band
// (band + 1)) cells, against pairs * n * 4 bytes of candidates read once. At
// 128 FADD/FMUL and 64 FMNMX results a clock an SM (compute capability 9.0),
// one warp instruction a clock per scheduler issues at most 128 of the 5
// a clock an SM: at 2^22 pairs, n = 256, band 13 that is 4.2 ms at 1.98 GHz,
// against 1.3 ms of HBM (3.35 TB/s). A few thousand pairs (a dtw_knn round)
// cannot fill the card: there the dependency chain sets the time, 2n - 1
// cells of one minimum and one add on the longest path.
//
// v1, dtw_band_kernel (any band; v2 takes bands up to 32): one thread a
// (query, candidate) pair; a block holds T candidates of one query
// (blockIdx.y). The query row sits in shared memory (broadcast reads). Each
// thread keeps its DP row of W band cells in shared memory, offset-major
// ([o][t], conflict-free), plus a fixed out-of-matrix cell at o = W, and
// updates it in place. Candidates are staged a tile of R = 32 DP rows at a
// time: the columns [i0 - band, i0 + R - 1 + band] of the block's T
// candidates, read by one group of up to 32 threads a candidate, lanes on
// consecutive columns (coalesced), stored column-major with a pitch of
// T + 1 (conflict-free on both sides). A cell costs three shared-memory
// accesses beside its five FP32 operations, and the `up` load of cell o + 1
// waits behind the store of cell o: ~110 cycles a cell.
//
// v2, the DP band in registers, in two forms chosen by the host from the
// number of pairs (kernels/dtw.py::_plan):
//
// * dtw_rows_kernel<S> (one thread a pair, S = 17, 33, 65: bands up to 8,
//   16, 32), for calls of many pairs. The row's cells D[S] and the
//   candidates they read cw[S] are registers (every index a constant, the
//   loop over a row fully unrolled). The W real cells sit at the right end,
//   s = S - W + o, so the right edge's `up` is the constant kBig; the cells
//   left of the band are never computed and stay kBig, so a cell reads
//   `left` as D[s - 1] whether or not the row began before it. One of the
//   band's first or last rows starts at its first cell inside the band and
//   the matrix, `start` (uniform across the block), by a jump into the
//   unrolled row, a switch that falls through. The middle rows all start at
//   S - W, so a tile's middle rows take one jump into a loop of
//   straight-line rows (a loop for each value S - W takes, which is even). A
//   cell costs its five FP32 operations and one register move: the
//   candidate window slides one column a row, cell s taking cw[s + 1] and
//   the last cell the one column a row brings in. Those columns and the
//   query values are staged in shared memory a tile of 32 rows at a time,
//   read coalesced, as v1 stages its tiles. The chain a cell adds is one
//   minimum and one add: the candidate, the difference, the product and
//   min(diag, up) do not depend on `left`. Rows whose band passes column
//   n - 1 (the last band rows) store kBig past it by a select.
// * dtw_lanes_kernel<S, G> (G = 16 or 32 lanes a pair, S = 32 / G or 64 /
//   G cells a lane: bands up to 15 or 31), for calls of a few thousand
//   pairs (2, 4 and 8 lanes were slower at every pair count measured:
//   PERF.md). A block first copies its 256 / G candidate rows and the query
//   row into shared memory (coalesced, zero-padded so a step reads its
//   next row's operands without bounds checks). Lane g of a group holds band
//   cells [g S, g S + S) and works on row i at step 2 i + g: `left` comes
//   from lane g - 1's last cell of the same row (__shfl_up_sync) and `up`
//   from lane g + 1's first cell of row i - 1 (__shfl_down_sync), both
//   published at the step before. A lane is busy every other step, so a
//   group carries two pairs on alternate steps (lane g does pair A on
//   steps of g's parity and pair B on the others; its neighbours are then
//   on the same pair a step earlier). A pair's serial path is ~2n + G
//   steps of S cells and two shuffles, against n W cells for one thread.
//   Cells past W or outside the matrix are computed and replaced by kBig
//   (a select); the next row's operands are read a step ahead. The steps
//   where some lane's row lies outside [0, n) (the first and last G / 2)
//   branch around the row; the others do not.
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.0e38f;          // repro/core/dtw.py's out-of-band value
constexpr int kRows = 32;                // DP rows a candidate tile covers
constexpr int kMaxThreads = 128;         // candidates a block
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemMax = 232448;      // 227 KB: the most a block may opt in to

size_t smem_bytes(int n, int band, int threads) {
  const size_t w = 2 * static_cast<size_t>(band) + 1;
  const size_t tile_cols = kRows + 2 * static_cast<size_t>(band);
  return sizeof(float) * (static_cast<size_t>(n) + (w + 1) * threads +
                          tile_cols * (threads + 1));
}

__global__ void dtw_band_kernel(const float* __restrict__ query,   // (Q, n)
                                const float* __restrict__ cands,   // (Q, B, n)
                                float* __restrict__ out,           // (Q, B)
                                int num_cands, int n, int band) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int W = 2 * band + 1;
  const int tile_cols = kRows + 2 * band;
  const int pitch = T + 1;
  const long long q = blockIdx.y;
  const long long cand0 = static_cast<long long>(blockIdx.x) * T;
  const int valid = static_cast<int>(min(static_cast<long long>(T), num_cands - cand0));
  const float* cbase = cands + (q * num_cands + cand0) * n;

  float* qs = smem;                                  // n
  float* row = qs + n;                               // (W + 1) x T
  float* tile = row + static_cast<size_t>(W + 1) * T;  // tile_cols x (T + 1)

  for (int i = t; i < n; i += T) qs[i] = query[q * n + i];
  // row -1: D[-1][-1] = 0 (offset band), every other cell outside the matrix
  float* my_row = row + t;
  for (int o = 0; o <= W; ++o) my_row[o * T] = (o == band) ? 0.0f : kBig;

  const int group = T < 32 ? T : 32;                 // threads a candidate row
  const int groups = T / group;
  const int g = t / group, lane = t % group;
  const float* my_tile = tile + t;

  for (int i0 = 0; i0 < n; i0 += kRows) {
    const int i1 = min(n, i0 + kRows);
    const int col0 = i0 - band;
    __syncthreads();                                 // the last tile is read
    for (int r = g; r < T; r += groups) {
      const float* src = cbase + static_cast<long long>(r) * n;
      for (int c = lane; c < tile_cols; c += group) {
        const int col = col0 + c;
        tile[c * pitch + r] = (r < valid && col >= 0 && col < n) ? src[col] : 0.0f;
      }
    }
    __syncthreads();
    for (int i = i0; i < i1; ++i) {
      const float a = qs[i];
      const float* trow = my_tile + (i - i0) * pitch;  // column i - band
      const int j0 = i - band;
      float left = kBig;
      float diag = my_row[0];
#pragma unroll 4
      for (int o = 0; o < W; ++o) {
        const float up = my_row[(o + 1) * T];
        const int j = j0 + o;
        float cur = kBig;
        if (j >= 0 && j < n) {
          const float d = __fsub_rn(trow[o * pitch], a);
          cur = __fadd_rn(__fmul_rn(d, d), fminf(fminf(diag, up), left));
        }
        my_row[o * T] = cur;
        left = cur;
        diag = up;
      }
    }
  }
  if (t < valid) out[q * num_cands + cand0 + t] = my_row[band * T];
}

// ---- v2: the DP band in registers ----

constexpr int kRowThreads = 64;          // dtw_rows_kernel: pairs a block
constexpr int kLaneThreads = 128;        // dtw_lanes_kernel: threads a block
constexpr int kTile = 32;                // dtw_rows_kernel: rows a staged tile covers

// One cell s of a row of dtw_rows_kernel. `left` is D[s - 1]: this row's
// value where the row started before s, else kBig (a cell left of `start`
// has never been computed).
template <int S, bool MASK, int s>
__device__ __forceinline__ void row_cell(float (&D)[S], float (&cw)[S], float a, float nxt,
                                         int hi) {
  float up = kBig;                       // the last cell's up is outside the band
  if constexpr (s + 1 < S) up = D[s + 1];
  float left = kBig;
  if constexpr (s > 0) left = D[s - 1];
  const float d = __fsub_rn(cw[s], a);
  float cur = __fadd_rn(__fmul_rn(d, d), fminf(fminf(D[s], up), left));
  if constexpr (MASK) cur = s > hi ? kBig : cur;   // column >= n
  D[s] = cur;
  if constexpr (s + 1 < S) cw[s] = cw[s + 1]; else cw[s] = nxt;
}

#define DTW_CELL(s) case s: row_cell<S, MASK, s>(D, cw, a, nxt, hi);
#define DTW_CELL4(s) DTW_CELL(s) DTW_CELL(s + 1) DTW_CELL(s + 2) DTW_CELL(s + 3)
#define DTW_CELL16(s) DTW_CELL4(s) DTW_CELL4(s + 4) DTW_CELL4(s + 8) DTW_CELL4(s + 12)

// Cells [start, S) of one row, left to right: the switch jumps to `start`
// and falls through the rest.
template <int S, bool MASK>
__device__ __forceinline__ void row_cells(float (&D)[S], float (&cw)[S], float a, float nxt,
                                          int start, int hi) {
  static_assert(S == 17 || S == 33 || S == 65, "dtw_rows_kernel instances: 17, 33, 65 cells");
  if constexpr (S == 17) {
    switch (start) { DTW_CELL16(0) DTW_CELL(16) }
  } else if constexpr (S == 33) {
    switch (start) { DTW_CELL16(0) DTW_CELL16(16) DTW_CELL(32) }
  } else {
    switch (start) { DTW_CELL16(0) DTW_CELL16(16) DTW_CELL16(32) DTW_CELL16(48) DTW_CELL(64) }
  }
}

#undef DTW_CELL16
#undef DTW_CELL4
#undef DTW_CELL

// Row i of a tile starting at row i0, among the band's first or last rows:
// entered at its first cell in the band and the matrix, masked past column
// n - 1 where the band passes it.
template <int S>
__device__ __forceinline__ void edge_row(float (&D)[S], float (&cw)[S], const float* qt,
                                         const float* tt, int i, int i0, int n, int band,
                                         int base) {
  const float a = qt[i - i0], nxt = tt[i - i0];
  const int start = base + max(0, band - i);         // column 0 or the band's left edge
  if (i + band < n) {
    row_cells<S, false>(D, cw, a, nxt, start, 0);
  } else {
    row_cells<S, true>(D, cw, a, nxt, start, base + n - 1 - i + band);
  }
}

// Rows [r0, r1) of a tile that lie inside the matrix's middle (every band
// cell in the matrix, so each row starts at B0 = S - W): the cells of a row
// in one straight line, without the switch.
template <int S, int B0>
__device__ __forceinline__ void middle_rows(float (&D)[S], float (&cw)[S], const float* qt,
                                            const float* tt, int r0, int r1) {
  if constexpr (B0 < S) {
    for (int r = r0; r < r1; ++r) {
      const float a = qt[r], nxt = tt[r];
#pragma unroll
      for (int s = B0; s < S; ++s) {
        const float up = s + 1 < S ? D[s + 1 < S ? s + 1 : s] : kBig;
        const float left = s > 0 ? D[s > 0 ? s - 1 : 0] : kBig;
        const float d = __fsub_rn(cw[s], a);
        D[s] = __fadd_rn(__fmul_rn(d, d), fminf(fminf(D[s], up), left));
        cw[s] = s + 1 < S ? cw[s + 1 < S ? s + 1 : s] : nxt;
      }
    }
  }
}

#define DTW_MID(b) case b: middle_rows<S, b>(D, cw, qt, tt, r0, r1); return true;
#define DTW_MID8(b) DTW_MID(b) DTW_MID(b + 2) DTW_MID(b + 4) DTW_MID(b + 6)
#define DTW_MID32(b) DTW_MID8(b) DTW_MID8(b + 8) DTW_MID8(b + 16) DTW_MID8(b + 24)

// middle_rows at the launch's base, S - W: even (S and W are odd), and in
// [0, 16], [0, 14], [0, 30] for the bands the instances of 17, 33, 65
// cells take (0-8, 9-16, 17-32). False for any other base: the caller then
// runs the rows one by one.
template <int S>
__device__ __forceinline__ bool middle_rows_at(int base, float (&D)[S], float (&cw)[S],
                                               const float* qt, const float* tt, int r0,
                                               int r1) {
  if constexpr (S == 17) {
    switch (base) { DTW_MID8(0) DTW_MID8(8) DTW_MID(16) default: return false; }
  } else if constexpr (S == 33) {
    switch (base) { DTW_MID8(0) DTW_MID8(8) default: return false; }
  } else {
    switch (base) { DTW_MID32(0) default: return false; }
  }
}

#undef DTW_MID32
#undef DTW_MID8
#undef DTW_MID

template <int S>
__global__ void __launch_bounds__(kRowThreads)
dtw_rows_kernel(const float* __restrict__ query,   // (Q, n)
                const float* __restrict__ cands,   // (Q, B, n)
                float* __restrict__ out,           // (Q, B)
                int num_cands, int n, int band) {
  // the column each row's last cell brings in (i + 1 + band) and the query
  // value, kTile rows at a time, staged coalesced: [pair][row], pitch
  // kTile + 1 (a row's reads, one column across the pairs, hit 32 banks)
  __shared__ float tile[kRowThreads][kTile + 1];
  __shared__ float qtile[kTile];
  const long long q = blockIdx.y;
  const long long c0 = static_cast<long long>(blockIdx.x) * kRowThreads;
  const int t = threadIdx.x;
  const int valid = static_cast<int>(min(static_cast<long long>(kRowThreads), num_cands - c0));
  const float* qrow = query + q * n;
  const float* cbase = cands + (q * num_cands + c0) * n;
  const float* crow = cbase + static_cast<long long>(min(t, valid - 1)) * n;
  const int W = 2 * band + 1;
  const int base = S - W;                  // cell s holds band offset o = s - base
  float D[S], cw[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    D[s] = (s == base + band) ? 0.0f : kBig;         // row -1
    const int j = max(0, s - base - band);           // its column when it joins the matrix
    cw[s] = j < n ? __ldg(crow + j) : 0.0f;
  }
  const int lane = t & 31, warp = t >> 5;
  int i0 = 0;
  do {                                               // n >= 1: one tile at least
    __syncthreads();                                 // the last tile is read
    const int col0 = i0 + 1 + band;
    const bool in = col0 + lane < n;
    for (int r = warp; r < kRowThreads; r += kRowThreads / 32) {
      tile[r][lane] = (in && r < valid) ? __ldg(cbase + static_cast<long long>(r) * n +
                                                col0 + lane) : 0.0f;
    }
    if (warp == 0) qtile[lane] = i0 + lane < n ? __ldg(qrow + i0 + lane) : 0.0f;
    __syncthreads();
    const int i1 = min(n, i0 + kTile);
    // the band's first rows [i0, m0), its middle [m0, m1), its last [m1, i1)
    const int m0 = min(max(i0, band), i1), m1 = max(m0, min(i1, n - band));
    for (int i = i0; i < m0; ++i) edge_row<S>(D, cw, qtile, tile[t], i, i0, n, band, base);
    if (m0 < m1 && !middle_rows_at<S>(base, D, cw, qtile, tile[t], m0 - i0, m1 - i0)) {
      for (int i = m0; i < m1; ++i) edge_row<S>(D, cw, qtile, tile[t], i, i0, n, band, base);
    }
    for (int i = m1; i < i1; ++i) edge_row<S>(D, cw, qtile, tile[t], i, i0, n, band, base);
    i0 += kTile;
  } while (i0 < n);
  float res = kBig;
#pragma unroll
  for (int s = 0; s < S; ++s) res = (s == base + band) ? D[s] : res;   // o = band
  if (t < valid) out[q * num_cands + c0 + t] = res;
}

// dtw_lanes_kernel's shared rows are padded with zeros so that every read
// of a step (columns i + 1 - band + [0, 64) for rows i + 1 in [-16, n + 16],
// band <= 31) stays inside its row without a bounds check.
constexpr int kPadL = 64, kPadR = 96, kQPad = 32;

// Shared memory of a dtw_lanes_kernel<., G> block: the query row and the
// block's 2 kLaneThreads / G candidate rows, padded.
size_t lane_smem_bytes(int n, int G) {
  return sizeof(float) * ((static_cast<size_t>(n) + kPadL + kPadR) * (2 * kLaneThreads / G) +
                          n + 2 * kQPad);
}

// One step of one lane of dtw_lanes_kernel on one of its pairs: row i of
// that pair (EDGE: nothing where i is outside [0, n); without EDGE every
// lane's row is inside), then the next row's operands; publishes the lane's
// first and last cells for its neighbours' next step.
template <int S, int G, bool EDGE>
__device__ __forceinline__ void lane_step(float (&D)[S], float (&cn)[S], float& an,
                                          const float* crow, const float* qrow, int i, int n,
                                          int band, int cap, int o0, bool first, bool last,
                                          float& pub_first, float& pub_last) {
  float left = __shfl_up_sync(0xffffffffu, pub_last, 1, G);
  float up_in = __shfl_down_sync(0xffffffffu, pub_first, 1, G);
  left = first ? kBig : left;                        // o = -1: left of the band
  up_in = last ? kBig : up_in;                       // o = S G >= W: right of it
  const int j0 = i - band + o0;                      // cell 0's column
  const int lo = -j0, lim = min(cap, n - j0);        // live cells: lo <= s < lim
  if (!EDGE || (i >= 0 && i < n)) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool live = s >= lo && s < lim;
      const float up = (s + 1 < S) ? D[s + 1 < S ? s + 1 : s] : up_in;
      const float d = __fsub_rn(cn[s], an);
      const float cur = __fadd_rn(__fmul_rn(d, d), fminf(fminf(D[s], up), left));
      D[s] = live ? cur : kBig;
      left = D[s];
    }
  }
  an = qrow[i + 1];                                  // row i + 1's operands (padded rows)
#pragma unroll
  for (int s = 0; s < S; ++s) cn[s] = crow[j0 + 1 + s];
  pub_first = D[0];
  pub_last = D[S - 1];
}

template <int S, int G>
__global__ void __launch_bounds__(kLaneThreads)
dtw_lanes_kernel(const float* __restrict__ query,   // (Q, n)
                 const float* __restrict__ cands,   // (Q, B, n)
                 float* __restrict__ out,           // (Q, B)
                 int num_cands, int n, int band) {
  static_assert(G == 16 || G == 32, "G: 16 or 32 lanes a pair");
  static_assert(S * G <= kPadL, "the padding covers 64 band cells");
  constexpr int kPairs = 2 * kLaneThreads / G;      // pairs a block
  extern __shared__ float smem[];
  const int pitch = n + kPadL + kPadR;
  float* qs = smem + kQPad;                          // n, kQPad zeros each side
  float* cs = smem + n + 2 * kQPad + kPadL;          // kPairs rows of pitch
  const long long q = blockIdx.y;
  const long long p0 = static_cast<long long>(blockIdx.x) * kPairs;
  const int rows = static_cast<int>(min(static_cast<long long>(kPairs), num_cands - p0));
  const float* src = cands + (q * num_cands + p0) * n;
  for (int e = threadIdx.x; e < n + 2 * kQPad; e += kLaneThreads) {
    const int j = e - kQPad;
    qs[j] = (j >= 0 && j < n) ? query[q * n + j] : 0.0f;
  }
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    const float* srow = src + static_cast<long long>(r) * n;
    for (int j = static_cast<int>(threadIdx.x) - kPadL; j < n + kPadR; j += kLaneThreads) {
      cs[r * pitch + j] = (j >= 0 && j < n) ? srow[j] : 0.0f;
    }
  }
  __syncthreads();
  const int g = threadIdx.x & (G - 1);
  const int grp = threadIdx.x / G;
  const bool odd = g & 1;
  const bool first = g == 0, last = g == G - 1;
  // phase 0 of every step takes pair 2 grp + odd, phase 1 the other
  const int l1 = 2 * grp + (odd ? 1 : 0), l2 = 2 * grp + (odd ? 0 : 1);
  const float* c1 = cs + min(l1, rows - 1) * pitch;  // a pair past the end reads a real row
  const float* c2 = cs + min(l2, rows - 1) * pitch;
  const int o0 = g * S;
  const int cap = 2 * band + 1 - o0;                 // cells past W: s >= cap
  const int h = g >> 1, h1 = h + (odd ? 1 : 0);
  float D1[S], D2[S], cn1[S], cn2[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    D1[s] = D2[s] = (o0 + s == band) ? 0.0f : kBig;  // row -1
    cn1[s] = cn2[s] = 0.0f;
  }
  float an1 = 0.0f, an2 = 0.0f;
  float pub_first = D1[0], pub_last = D1[S - 1];
  // lane g: row k - h1 of its phase-0 pair and row k - h of its phase-1 pair
  // at step k, i.e. row i at step 2 i + g (pair A) or 2 i + g + 1 (B);
  // every lane's rows lie inside [0, n) for k in [G / 2, n)
  lane_step<S, G, true>(D1, cn1, an1, c1, qs, -h1 - 1, n, band, cap, o0, first, last,
                        pub_first, pub_last);        // loads only: row -h1's operands
  lane_step<S, G, true>(D2, cn2, an2, c2, qs, -h - 1, n, band, cap, o0, first, last,
                        pub_first, pub_last);
  pub_first = D1[0];
  pub_last = D1[S - 1];
  for (int k = 0; k < G / 2; ++k) {
    lane_step<S, G, true>(D1, cn1, an1, c1, qs, k - h1, n, band, cap, o0, first, last,
                          pub_first, pub_last);
    lane_step<S, G, true>(D2, cn2, an2, c2, qs, k - h, n, band, cap, o0, first, last,
                          pub_first, pub_last);
  }
  for (int k = G / 2; k < n; ++k) {
    lane_step<S, G, false>(D1, cn1, an1, c1, qs, k - h1, n, band, cap, o0, first, last,
                           pub_first, pub_last);
    lane_step<S, G, false>(D2, cn2, an2, c2, qs, k - h, n, band, cap, o0, first, last,
                           pub_first, pub_last);
  }
  for (int k = max(G / 2, n); k < n + G / 2; ++k) {
    lane_step<S, G, true>(D1, cn1, an1, c1, qs, k - h1, n, band, cap, o0, first, last,
                          pub_first, pub_last);
    lane_step<S, G, true>(D2, cn2, an2, c2, qs, k - h, n, band, cap, o0, first, last,
                          pub_first, pub_last);
  }
  if (g == band / S) {                               // the lane of o = band
    float r1 = kBig, r2 = kBig;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      r1 = (o0 + s == band) ? D1[s] : r1;
      r2 = (o0 + s == band) ? D2[s] : r2;
    }
    if (l1 < rows) out[q * num_cands + p0 + l1] = r1;
    if (l2 < rows) out[q * num_cands + p0 + l2] = r2;
  }
}

template <int S>
int launch_rows(const float* query, const float* cands, float* out, int num_queries,
                int num_cands, int n, int band, void* stream) {
  const dim3 grid((num_cands + kRowThreads - 1) / kRowThreads, num_queries);
  dtw_rows_kernel<S><<<grid, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      query, cands, out, num_cands, n, band);
  return cudaGetLastError();
}

template <int S, int G>
int launch_lanes_s(const float* query, const float* cands, float* out, int num_queries,
                   int num_cands, int n, int band, void* stream) {
  constexpr int kPairs = 2 * kLaneThreads / G;
  const size_t smem = lane_smem_bytes(n, G);
  if (smem > kSmemMax) return -1;
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        dtw_lanes_kernel<S, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((num_cands + kPairs - 1) / kPairs, num_queries);
  dtw_lanes_kernel<S, G><<<grid, kLaneThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      query, cands, out, num_cands, n, band);
  return cudaGetLastError();
}

template <int G>
int launch_lanes(const float* query, const float* cands, float* out, int num_queries,
                 int num_cands, int n, int band, void* stream) {
  if (2 * band + 1 <= 32) {
    return launch_lanes_s<32 / G, G>(query, cands, out, num_queries, num_cands, n, band, stream);
  }
  return launch_lanes_s<64 / G, G>(query, cands, out, num_queries, num_cands, n, band, stream);
}

}  // namespace

// out (Q, B) <- banded DTW of query row q against its candidates
// cands[q] (B, n), all float32 and contiguous. Returns 0, a CUDA error code,
// or -1 when even one thread a block cannot hold a band row and a tile in
// shared memory (n and band too large).
extern "C" int dtw_band_f32(const float* query, const float* cands, float* out,
                            int num_queries, int num_cands, int n, int band,
                            void* stream) {
  if (num_queries <= 0 || num_cands <= 0) return 0;
  if (n <= 0 || band < 0 || num_queries > 65535) return cudaErrorInvalidValue;
  if (band > n - 1) band = n - 1;                    // a wider band adds no cell
  int threads = kMaxThreads;
  while (threads > 32 && smem_bytes(n, band, threads) > kSmemDefault) threads >>= 1;
  while (threads > 1 && smem_bytes(n, band, threads) > kSmemMax) threads >>= 1;
  const size_t smem = smem_bytes(n, band, threads);
  if (smem > kSmemMax) return -1;
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        dtw_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((num_cands + threads - 1) / threads, num_queries);
  dtw_band_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      query, cands, out, num_cands, n, band);
  return cudaGetLastError();
}

// v2 of the above (same operands and result): lanes = 1 takes
// dtw_rows_kernel (band <= 32), lanes = 16 or 32 dtw_lanes_kernel (band <=
// 31), after band is clamped to n - 1. Returns 0, a CUDA error
// code, or -1 when no instance takes (band, lanes) or a lane block's rows
// do not fit in shared memory (lane_smem_bytes).
extern "C" int dtw_band_v2_f32(const float* query, const float* cands, float* out,
                               int num_queries, int num_cands, int n, int band, int lanes,
                               void* stream) {
  if (num_queries <= 0 || num_cands <= 0) return 0;
  if (n <= 0 || band < 0 || num_queries > 65535) return cudaErrorInvalidValue;
  if (band > n - 1) band = n - 1;
  switch (lanes) {
    case 1:
      if (band <= 8) return launch_rows<17>(query, cands, out, num_queries, num_cands, n, band, stream);
      if (band <= 16) return launch_rows<33>(query, cands, out, num_queries, num_cands, n, band, stream);
      if (band <= 32) return launch_rows<65>(query, cands, out, num_queries, num_cands, n, band, stream);
      return -1;
    case 16:
      if (band > 31) return -1;
      return launch_lanes<16>(query, cands, out, num_queries, num_cands, n, band, stream);
    case 32:
      if (band > 31) return -1;
      return launch_lanes<32>(query, cands, out, num_queries, num_cands, n, band, stream);
    default:
      return -1;
  }
}
