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
// depend on the order the cells are evaluated in. This kernel (row by row)
// and kernels/ref.py::dtw_band_ref (anti-diagonal wavefront) agree bit for
// bit, on the card and on the CPU.
//
// Bound: operations. About 5 FP32 operations a cell (subtract, multiply, two
// minima, add) over pairs * (n (2 band + 1) - band (band + 1)) cells, against
// pairs * n * 4 bytes of candidates read once: at 2^22 pairs, n = 256,
// band 13 that is 2.1 ms of FP32 issue (67 TFLOP/s) against 1.3 ms of HBM
// (3.35 TB/s).
//
// Design (simple first): one thread a (query, candidate) pair; a block holds
// T candidates of one query (blockIdx.y). The query row sits in shared
// memory (broadcast reads). Each thread keeps its DP row of W = 2 band + 1
// band cells in shared memory, offset-major ([o][t], conflict-free), plus a
// fixed out-of-matrix cell at o = W, and updates it in place: cell o of row
// i reads cells o (diagonal) and o + 1 (up) of row i - 1 and the cell just
// written (left, a register). Candidates are staged a tile of R = 32 DP
// rows at a time: the columns [i0 - band, i0 + R - 1 + band] of the block's
// T candidates, read by one group of up to 32 threads a candidate, lanes on
// consecutive columns (coalesced), stored column-major with a pitch of
// T + 1 (conflict-free on both sides). A cell costs three shared-memory
// accesses (the tile, the up cell, the store) beside its five FP32
// operations, so the kernel is expected well below the FP32 bound; the
// dependency through `left` serialises a thread's cells.
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
