// Squared-Euclidean-distance scans for Hopper (sm_90a), on one tile core:
// ed_matrix, the fused bf16 decode + ED decode_bf16_ed_matrix, and the
// fused 1-NN ed_min.
//
// Replaces: src/repro/kernels/ed.py::ed_matrix (_ed_matrix_kernel),
// src/repro/kernels/ops.py::decode_bf16_ed_matrix (the bf16 payload bitcast
// fed to _ed_matrix_kernel) -- both by ed_tiles with the StoreDists
// epilogue -- and src/repro/kernels/ed.py::ed_min (_ed_min_kernel) by
// ed_tiles with the FoldMin epilogue and by ed_min_resident.
//
// Arithmetic, the same in every kernel here: ||q - s||^2 = ||q||^2 +
// ||s||^2 - 2 q.s, where q.s and each squared norm is one fmaf chain over k
// ascending from 0.0f on the exactly widened values (bf16 -> float32 is
// bits << 16), in float32 outside the tensor cores (no TF32, no split-K),
// and out = (qn + sn) - 2 acc in three float32 operations (dist, never
// contracted into an FMA). kernels/ref.py::ed_matrix_fma_ref and
// ed_min_fma_ref repeat this arithmetic through a correctly rounded fmaf
// built from float64 operations, and hold every output here bit for bit
// (chip_smoke.py, tests/test_torch_gpu.py). The same arithmetic is why ed_min's minimum and
// argmin equal the row minimum and first argmin of ed_matrix.
//
// Bound on this card (67 TFLOP/s float32 FMA, 3.35 TB/s): 2*Q*N*n
// operations against (Q*n + N*n + Q*N) * 4 bytes (fewer for bf16 rows; Q*8
// out for ed_min), so float32 FMA bound at the main path's shapes (n = 256):
// Q=128 x N=4096 (a scan block, and ooc-local's per-leaf fold padded to 4096
// rows) 268,435,456 FLOP, 4.0 us, where launch latency is a large share;
// Q=128 x N=131,072 (an out-of-core block) 8.59 GFLOP, 0.128 ms; ed_min at
// Q=128 x N=4,194,304 (the k=1 scan) 275 GFLOP, 4.10 ms.
//
// The main loop (ed_tiles, k_step) answers four limits of the first tile
// core (a 64x64 tile of scalar loads, 19-33% of the bound):
// 1. Grid fill: tiles are chosen by shape. A grid of at least two waves of
//    128x128 tiles (Big: 8x8 a thread, 256 threads) runs those; smaller
//    grids run 64x64 tiles (Small: 4x4 a thread), 128 blocks at 128 x 4096.
// 2. Loads overlap arithmetic: a ring of STAGES shared-memory buffers is
//    filled by cp.async (16-byte cp.async.cg for float32 rows with n % 4 ==
//    0 and 16-byte aligned bases; 4-byte copies for bf16 rows, whose 2n + 4
//    byte payload pitch is only 4-byte aligned, so TMA, which needs 16-byte
//    multiple strides, cannot take it; 2-byte loads for odd n), one barrier
//    per 32-wide k-step, the next STAGES - 1 steps in flight under the FMAs.
// 3. Fewer shared-memory reads: tiles stay row-major as copied, a row
//    padded to an odd number of 16-byte (float32) or 8-byte (bf16) units so
//    the rows a warp reads fall in distinct banks, and each thread reads 4
//    consecutive k of a row at once (LDS.128, or LDS.64 of bf16 widened in
//    registers after the copy): TM + TN loads per 4*TM*TN FMAs (16 per 256
//    for Big).
// 4. Norms without a stall: thread t < BM + BN owns row t of the block's
//    queries, then series, and extends its chain from the staged tile in the
//    same k order beside its tile FMAs, with no branch (the row is picked by
//    address or by select), so no warp waits on another's norms.
// ed_matrix (v2, PR 14) at the main path's shapes: 0.0121 ms (4096 rows; 33% of the
// bound) and 0.229 (float32) / 0.245 ms (bf16 payload) at 131,072 rows (56%
// / 52%), device time (tools/kernel_ab.py, H100 80GB HBM3 at 700 W). From a
// Python loop, as the engine launches it, a 4096-row call takes 0.02-0.03
// ms: there the host sets the pace.
//
// ed_min cannot carry a running (min, argmin) across blocks the way the TPU
// grid does, because blocks run in parallel in no order. Each block folds
// its distances to one 64-bit key per query and folds that into the query's
// word with atomicMin: the high 32 bits are the distance (+ 0.0f, so -0.0
// ties +0.0) mapped to an order-preserving unsigned key, the low 32 bits the
// column index. The smallest key is the smallest distance and, among equal
// distances, the lowest index; the word starts at (+inf, 0), so an all-inf
// row reports index 0. Columns at or past valid_n are +inf. A thread takes
// the smallest key of its TN columns per query row, the 8 lanes of a query
// row fold by __shfl_xor_sync (4, 2, 1), the WARPS_N warp columns through
// shared memory, and one atomicMin per query row leaves the block. Two
// states of the kernel, bit for bit the same:
// A. ed_tiles with FoldMin: ed_matrix's Big or Small grid, the fold as the
//    epilogue, one block per tile.
// B. ed_min_resident (Q <= 128 where A would run Big tiles, n up to 320 for
//    float32 series and 384 for bf16): the whole query block and its norms
//    are staged once into shared memory (128 x 1,040 B at n = 256), and one
//    block per SM walks series tiles with a grid stride, streaming only
//    series rows through a 3-stage ring that runs on across tile
//    boundaries; each query row's best key stays in registers across tiles
//    and the block issues one atomicMin per query row at the end. That
//    halves the bytes staged per tile, runs the query norm chains once, and
//    leaves no pipeline bubble between tiles. Built with
//    -DED_MIN_TILES_ONLY (tools/kernel_ab.py --trial), state A runs
//    everywhere.
// Device time at Q=128, n=256 (tools/kernel_ab.py, H100 80GB HBM3 at 700
// W): the first tile core 11.908 ms at 4,194,304 rows and 0.394 ms at
// 131,072; state A 7.048 and 0.234; state B 6.573 (62% of the bound) and
// 0.222 (58%).
//
// decode_bf16_ed_matrix reads the bf16 codec's rows in place: row r of the
// encoded block starts at byte r * pitch (pitch = 2n + 4, the payload then
// the row's float32 error bound). Decoded rows exist only in registers,
// never in device memory, which is the point of the fusion; it also writes
// the decoded rows' squared norms as it computed them. The arithmetic's
// rounding error is what the out-of-core bounds' slack must cover.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kBK = 32;              // k per stage
constexpr int kMaxSmem = 232448;     // dynamic shared memory a block may use (H100)

// A block owns a BM x BN output tile, each thread a TM x TN register tile.
// A warp's lanes are 4 query rows x 8 series rows, so its tile is WM = 4*TM
// query rows x WN = 8*TN series rows: lane (ly, lx) of warp (wm, wn) holds
// query rows wm*WM + ly + 4*i and series rows wn*WN + lx + 8*j, and each
// shared-memory read of the warp touches 4 (queries) or 8 (series) distinct
// rows. The k axis goes kBK at a time through a ring of STAGES buffers.
template <int BM_, int BN_, int TM_, int TN_, int STAGES_>
struct TileCfg {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, STAGES = STAGES_;
  static constexpr int WM = 4 * TM, WN = 8 * TN, WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * (BM / WM) * WARPS_N;
  static_assert(BM % WM == 0 && BN % WN == 0, "warp tiles divide the block tile");
  static_assert(STAGES >= 2, "at least two stages");
  static_assert(BM + BN <= THREADS, "one norm row per thread");
};

// Chosen on the H100 with tools/kernel_ab.py: Big for grids of at least two
// waves of its 132 SMs (Q=128 x 131,072: 1024 blocks), Small below (Q=128 x
// 4096: 128 blocks). Resident: state B of ed_min, Big's warp tiling with a
// 3-stage series ring beside the resident queries.
using Big = TileCfg<128, 128, 8, 8, 4>;
using Small = TileCfg<64, 64, 4, 4, 3>;
using Resident = TileCfg<128, 128, 8, 8, 3>;
constexpr long long kBigMinTiles = 2 * 132;

// A staged row in shared memory: float32 in an odd number of 16-byte units
// (4*kBK + 16 bytes), or raw bf16 bits in an odd number of 8-byte units
// (2*kBK + 8 bytes), so the distinct rows a warp reads start in distinct
// banks. load4 reads 4 consecutive k of a row (LDS.128, or LDS.64 of bf16
// widened exactly in registers).
template <typename S>
struct Staged;
template <>
struct Staged<float> {
  static constexpr int kBytes = 4, kLd = 4 * kBK + 16;
  static __device__ __forceinline__ float4 load4(const unsigned char* row, int k) {
    return *reinterpret_cast<const float4*>(row + 4 * k);
  }
};
template <>
struct Staged<__nv_bfloat16> {
  static constexpr int kBytes = 2, kLd = 2 * kBK + 8;
  static __device__ __forceinline__ float4 load4(const unsigned char* row, int k) {
    const uint2 w = *reinterpret_cast<const uint2*>(row + 2 * k);
    return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xFFFF0000u),
                       __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xFFFF0000u));
  }
};

template <int VEC>
__device__ __forceinline__ void cp_async(unsigned char* dst, const unsigned char* src,
                                         int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if constexpr (VEC == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(VEC), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage ROWS rows of SEG bytes from `src` (row r at r * pitch) into `dst`
// (row r at r * ld) in VEC-byte pieces: rows at or past `rows` and bytes at
// or past `valid` of each row land as zeros. VEC 16 or 4 is cp.async (a
// zero-byte source fills with zeros); VEC 2 is a plain load and store.
template <int ROWS, int SEG, int VEC, int THREADS>
__device__ __forceinline__ void stage_rows(unsigned char* dst, int ld,
                                           const unsigned char* __restrict__ src,
                                           long long pitch, int rows, int valid) {
  constexpr int kPerRow = SEG / VEC;
  constexpr int kTotal = ROWS * kPerRow;
#pragma unroll
  for (int c0 = 0; c0 < kTotal; c0 += THREADS) {
    const int c = c0 + (int)threadIdx.x;
    if (kTotal % THREADS == 0 || c < kTotal) {
      const int r = c / kPerRow;
      const int off = (c % kPerRow) * VEC;
      const bool ok = r < rows && off < valid;
      const unsigned char* g = ok ? src + r * pitch + off : src;
      unsigned char* d = dst + r * ld + off;
      if constexpr (VEC == 2)
        *reinterpret_cast<uint16_t*>(d) = ok ? *reinterpret_cast<const uint16_t*>(g) : 0;
      else
        cp_async<VEC>(d, g, ok ? VEC : 0);
    }
  }
}

// One kBK-wide k-step of this thread: its TM x TN tile FMAs over the staged
// query rows `tq` (row pitch qld bytes) and series rows `ts`, and the next
// kBK links of its norm chain, over the staged row `nq_row` (a query row,
// where kQueryNorms and norm_of_q) or `ns_row` (a series row).
template <class C, typename S, bool kQueryNorms>
__device__ __forceinline__ void k_step(const unsigned char* __restrict__ tq, int qld,
                                       const unsigned char* __restrict__ ts, int qr, int sr,
                                       const unsigned char* nq_row,
                                       const unsigned char* ns_row, bool norm_of_q,
                                       float (&acc)[C::TM][C::TN], float& nrm) {
  constexpr int TM = C::TM, TN = C::TN, SLD = Staged<S>::kLd;
#pragma unroll
  for (int k = 0; k < kBK; k += 4) {
    // the norm row's next 4 k with no branch, so the chain interleaves with
    // the tile FMAs: float32 rows by a selected address, bf16 series rows
    // loaded beside the query row and selected value by value
    float4 v;
    if constexpr (!kQueryNorms) {
      v = Staged<S>::load4(ns_row, k);
    } else if constexpr (std::is_same_v<S, float>) {
      v = Staged<float>::load4(norm_of_q ? nq_row : ns_row, k);
    } else {
      const float4 vq = Staged<float>::load4(nq_row, k);
      const float4 vs = Staged<S>::load4(ns_row, k);
      v.x = norm_of_q ? vq.x : vs.x;
      v.y = norm_of_q ? vq.y : vs.y;
      v.z = norm_of_q ? vq.z : vs.z;
      v.w = norm_of_q ? vq.w : vs.w;
    }
    nrm = fmaf(v.x, v.x, nrm);
    nrm = fmaf(v.y, v.y, nrm);
    nrm = fmaf(v.z, v.z, nrm);
    nrm = fmaf(v.w, v.w, nrm);
    float4 a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = Staged<float>::load4(tq + (qr + 4 * i) * qld, k);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float4 b = Staged<S>::load4(ts + (sr + 8 * j) * SLD, k);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
      }
    }
  }
}

template <class C, typename S>
constexpr int tile_smem_bytes() {
  return C::STAGES * (C::BM * Staged<float>::kLd + C::BN * Staged<S>::kLd) +
         (C::BM + C::BN) * 4;
}

// out = (qn + sn) - 2 acc in three float32 operations, never contracted.
__device__ __forceinline__ float dist(float acc, float qn, float sn) {
  return __fsub_rn(__fadd_rn(qn, sn), __fmul_rn(2.0f, acc));
}

// float -> unsigned key with the same order (negatives below positives).
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_to_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// The 64-bit fold key of column `col`: order_key(d) << 32 | col, with d =
// dist + 0.0f (-0.0 -> +0.0), or +inf at or past valid_n.
__device__ __forceinline__ unsigned long long dist_key(float acc, float qn, float sn,
                                                       int col, int valid_n) {
  const float d = col < valid_n ? __fadd_rn(dist(acc, qn, sn), 0.0f)
                                : __int_as_float(0x7F800000);
  return ((unsigned long long)order_key(d) << 32) | (uint32_t)col;
}

__device__ __forceinline__ unsigned long long min_key(unsigned long long a,
                                                      unsigned long long b) {
  return b < a ? b : a;
}

// Fold each thread's smallest key per query row (rows qr + 4*i) across the
// block: the 8 lanes of a row by shuffles, the WARPS_N warp columns through
// `red` ([WARPS_N][BM] in shared memory no thread still reads), then one
// atomicMin per row below q_rows into best[row].
template <class C>
__device__ __forceinline__ void fold_block(unsigned long long (&key)[C::TM],
                                           unsigned long long* red, int qr, int q_rows,
                                           unsigned long long* __restrict__ best) {
  const int tid = threadIdx.x, lane = tid % 32, wn = (tid / 32) % C::WARPS_N;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      key[i] = min_key(key[i], __shfl_xor_sync(0xFFFFFFFFu, key[i], off));
    if (lane % 8 == 0) red[wn * C::BM + qr + 4 * i] = key[i];
  }
  __syncthreads();
  if (tid < q_rows) {
    unsigned long long w = red[tid];
#pragma unroll
    for (int c = 1; c < C::WARPS_N; ++c) w = min_key(w, red[c * C::BM + tid]);
    atomicMin(best + tid, w);
  }
}

// What ed_tiles leaves a block's tile to: this thread's acc (query rows
// qr + 4*i, series rows sr + 8*j), the tile's norms nq and ns in shared
// memory, and the ring (no thread reads it any more).
struct TileOut {
  int qr, sr, q0, s0, q_rows, s_rows;
  const float* nq;
  const float* ns;
  unsigned char* ring;
};

// ed_matrix's epilogue: the distances, and with kRowNorms the series rows'
// squared norms as computed here.
template <bool kRowNorms>
struct StoreDists {
  float* out;
  float* sn_out;
  int num_s;
  template <class C>
  __device__ __forceinline__ void operator()(const float (&acc)[C::TM][C::TN],
                                             const TileOut& t) const {
    if constexpr (kRowNorms) {
      if (blockIdx.y == 0 && (int)threadIdx.x < t.s_rows)
        sn_out[t.s0 + threadIdx.x] = t.ns[threadIdx.x];
    }
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const int r = t.qr + 4 * i;
      if (r >= t.q_rows) continue;
      const float qn = t.nq[r];
      float* const row = out + (long long)(t.q0 + r) * num_s + t.s0;
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        const int c = t.sr + 8 * j;
        if (c < t.s_rows) row[c] = dist(acc[i][j], qn, t.ns[c]);
      }
    }
  }
};

// ed_min's state A epilogue: the tile's smallest key per query row, folded
// into best[].
struct FoldMin {
  unsigned long long* best;
  int valid_n;
  template <class C>
  __device__ __forceinline__ void operator()(const float (&acc)[C::TM][C::TN],
                                             const TileOut& t) const {
    unsigned long long key[C::TM];
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const float qn = t.nq[t.qr + 4 * i];
      key[i] = ~0ull;
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        const int c = t.sr + 8 * j;
        key[i] = min_key(key[i], dist_key(acc[i][j], qn, t.ns[c], t.s0 + c, valid_n));
      }
    }
    fold_block<C>(key, reinterpret_cast<unsigned long long*>(t.ring), t.qr, t.q_rows,
                  best + t.q0);
  }
};

__global__ void ed_min_init(unsigned long long* best, int num_q) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < num_q)
    best[i] = (unsigned long long)order_key(__int_as_float(0x7F800000)) << 32;
}

__global__ void ed_min_finish(const unsigned long long* __restrict__ best,
                              float* __restrict__ dmin, int* __restrict__ amin,
                              int num_q) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < num_q) {
    const unsigned long long w = best[i];
    dmin[i] = key_to_float((uint32_t)(w >> 32));
    amin[i] = (int)(uint32_t)(w & 0xFFFFFFFFull);
  }
}

// One block per (q0, s0) tile: (Q, n) float32 queries x N series rows of n
// elements of S (float32, or bf16 bits) at a byte pitch, staged through the
// ring, q.s and both tiles' squared norms; then `epi` (StoreDists for
// ed_matrix and decode_bf16_ed_matrix, FoldMin for ed_min's state A).
// QVEC and SVEC are the copy widths in bytes for the query and series rows.
template <class C, typename S, int QVEC, int SVEC, class Epi>
__global__ void __launch_bounds__(C::THREADS, 1)
ed_tiles(const float* __restrict__ q, const unsigned char* __restrict__ s, long long pitch,
         int num_q, int num_s, int n, Epi epi) {
  constexpr int BM = C::BM, BN = C::BN, TM = C::TM, TN = C::TN;
  constexpr int QLD = Staged<float>::kLd, SLD = Staged<S>::kLd, ES = Staged<S>::kBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const sq = smem;                               // [STAGES][BM][QLD]
  unsigned char* const ss = smem + C::STAGES * BM * QLD;        // [STAGES][BN][SLD]
  float* const nq = reinterpret_cast<float*>(ss + C::STAGES * BN * SLD);   // [BM]
  float* const ns = nq + BM;                                               // [BN]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int qr = (warp / C::WARPS_N) * C::WM + lane / 8;   // query rows qr + 4*i
  const int sr = (warp % C::WARPS_N) * C::WN + lane % 8;   // series rows sr + 8*j
  const int q0 = blockIdx.y * BM, s0 = blockIdx.x * BN;
  const int q_rows = min(BM, num_q - q0), s_rows = min(BN, num_s - s0);
  const unsigned char* const qsrc =
      reinterpret_cast<const unsigned char*>(q) + (long long)q0 * n * 4;
  const unsigned char* const ssrc = s + (long long)s0 * pitch;
  const int steps = (n + kBK - 1) / kBK;

  auto stage = [&](int step) {
    const int buf = step % C::STAGES, k0 = step * kBK;
    stage_rows<BM, 4 * kBK, QVEC, C::THREADS>(sq + buf * BM * QLD, QLD, qsrc + 4 * k0,
                                              4LL * n, q_rows, 4 * (n - k0));
    stage_rows<BN, ES * kBK, SVEC, C::THREADS>(ss + buf * BN * SLD, SLD, ssrc + ES * k0,
                                               pitch, s_rows, ES * (n - k0));
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  // thread tid < BM + BN owns the squared norm of query row tid, or of
  // series row tid - BM (the others compute a copy that is never stored)
  float nrm = 0.0f;
  const bool norm_of_q = tid < BM;
  const int nq_row = min(tid, BM - 1), ns_row = min(max(tid - BM, 0), BN - 1);

#pragma unroll
  for (int p = 0; p < C::STAGES - 1; ++p) {
    if (p < steps) stage(p);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();   // step landed for every thread; step - 1's buffer is free
    if (step + C::STAGES - 1 < steps) stage(step + C::STAGES - 1);
    cp_async_commit();
    const int buf = step % C::STAGES;
    const unsigned char* const tq = sq + buf * BM * QLD;
    const unsigned char* const ts = ss + buf * BN * SLD;
    k_step<C, S, true>(tq, QLD, ts, qr, sr, tq + nq_row * QLD, ts + ns_row * SLD, norm_of_q,
                       acc, nrm);
  }
  if (tid < BM)
    nq[tid] = nrm;
  else if (tid < BM + BN)
    ns[tid - BM] = nrm;
  __syncthreads();   // the norms are in; no thread reads the ring any more
  epi.template operator()<C>(acc, TileOut{qr, sr, q0, s0, q_rows, s_rows, nq, ns, smem});
}

// Row pitch in bytes of the resident query block: n rounded up to whole
// k-steps, plus 16 bytes, an odd number of 16-byte units.
__host__ __device__ constexpr int resident_qld(int n) {
  return 4 * kBK * ((n + kBK - 1) / kBK) + 16;
}

template <typename S>
constexpr int resident_ring_bytes() {
  using C = Resident;
  return C::STAGES * C::BN * Staged<S>::kLd + (C::BM + C::BN) * 4 +
         C::WARPS_N * C::BM * 8;
}

template <typename S>
int resident_smem_bytes(int n) {
  return Resident::BM * resident_qld(n) + resident_ring_bytes<S>();
}

// State B: num_q <= BM queries staged once with their norms; block b walks
// series tiles b, b + gridDim.x, ..., their k-steps flattened into one
// sequence through the ring, so the next tile's first steps load under the
// current tile's last FMAs and its fold. Each thread keeps its TM query
// rows' smallest keys across tiles and the block folds them once at the end.
template <typename S, int QVEC, int SVEC>
__global__ void __launch_bounds__(Resident::THREADS, 1)
ed_min_resident(const float* __restrict__ q, const unsigned char* __restrict__ s,
                long long pitch, unsigned long long* __restrict__ best, int num_q,
                int num_s, int n, int valid_n) {
  using C = Resident;
  constexpr int BM = C::BM, BN = C::BN, TM = C::TM, TN = C::TN;
  constexpr int SLD = Staged<S>::kLd, ES = Staged<S>::kBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  const int qld = resident_qld(n);
  unsigned char* const sq = smem;                                     // [BM][qld]
  unsigned char* const ss = smem + BM * qld;                          // [STAGES][BN][SLD]
  float* const nq = reinterpret_cast<float*>(ss + C::STAGES * BN * SLD);   // [BM]
  float* const ns = nq + BM;                                               // [BN]
  unsigned long long* const red = reinterpret_cast<unsigned long long*>(ns + BN);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int qr = (warp / C::WARPS_N) * C::WM + lane / 8;
  const int sr = (warp % C::WARPS_N) * C::WN + lane % 8;
  const int steps = (n + kBK - 1) / kBK;
  const int tiles = (num_s + BN - 1) / BN;
  const int mine = tiles > (int)blockIdx.x ? (tiles - 1 - (int)blockIdx.x) / gridDim.x + 1 : 0;
  const int total = mine * steps;

  // the queries, whole rows, in one copy group ahead of the ring's
  const unsigned char* const qsrc = reinterpret_cast<const unsigned char*>(q);
  for (int st = 0; st < steps; ++st)
    stage_rows<BM, 4 * kBK, QVEC, C::THREADS>(sq + 4 * kBK * st, qld, qsrc + 4 * kBK * st,
                                              4LL * n, num_q, 4 * (n - kBK * st));
  cp_async_commit();

  // series k-step g of this block: tile blockIdx.x + (g / steps) * gridDim.x,
  // k-step g % steps; staged in order, so counters replace the division
  int st_tile = blockIdx.x, st_k = 0;
  auto stage_next = [&](int g) {
    const int s0 = st_tile * BN, k0 = st_k * kBK;
    stage_rows<BN, ES * kBK, SVEC, C::THREADS>(
        ss + (g % C::STAGES) * BN * SLD, SLD, s + (long long)s0 * pitch + ES * k0, pitch,
        min(BN, num_s - s0), ES * (n - k0));
    if (++st_k == steps) {
      st_k = 0;
      st_tile += gridDim.x;
    }
  };
#pragma unroll
  for (int p = 0; p < C::STAGES - 1; ++p) {
    if (p < total) stage_next(p);
    cp_async_commit();
  }

  // the query norms, once: every group but the queries' may still fly
  cp_async_wait<C::STAGES - 1>();
  __syncthreads();
  if (tid < BM) {
    const unsigned char* const row = sq + tid * qld;
    float nrm = 0.0f;
    for (int k = 0; k < steps * kBK; k += 4) {
      const float4 v = Staged<float>::load4(row, k);
      nrm = fmaf(v.x, v.x, nrm);
      nrm = fmaf(v.y, v.y, nrm);
      nrm = fmaf(v.z, v.z, nrm);
      nrm = fmaf(v.w, v.w, nrm);
    }
    nq[tid] = nrm;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  unsigned long long key[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) key[i] = ~0ull;
  float nrm = 0.0f;   // of series row tid % BN (threads tid >= BN: a copy)
  const int ns_row = tid % BN;
  int k_at = 0, s0 = blockIdx.x * BN;

  for (int g = 0; g < total; ++g) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();   // step g landed for every thread; step g - 1's buffer is free
    if (g + C::STAGES - 1 < total) stage_next(g + C::STAGES - 1);
    cp_async_commit();
    const unsigned char* const ts = ss + (g % C::STAGES) * BN * SLD;
    k_step<C, S, false>(sq + 4 * kBK * k_at, qld, ts, qr, sr, nullptr, ts + ns_row * SLD,
                        false, acc, nrm);
    if (++k_at == steps) {   // the tile's last k-step: fold it into the keys
      if (tid < BN) ns[tid] = nrm;
      __syncthreads();
      float sn[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) sn[j] = ns[sr + 8 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float qn = nq[qr + 4 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          key[i] = min_key(key[i], dist_key(acc[i][j], qn, sn[j], s0 + sr + 8 * j, valid_n));
          acc[i][j] = 0.0f;
        }
      }
      nrm = 0.0f;
      k_at = 0;
      s0 += gridDim.x * BN;
    }
  }
  fold_block<C>(key, red, qr, num_q, best);
}

// Opt `kernel` into `bytes` of dynamic shared memory, once per device (a
// bit per device id in `done`): setting it at every launch cost time.
template <typename Kernel>
cudaError_t smem_opt_in(Kernel kernel, int bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(done.load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done.fetch_or(bit);
  }
  return cudaSuccess;
}

dim3 tile_grid(int bm, int bn, int num_q, int num_s) {
  return dim3((unsigned)((num_s + bn - 1) / bn), (unsigned)((num_q + bm - 1) / bm));
}

template <class C, typename S, int QVEC, int SVEC, class Epi>
int launch_tiles(const float* q, const void* s, long long pitch, int num_q, int num_s,
                 int n, Epi epi, cudaStream_t stream) {
  constexpr int bytes = tile_smem_bytes<C, S>();
  static_assert(C::WARPS_N * C::BM * 8 <= bytes, "FoldMin's keys fit in the ring");
  auto kernel = ed_tiles<C, S, QVEC, SVEC, Epi>;
  static std::atomic<unsigned long long> done{0};
  const cudaError_t err = smem_opt_in(kernel, bytes, done);
  if (err != cudaSuccess) return (int)err;
  kernel<<<tile_grid(C::BM, C::BN, num_q, num_s), C::THREADS, bytes, stream>>>(
      q, static_cast<const unsigned char*>(s), pitch, num_q, num_s, n, epi);
  return (int)cudaGetLastError();
}

int sm_count() {
  static std::atomic<int> counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int v = counts[dev & 63].load();
  if (v == 0 &&
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
    counts[dev & 63].store(v);
  return v;
}

template <typename S, int QVEC, int SVEC>
int launch_min_resident(const float* q, const void* s, long long pitch,
                        unsigned long long* best, int num_q, int num_s, int n, int valid_n,
                        cudaStream_t stream) {
  auto kernel = ed_min_resident<S, QVEC, SVEC>;
  static std::atomic<unsigned long long> done{0};
  const cudaError_t err = smem_opt_in(kernel, kMaxSmem, done);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (num_s + Resident::BN - 1) / Resident::BN;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  kernel<<<min(tiles, sms), Resident::THREADS, resident_smem_bytes<S>(n), stream>>>(
      q, static_cast<const unsigned char*>(s), pitch, best, num_q, num_s, n, valid_n);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, unsigned a) { return reinterpret_cast<uintptr_t>(p) % a == 0; }

bool big_grid(int num_q, int num_s) {
  return (long long)((num_q + Big::BM - 1) / Big::BM) * ((num_s + Big::BN - 1) / Big::BN) >=
         kBigMinTiles;
}

// Copy widths in bytes (queries, series rows): the fast ones where n % 4 ==
// 0, the queries are 16-byte aligned and the series rows kS-byte aligned at
// their pitch (float32: 16-byte cp.async.cg; bf16 rows at the codec's 2n + 4
// pitch: 4-byte copies); the slow ones otherwise (odd n, or views only 4-
// or 2-byte aligned), in Small tiles.
template <typename S>
struct Copies;
template <>
struct Copies<float> {
  static constexpr int kQ = 16, kS = 16, kSlowQ = 4, kSlowS = 4;
};
template <>
struct Copies<__nv_bfloat16> {
  static constexpr int kQ = 16, kS = 4, kSlowQ = 4, kSlowS = 2;
};

template <typename S>
bool fast_copies(const float* q, const void* s, long long pitch, int n) {
  return n % 4 == 0 && aligned(q, 16) && aligned(s, Copies<S>::kS) &&
         pitch % Copies<S>::kS == 0;
}

// ed_tiles over the tiles and copy widths the shape and alignment allow:
// Big tiles for a grid of at least two waves with the fast copies, Small
// otherwise.
template <typename S, class Epi>
int launch_by_shape(const float* q, const void* s, long long pitch, int num_q, int num_s,
                    int n, Epi epi, cudaStream_t stream) {
  using K = Copies<S>;
  if (num_q <= 0 || num_s <= 0) return (int)cudaSuccess;
  if (!fast_copies<S>(q, s, pitch, n))
    return launch_tiles<Small, S, K::kSlowQ, K::kSlowS>(q, s, pitch, num_q, num_s, n, epi,
                                                        stream);
  if (big_grid(num_q, num_s))
    return launch_tiles<Big, S, K::kQ, K::kS>(q, s, pitch, num_q, num_s, n, epi, stream);
  return launch_tiles<Small, S, K::kQ, K::kS>(q, s, pitch, num_q, num_s, n, epi, stream);
}

// State B where A would run Big tiles with the fast copies and the query
// block fits beside the ring.
template <typename S>
bool resident(const float* q, const void* s, long long pitch, int num_q, int num_s, int n) {
#ifdef ED_MIN_TILES_ONLY
  return false;
#else
  return fast_copies<S>(q, s, pitch, n) && big_grid(num_q, num_s) &&
         num_q <= Resident::BM && resident_smem_bytes<S>(n) <= kMaxSmem;
#endif
}

// init (every word (+inf, 0)), the kernel over the series, finish (words to
// distances and indices).
template <typename S>
int launch_ed_min(const float* q, const void* s, long long pitch, unsigned long long* best,
                  float* dmin, int* amin, int num_q, int num_s, int n, int valid_n,
                  void* stream_) {
  if (num_q <= 0) return (int)cudaSuccess;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int fb = (num_q + 255) / 256;
  ed_min_init<<<fb, 256, 0, stream>>>(best, num_q);
  if (num_s > 0) {
    using K = Copies<S>;
    const int err =
        resident<S>(q, s, pitch, num_q, num_s, n)
            ? launch_min_resident<S, K::kQ, K::kS>(q, s, pitch, best, num_q, num_s, n,
                                                   valid_n, stream)
            : launch_by_shape<S>(q, s, pitch, num_q, num_s, n, FoldMin{best, valid_n},
                                 stream);
    if (err) return err;
  }
  ed_min_finish<<<fb, 256, 0, stream>>>(best, dmin, amin, num_q);
  return (int)cudaGetLastError();
}

}  // namespace

// (Q, n) float32 queries x (N, n) series -> (Q, N) float32 squared ED.
extern "C" int ed_matrix_f32(const float* q, const float* s, float* out, int num_q,
                             int num_s, int n, void* stream) {
  return launch_by_shape<float>(q, s, 4LL * n, num_q, num_s, n,
                                StoreDists<false>{out, nullptr, num_s},
                                static_cast<cudaStream_t>(stream));
}

extern "C" int ed_matrix_bf16(const float* q, const void* s, float* out, int num_q,
                              int num_s, int n, void* stream) {
  return launch_by_shape<__nv_bfloat16>(q, s, 2LL * n, num_q, num_s, n,
                                        StoreDists<false>{out, nullptr, num_s},
                                        static_cast<cudaStream_t>(stream));
}

// (Q, n) float32 queries x B bf16 rows of n elements, row r at byte
// r * pitch of `payload` -> (Q, B) float32 squared ED against the decoded
// rows, and the (B,) squared norms of the decoded rows into sn_out. pitch is
// even and >= 2n; payload is 2-byte aligned.
extern "C" int decode_bf16_ed_matrix(const float* q, const void* payload, long long pitch,
                                     float* out, float* sn_out, int num_q, int num_s,
                                     int n, void* stream) {
  return launch_by_shape<__nv_bfloat16>(q, payload, pitch, num_q, num_s, n,
                                        StoreDists<true>{out, sn_out, num_s},
                                        static_cast<cudaStream_t>(stream));
}

// Fused 1-NN: (Q,) float32 min squared ED and (Q,) int32 argmin over the
// first valid_n of N series. `scratch` is (Q,) uint64 owned by the caller.
extern "C" int ed_min_f32(const float* q, const float* s, unsigned long long* scratch,
                          float* dmin, int* amin, int num_q, int num_s, int n,
                          int valid_n, void* stream) {
  return launch_ed_min<float>(q, s, 4LL * n, scratch, dmin, amin, num_q, num_s, n, valid_n,
                              stream);
}

extern "C" int ed_min_bf16(const float* q, const void* s, unsigned long long* scratch,
                           float* dmin, int* amin, int num_q, int num_s, int n,
                           int valid_n, void* stream) {
  return launch_ed_min<__nv_bfloat16>(q, s, 2LL * n, scratch, dmin, amin, num_q, num_s, n,
                                      valid_n, stream);
}
