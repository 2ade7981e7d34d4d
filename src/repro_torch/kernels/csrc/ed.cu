// Squared-Euclidean-distance scans for Hopper (sm_90a): ed_matrix and the
// fused bf16 decode + ED decode_bf16_ed_matrix (v2 below), and the fused
// 1-NN ed_min (v1's tile core, dot_tile).
//
// Replaces: src/repro/kernels/ed.py::ed_matrix (_ed_matrix_kernel),
// src/repro/kernels/ops.py::decode_bf16_ed_matrix (the bf16 payload bitcast
// fed to _ed_matrix_kernel) -- both by ed_matrix_v2 -- and
// src/repro/kernels/ed.py::ed_min (_ed_min_kernel) by ed_min_kernel.
//
// Arithmetic, the same in both tile cores: ||q - s||^2 = ||q||^2 + ||s||^2
// - 2 q.s, where q.s and each squared norm is one fmaf chain over k
// ascending from 0.0f on the exactly widened values (bf16 -> float32 is
// bits << 16), in float32 outside the tensor cores (no TF32, no split-K),
// and out = qn + sn - 2.0f * acc. So v2's outputs equal v1's bit for bit,
// and a row's minimum and lowest-index argmin over ed_matrix equal ed_min's.
//
// Bound on this card (67 TFLOP/s float32 FMA, 3.35 TB/s): 2*Q*N*n
// operations against (Q*n + N*n + Q*N) * 4 bytes (fewer for bf16 rows), so
// float32 FMA bound at both of the main path's shapes (n = 256): Q=128 x
// N=4096 (a scan block, and ooc-local's per-leaf fold padded to 4096 rows)
// 268,435,456 FLOP, 4.0 us, where launch latency is a large share; Q=128 x
// N=131,072 (an out-of-core block) 8.59 GFLOP, 0.128 ms.
//
// v1 (one 64x64 tile per 256-thread block, 16-wide k-steps, scalar loads)
// ran at 19-21% of the bound at 4096 rows and 32-33% at 131,072 (device
// time, tools/kernel_ab.py, H100 80GB HBM3 at 700 W). v2 answers its four
// limits:
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
// At the main path's shapes v2 takes 0.0121 ms (4096 rows; 33% of the
// bound) and 0.229 (float32) / 0.245 ms (bf16 payload) at 131,072 rows
// (56% / 52%), measured in one run with the v1 figures above. Launched
// from a Python loop, as the engine does, a 4096-row call takes 0.02-0.03
// ms with either core (the host sets the pace), so there v2's gain shows
// only in device time until those launches are batched into CUDA graphs.
//
// ed_min stays on v1's tile core, dot_tile, and is the standing witness of
// v2's arithmetic: it runs the other tile core on the same formula and fmaf
// order, so each row's minimum and lowest-index argmin over v2's ed_matrix
// equal ed_min's (chip_smoke.py and tests/test_torch_gpu.py hold them).
// Moving it onto v2's core, with its atomicMin fold, is a change of its own.
//
// ed_min cannot carry a running (min, argmin) across blocks the way the TPU
// grid does, because blocks run in parallel in no order. Each block reduces
// its tile to one (distance, index) per query and folds it into a 64-bit
// word per query with atomicMin: the high 32 bits are the distance mapped to
// an order-preserving unsigned key, the low 32 bits the column index. The
// smallest word is the smallest distance and, among equal distances, the
// lowest index; the word starts at (+inf, 0), so an all-inf row reports
// index 0. Columns at or past valid_n are +inf.
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

constexpr int BQ = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int TM = 4;   // query rows per thread: ty + 16*i
constexpr int TN = 4;   // series columns per thread: tx + 16*j

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Series loaders: element k of series row r, widened to float32.
template <typename T>
struct DenseRows {   // (N, n) row-major float32 or bfloat16
  const T* s;
  int n;
  __device__ __forceinline__ float operator()(int r, int k) const {
    return to_f32(s[(size_t)r * n + k]);
  }
};

struct TileSmem {
  float q[BK][BQ + 1];
  float s[BK][BN + 1];
  float qn[BQ];
  float sn[BN];
};

// acc[i][j] = q_row . s_row and the two squared norms for this thread's
// 4x4 sub-tile of the (q0, s0) block tile.
template <typename Rows>
__device__ __forceinline__ void dot_tile(const float* __restrict__ q,
                                         const Rows s, int num_q,
                                         int num_s, int n, int q0, int s0,
                                         TileSmem& sm, float (&acc)[TM][TN],
                                         float (&qn)[TM], float (&sn)[TN]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  float nrm = 0.0f;   // threads 0..63: query row tid; 64..127: series row tid-64

  for (int k0 = 0; k0 < n; k0 += BK) {
#pragma unroll
    for (int l = 0; l < (BQ * BK) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int r = e / BK;
      const int kk = e % BK;
      const int gk = k0 + kk;
      const int gq = q0 + r;
      const int gs = s0 + r;
      sm.q[kk][r] = (gq < num_q && gk < n) ? q[(size_t)gq * n + gk] : 0.0f;
      sm.s[kk][r] = (gs < num_s && gk < n) ? s(gs, gk) : 0.0f;
    }
    __syncthreads();
    if (tid < BQ) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) nrm = fmaf(sm.q[kk][tid], sm.q[kk][tid], nrm);
    } else if (tid < BQ + BN) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk)
        nrm = fmaf(sm.s[kk][tid - BQ], sm.s[kk][tid - BQ], nrm);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sm.q[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sm.s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < BQ) {
    sm.qn[tid] = nrm;
  } else if (tid < BQ + BN) {
    sm.sn[tid - BQ] = nrm;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i) qn[i] = sm.qn[ty + 16 * i];
#pragma unroll
  for (int j = 0; j < TN; ++j) sn[j] = sm.sn[tx + 16 * j];
}

// float -> unsigned key with the same order (negatives below positives).
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_to_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__global__ void ed_min_init(unsigned long long* best, int num_q) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < num_q)
    best[i] = (unsigned long long)order_key(__int_as_float(0x7F800000)) << 32;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ed_min_kernel(const float* __restrict__ q, const T* __restrict__ s,
              unsigned long long* __restrict__ best, int num_q, int num_s,
              int n, int valid_n) {
  __shared__ TileSmem sm;
  const int q0 = blockIdx.y * BQ;
  const int s0 = blockIdx.x * BN;
  float acc[TM][TN], qn[TM], sn[TN];
  dot_tile<DenseRows<T>>(q, DenseRows<T>{s, n}, num_q, num_s, n, q0, s0, sm, acc,
                         qn, sn);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float inf = __int_as_float(0x7F800000);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    // this thread's best over its 4 columns, in increasing column order with
    // a strict < so the lowest column wins a tie
    float bd = inf;
    int bi = s0 + tx;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gs = s0 + tx + 16 * j;
      // + 0.0f maps -0.0 to +0.0 so the two zeros tie
      const float d = (gs < valid_n) ? (qn[i] + sn[j] - 2.0f * acc[i][j]) + 0.0f : inf;
      if (j == 0 || d < bd) {
        bd = d;
        bi = gs;
      }
    }
    // reduce across the 16 lanes that share this query row (same ty)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xFFFFFFFFu, bd, off);
      const int oi = __shfl_xor_sync(0xFFFFFFFFu, bi, off);
      if (od < bd || (od == bd && oi < bi)) {
        bd = od;
        bi = oi;
      }
    }
    const int gq = q0 + ty + 16 * i;
    if (tx == 0 && gq < num_q) {
      const unsigned long long word =
          ((unsigned long long)order_key(bd) << 32) | (uint32_t)bi;
      atomicMin(best + gq, word);
    }
  }
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

dim3 tile_grid(int num_q, int num_s) {
  return dim3((unsigned)((num_s + BN - 1) / BN), (unsigned)((num_q + BQ - 1) / BQ));
}

template <typename T>
int launch_ed_min(const float* q, const T* s, unsigned long long* scratch,
                  float* dmin, int* amin, int num_q, int num_s, int n,
                  int valid_n, void* stream) {
  if (num_q <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int fb = (num_q + 255) / 256;
  ed_min_init<<<fb, 256, 0, st>>>(scratch, num_q);
  if (num_s > 0)
    ed_min_kernel<T><<<tile_grid(num_q, num_s), THREADS, 0, st>>>(
        q, s, scratch, num_q, num_s, n, valid_n);
  ed_min_finish<<<fb, 256, 0, st>>>(scratch, dmin, amin, num_q);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// v2: ed_matrix and decode_bf16_ed_matrix
// ---------------------------------------------------------------------------

constexpr int kBK = 32;   // k per stage

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
// 4096: 128 blocks).
using Big = TileCfg<128, 128, 8, 8, 4>;
using Small = TileCfg<64, 64, 4, 4, 3>;
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

template <class C, typename S>
constexpr int v2_smem_bytes() {
  return C::STAGES * (C::BM * Staged<float>::kLd + C::BN * Staged<S>::kLd) +
         (C::BM + C::BN) * 4;
}

// (Q, n) float32 queries x N series rows of n elements of S (float32, or
// bf16 bits) at a byte pitch -> (Q, N) float32 squared ED; kRowNorms: also
// the series rows' squared norms as computed here. QVEC and SVEC are the
// copy widths in bytes for the query and series rows.
template <class C, typename S, int QVEC, int SVEC, bool kRowNorms>
__global__ void __launch_bounds__(C::THREADS, 1)
ed_matrix_v2(const float* __restrict__ q, const unsigned char* __restrict__ s,
             long long pitch, float* __restrict__ out, float* __restrict__ sn_out,
             int num_q, int num_s, int n) {
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
#pragma unroll
    for (int k = 0; k < kBK; k += 4) {
      // the norm row's next 4 k with no branch, so the chain interleaves
      // with the tile FMAs: float32 rows by a selected address, bf16 series
      // rows loaded beside the query row and selected value by value
      float4 v;
      if constexpr (std::is_same_v<S, float>) {
        v = Staged<float>::load4(norm_of_q ? tq + nq_row * QLD : ts + ns_row * SLD, k);
      } else {
        const float4 vq = Staged<float>::load4(tq + nq_row * QLD, k);
        const float4 vs = Staged<S>::load4(ts + ns_row * SLD, k);
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
      for (int i = 0; i < TM; ++i) a[i] = Staged<float>::load4(tq + (qr + 4 * i) * QLD, k);
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
  if (tid < BM)
    nq[tid] = nrm;
  else if (tid < BM + BN)
    ns[tid - BM] = nrm;
  __syncthreads();
  if constexpr (kRowNorms) {
    if (blockIdx.y == 0 && tid < s_rows) sn_out[s0 + tid] = ns[tid];
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = qr + 4 * i;
    if (r >= q_rows) continue;
    const float qn = nq[r];
    float* const row = out + (long long)(q0 + r) * num_s + s0;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = sr + 8 * j;
      if (c < s_rows) row[c] = qn + ns[c] - 2.0f * acc[i][j];
    }
  }
}

template <class C, typename S, int QVEC, int SVEC, bool kRowNorms>
int launch_v2(const float* q, const void* s, long long pitch, float* out, float* sn_out,
              int num_q, int num_s, int n, void* stream) {
  constexpr int bytes = v2_smem_bytes<C, S>();
  auto kernel = ed_matrix_v2<C, S, QVEC, SVEC, kRowNorms>;
  // above 48 KB of shared memory once per device (a bit per device id)
  static std::atomic<unsigned long long> opted_in{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(opted_in.load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in.fetch_or(bit);
  }
  const dim3 grid((unsigned)((num_s + C::BN - 1) / C::BN),
                  (unsigned)((num_q + C::BM - 1) / C::BM));
  kernel<<<grid, C::THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      q, static_cast<const unsigned char*>(s), pitch, out, sn_out, num_q, num_s, n);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, unsigned a) { return reinterpret_cast<uintptr_t>(p) % a == 0; }

bool big_grid(int num_q, int num_s) {
  return (long long)((num_q + Big::BM - 1) / Big::BM) * ((num_s + Big::BN - 1) / Big::BN) >=
         kBigMinTiles;
}

// Float32 series rows (pitch 4n): 16-byte copies where n % 4 == 0 and both
// bases are 16-byte aligned, else 4-byte copies in Small tiles.
int launch_v2_f32(const float* q, const float* s, float* out, int num_q, int num_s, int n,
                  void* stream) {
  if (num_q <= 0 || num_s <= 0) return (int)cudaSuccess;
  const long long pitch = 4LL * n;
  if (n % 4 == 0 && aligned(q, 16) && aligned(s, 16)) {
    if (big_grid(num_q, num_s))
      return launch_v2<Big, float, 16, 16, false>(q, s, pitch, out, nullptr, num_q, num_s,
                                                  n, stream);
    return launch_v2<Small, float, 16, 16, false>(q, s, pitch, out, nullptr, num_q, num_s,
                                                  n, stream);
  }
  return launch_v2<Small, float, 4, 4, false>(q, s, pitch, out, nullptr, num_q, num_s, n,
                                              stream);
}

// bf16 series rows at a byte pitch: 4-byte copies where n % 4 == 0, the
// queries are 16-byte aligned and the rows 4-byte aligned (the bf16
// codec's 2n + 4 pitch); else (odd n, rows only 2-byte aligned) 2-byte
// loads in Small tiles.
template <bool kRowNorms>
int launch_v2_bf16(const float* q, const void* s, long long pitch, float* out,
                   float* sn_out, int num_q, int num_s, int n, void* stream) {
  if (num_q <= 0 || num_s <= 0) return (int)cudaSuccess;
  if (n % 4 == 0 && aligned(q, 16) && aligned(s, 4) && pitch % 4 == 0) {
    if (big_grid(num_q, num_s))
      return launch_v2<Big, __nv_bfloat16, 16, 4, kRowNorms>(q, s, pitch, out, sn_out,
                                                             num_q, num_s, n, stream);
    return launch_v2<Small, __nv_bfloat16, 16, 4, kRowNorms>(q, s, pitch, out, sn_out,
                                                             num_q, num_s, n, stream);
  }
  return launch_v2<Small, __nv_bfloat16, 4, 2, kRowNorms>(q, s, pitch, out, sn_out, num_q,
                                                          num_s, n, stream);
}

}  // namespace

// (Q, n) float32 queries x (N, n) series -> (Q, N) float32 squared ED.
extern "C" int ed_matrix_f32(const float* q, const float* s, float* out, int num_q,
                             int num_s, int n, void* stream) {
  return launch_v2_f32(q, s, out, num_q, num_s, n, stream);
}

extern "C" int ed_matrix_bf16(const float* q, const void* s, float* out, int num_q,
                              int num_s, int n, void* stream) {
  return launch_v2_bf16<false>(q, s, 2LL * n, out, nullptr, num_q, num_s, n, stream);
}

// (Q, n) float32 queries x B bf16 rows of n elements, row r at byte
// r * pitch of `payload` -> (Q, B) float32 squared ED against the decoded
// rows, and the (B,) squared norms of the decoded rows into sn_out. pitch is
// even and >= 2n; payload is 2-byte aligned.
extern "C" int decode_bf16_ed_matrix(const float* q, const void* payload, long long pitch,
                                     float* out, float* sn_out, int num_q, int num_s,
                                     int n, void* stream) {
  return launch_v2_bf16<true>(q, payload, pitch, out, sn_out, num_q, num_s, n, stream);
}

// Fused 1-NN: (Q,) float32 min squared ED and (Q,) int32 argmin over the
// first valid_n of N series. `scratch` is (Q,) uint64 owned by the caller.
extern "C" int ed_min_f32(const float* q, const float* s, unsigned long long* scratch,
                          float* dmin, int* amin, int num_q, int num_s, int n,
                          int valid_n, void* stream) {
  return launch_ed_min<float>(q, s, scratch, dmin, amin, num_q, num_s, n, valid_n,
                              stream);
}

extern "C" int ed_min_bf16(const float* q, const void* s, unsigned long long* scratch,
                           float* dmin, int* amin, int num_q, int num_s, int n,
                           int valid_n, void* stream) {
  return launch_ed_min<__nv_bfloat16>(q, static_cast<const __nv_bfloat16*>(s),
                                      scratch, dmin, amin, num_q, num_s, n,
                                      valid_n, stream);
}
