// Squared-Euclidean-distance scans for Hopper (sm_90a): ed_matrix and the
// fused 1-NN ed_min.
//
// Replaces: src/repro/kernels/ed.py::ed_matrix (_ed_matrix_kernel) and
// src/repro/kernels/ed.py::ed_min (_ed_min_kernel).
//
// Bound on this card: at the scan's shapes (a bucket of 128 queries against
// millions of length-256 series) both kernels do 2*Q*N*n float32 operations
// on (Q + N)*n*4 bytes, about 64 operations per byte read -- above the
// float32 ridge of the card's non-tensor units, so they are bound by float32
// FMA throughput. ed_matrix per 4096-row scan block is short enough that
// launch overhead also shows.
//
// Design: both use ||q - s||^2 = ||q||^2 + ||s||^2 - 2 q.s with float32
// accumulation in plain FMAs (no TF32). A 256-thread block owns a 64x64
// output tile; each k-step stages a 64x16 slice of the queries and of the
// series in shared memory (transposed, so the inner loop reads broadcast
// rows), and every thread accumulates a 4x4 register tile. The squared
// norms come from the same staged slices (one row per thread for 128 of the
// threads), so no separate norm pass reads device memory. The kernels mask
// their own ragged edges (rows past Q or N and columns past n load as 0), so
// callers never pad. Series may be float32 or bfloat16; bf16 is upcast in
// registers as it is staged.
//
// ed_min cannot carry a running (min, argmin) across blocks the way the TPU
// grid does, because blocks run in parallel in no order. Each block reduces
// its tile to one (distance, index) per query and folds it into a 64-bit
// word per query with atomicMin: the high 32 bits are the distance mapped to
// an order-preserving unsigned key, the low 32 bits the column index. The
// smallest word is the smallest distance and, among equal distances, the
// lowest index; the word starts at (+inf, 0), so an all-inf row reports
// index 0. Columns at or past valid_n are +inf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int TM = 4;   // query rows per thread: ty + 16*i
constexpr int TN = 4;   // series columns per thread: tx + 16*j

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct TileSmem {
  float q[BK][BQ + 1];
  float s[BK][BN + 1];
  float qn[BQ];
  float sn[BN];
};

// acc[i][j] = q_row . s_row and the two squared norms for this thread's
// 4x4 sub-tile of the (q0, s0) block tile.
template <typename T>
__device__ __forceinline__ void dot_tile(const float* __restrict__ q,
                                         const T* __restrict__ s, int num_q,
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
      sm.s[kk][r] = (gs < num_s && gk < n) ? to_f32(s[(size_t)gs * n + gk]) : 0.0f;
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
ed_matrix_kernel(const float* __restrict__ q, const T* __restrict__ s,
                 float* __restrict__ out, int num_q, int num_s, int n) {
  __shared__ TileSmem sm;
  const int q0 = blockIdx.y * BQ;
  const int s0 = blockIdx.x * BN;
  float acc[TM][TN], qn[TM], sn[TN];
  dot_tile<T>(q, s, num_q, num_s, n, q0, s0, sm, acc, qn, sn);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gq = q0 + ty + 16 * i;
    if (gq >= num_q) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gs = s0 + tx + 16 * j;
      if (gs < num_s) out[(size_t)gq * num_s + gs] = qn[i] + sn[j] - 2.0f * acc[i][j];
    }
  }
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
  dot_tile<T>(q, s, num_q, num_s, n, q0, s0, sm, acc, qn, sn);
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
int launch_ed_matrix(const float* q, const T* s, float* out, int num_q, int num_s,
                     int n, void* stream) {
  if (num_q <= 0 || num_s <= 0) return (int)cudaSuccess;
  ed_matrix_kernel<T><<<tile_grid(num_q, num_s), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(q, s, out, num_q, num_s, n);
  return (int)cudaGetLastError();
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

}  // namespace

// (Q, n) float32 queries x (N, n) series -> (Q, N) float32 squared ED.
extern "C" int ed_matrix_f32(const float* q, const float* s, float* out, int num_q,
                             int num_s, int n, void* stream) {
  return launch_ed_matrix<float>(q, s, out, num_q, num_s, n, stream);
}

extern "C" int ed_matrix_bf16(const float* q, const void* s, float* out, int num_q,
                              int num_s, int n, void* stream) {
  return launch_ed_matrix<__nv_bfloat16>(
      q, static_cast<const __nv_bfloat16*>(s), out, num_q, num_s, n, stream);
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
