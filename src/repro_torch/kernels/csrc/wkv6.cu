// RWKV-6 (Finch) WKV recurrence, for Hopper (sm_90a): v2.
//
// Replaces: src/repro/kernels/wkv6.py::wkv6 (_wkv6_kernel).
//
// For each (batch b, head h), with a K x V float32 state S:
//   out_t = r_t . (S + diag(u) k_t v_t^T)
//   S     = diag(w_t) S + k_t v_t^T        (w_i == 0 resets row i to k_i v^T)
// The reset is a select, never 0 * S: an overflowed (inf) state times 0
// would be NaN and poison every later token.
//
// Bound on this card: the function needs, per (b, t, h), one FMA per (i, j)
// for out (out_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i) and a multiply
// and an FMA per (i, j) for the update: 5 K V + 3 K + 2 V operations. At the
// prefill shape of rwkv6-7b serving (B=4, T=512, H=64, K=V=64; bf16 r, k, v
// and out, float32 w and state, as served) that is 2.73 GFLOP, 0.041 ms at
// 67 TFLOP/s float32, against 109 MB moved (0.033 ms at 3.35 TB/s): the
// operations bind. With float32 r, k, v and out the bytes bind (176 MB,
// 0.053 ms). At decode (T=1) the bound is microseconds and the launch sets
// the time.
//
// Arithmetic (v1's, kept bit for bit; kernels/ref.py::wkv6_fma_ref repeats
// it through a correctly rounded fmaf and holds this kernel to it on the
// card). Each state column j is summed in SPLIT = 4 partials: partial p
// holds rows i = p, p + 4, ... and walks them ascending, forming
// kv = k_i * v_j (rounded), acc = fmaf(r_i, fmaf(u_i, kv, S_ij), acc) from
// 0.0f and S_ij = (w_i == 0) ? kv : fmaf(w_i, S_ij, kv); then
// out_j = (acc_0 + acc_1) + (acc_2 + acc_3), a partial with no rows adding
// its 0.0f. bf16 r, k, v are widened exactly; bf16 out is rounded to
// nearest even. 7 K V operations a step (the bonus term per (i, j)).
//
// Design. Blocks on Hopper run in no order, so the sequential T axis is a
// loop inside one block per (b, h), which keeps its state in registers for
// the whole sequence. v1 met a barrier and a global-load round trip every
// step. v2 moves everything around the arithmetic:
// - Chunks: CHUNK steps of r, k, w and v are copied
//   into shared memory by cp.async (16 bytes a copy) while the chunk before
//   computes; one pass widens them to a float4 (r_i, k_i, w_i, -) per
//   (step, row) and a float per (step, column). Two barriers a chunk and
//   none inside it: the steps of a chunk share nothing through shared
//   memory, and the step loop is unrolled by 2, so one step's acc chains
//   overlap the next's.
// - Each thread holds J neighbouring columns of one partial (J x 16 state
//   floats at K = 64), and a partial's threads are whole warps (J = 2: one
//   warp, 32 x 2 columns): every lane of a warp reads the same (r_i, k_i,
//   w_i), so one LDS.128 is one broadcast and serves J columns, and the J
//   chains are independent. u_i stays in registers.
// - The reset select is taken per chunk: the barrier that ends the widening
//   pass also ORs "some w_i == 0" over the block (__syncthreads_or); a chunk
//   without one runs the update as fmaf alone, which is what the select
//   picks there. A step is then 4 FP32 instructions per (i, j) and one
//   LDS.128 per row and J columns.
// - The partial sums of a chunk go to shared memory, and the pass that
//   writes the chunk's out folds them, (acc_0 + acc_1) + (acc_2 + acc_3):
//   no shuffle and no barrier inside a step. On the aligned path out is
//   written 4 columns an item and the state J columns a lane, neighbouring
//   lanes on neighbouring columns.
// - Shared memory is sized by min(T, CHUNK) steps: a prefill block takes
//   92 KB (bf16) or 104 KB (float32), two blocks an SM; a bf16 decode step
//   2.9 KB.
// cp.async needs 16-byte aligned sources: the aligned path takes bases
// that are 16-byte aligned with K * sizeof(E), K * 4 and V * sizeof(E)
// multiples of 16 (K = 64, as served); anything else (K = 33, a view one
// element in) takes the element path, which fills the same staging
// buffers with plain loads and folds and writes one column at a time. Both
// run the same arithmetic.
// CHUNK = 32, J = 2 and the unroll by 2 were chosen by measurement
// (tools/kernel_ab.py --kernel wkv6 --trial with the -D flags below): C =
// 16 and 64, J = 1 and 4 and unroll 1 were slower; unroll 4 was 1-4%
// faster at prefill and slower at decode. Splitting V over two blocks (32
// columns each) was slower too, so a block holds every column.
// v1 -> v2 device time (tools/kernel_ab.py --kernel wkv6, H100 80GB HBM3
// at 700 W): 0.5227 -> 0.1602 ms at the prefill shape with bf16 r, k, v
// (25% of the bound), 0.5205 -> 0.1723 in float32; a decode step 0.0044
// either way. The step's shared-memory loads are a minor share of its
// time: its FP32 chains hold it, with two warps a scheduler.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#ifndef WKV_CHUNK
#define WKV_CHUNK 32
#endif
#ifndef WKV_COLS
#define WKV_COLS 2
#endif
#ifndef WKV_STEP_UNROLL
#define WKV_STEP_UNROLL 2
#endif

namespace {

constexpr int KMAX = 64;
constexpr int SPLIT = 4;                 // partial sums per state column
constexpr int ROWS = KMAX / SPLIT;       // state rows per partial
constexpr int CHUNK = WKV_CHUNK;         // steps staged at a time
constexpr int J = WKV_COLS;              // columns per thread
constexpr int VB = KMAX;                 // state columns a block holds (all V)
constexpr int STEP_UNROLL = WKV_STEP_UNROLL;
constexpr int LANES = VB / J;            // threads of one partial
constexpr int THREADS = SPLIT * LANES;
static_assert(CHUNK >= 1 && (J == 1 || J == 2 || J == 4), "CHUNK >= 1, J in {1, 2, 4}");
static_assert(THREADS % 32 == 0 && (LANES % 32 == 0 || 32 % LANES == 0),
              "whole warps, each partial on whole warps or a whole part of one");

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Shared memory of a block, for `cap` steps a chunk (CHUNK, or T when T is
// shorter): the widened chunk (pk: (r, k, w,
// -) per step and row; pv: v per step and column), the chunk's partial
// sums (ob: per step, partial and column), and the staging buffers as
// copied (rw, rr, rk, rv). Rows at a fixed stride (KMAX or VB elements), so
// step tt, row i of a staged array is tt * KMAX + i.
template <typename E>
struct Smem {
  static constexpr int step_bytes =
      KMAX * 16 + VB * 4 + SPLIT * VB * 4 + KMAX * 4 + (2 * KMAX + VB) * (int)sizeof(E);
  float4* pk;
  float* pv;
  float* ob;
  float* rw;
  E* rr;
  E* rk;
  E* rv;
  __device__ Smem(float4* base, int cap) {
    pk = base;
    pv = reinterpret_cast<float*>(pk + cap * KMAX);
    ob = pv + cap * VB;
    rw = ob + cap * SPLIT * VB;
    rr = reinterpret_cast<E*>(rw + cap * KMAX);
    rk = rr + cap * KMAX;
    rv = rk + cap * KMAX;
  }
};

// Where a block reads and writes: element (b, t, h, i) of a (B, T, H, D)
// array is at (row0 + t * H) * D + i, row0 = b * T * H + h.
struct Rows {
  size_t row0;
  int H, K, V;
  __device__ size_t at(int t, int dim) const { return (row0 + (size_t)t * H) * dim; }
};

// Copy steps [t0, t0 + n) of r, k, w and the block's v columns into the
// staging buffers: cp.async 16 bytes a copy (ALIGNED; the caller waits),
// else plain element loads, EB in flight per thread before their stores.
template <typename E, bool ALIGNED>
__device__ __forceinline__ void stage(const E* r, const E* k, const E* v, const float* w,
                                      const Smem<E>& sm, const Rows& rows, int t0, int n) {
  const int tid = threadIdx.x;
  const int K = rows.K;
  if constexpr (ALIGNED) {
    constexpr int EP = 16 / sizeof(E);              // elements of E a copy
    constexpr int KP = KMAX / EP, WP = KMAX / 4, VP = VB / EP;
    const int kp = K / EP, wp = K / 4, vp = rows.V / EP;
    for (int x = tid; x < n * KP; x += THREADS) {
      const int tt = x / KP, q = x % KP;
      if (q < kp) {
        const size_t g = rows.at(t0 + tt, K) + q * EP;
        cp_async16(sm.rr + tt * KMAX + q * EP, r + g);
        cp_async16(sm.rk + tt * KMAX + q * EP, k + g);
      }
    }
    for (int x = tid; x < n * WP; x += THREADS) {
      const int tt = x / WP, q = x % WP;
      if (q < wp) cp_async16(sm.rw + tt * KMAX + q * 4, w + rows.at(t0 + tt, K) + q * 4);
    }
    for (int x = tid; x < n * VP; x += THREADS) {
      const int tt = x / VP, q = x % VP;
      if (q < vp)
        cp_async16(sm.rv + tt * VB + q * EP, v + rows.at(t0 + tt, rows.V) + q * EP);
    }
    cp_async_commit();
  } else {
    constexpr int EB = 4;
    for (int x0 = tid; x0 < n * KMAX; x0 += EB * THREADS) {
      E a[EB] = {}, c[EB] = {};
      float d[EB] = {};
#pragma unroll
      for (int e = 0; e < EB; ++e) {
        const int x = x0 + e * THREADS;
        if (x < n * KMAX && x % KMAX < K) {
          const size_t g = rows.at(t0 + x / KMAX, K) + x % KMAX;
          a[e] = r[g];
          c[e] = k[g];
          d[e] = w[g];
        }
      }
#pragma unroll
      for (int e = 0; e < EB; ++e) {
        const int x = x0 + e * THREADS;
        if (x < n * KMAX && x % KMAX < K) {
          sm.rr[x] = a[e];
          sm.rk[x] = c[e];
          sm.rw[x] = d[e];
        }
      }
    }
    for (int x0 = tid; x0 < n * VB; x0 += EB * THREADS) {
      E a[EB] = {};
#pragma unroll
      for (int e = 0; e < EB; ++e) {
        const int x = x0 + e * THREADS;
        if (x < n * VB && x % VB < rows.V) a[e] = v[rows.at(t0 + x / VB, rows.V) + x % VB];
      }
#pragma unroll
      for (int e = 0; e < EB; ++e) {
        const int x = x0 + e * THREADS;
        if (x < n * VB && x % VB < rows.V) sm.rv[x] = a[e];
      }
    }
  }
}

// G consecutive elements (G-aligned) as floats, widened exactly; G floats
// stored, bf16 rounded to nearest even: one access of 4 * G or 2 * G bytes.
template <int G>
__device__ __forceinline__ void load_g(const float* p, float (&x)[G]) {
  if constexpr (G == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (G == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

template <int G>
__device__ __forceinline__ void load_g(const __nv_bfloat16* p, float (&x)[G]) {
  static_assert(G == 1 || G == 4, "bf16 groups of 1 or 4");
  if constexpr (G == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(t.x << 16); x[1] = __uint_as_float(t.x & 0xFFFF0000u);
    x[2] = __uint_as_float(t.y << 16); x[3] = __uint_as_float(t.y & 0xFFFF0000u);
  } else {
    x[0] = widen(*p);
  }
}

template <int G>
__device__ __forceinline__ void store_g(float* p, const float (&x)[G]) {
  if constexpr (G == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else if constexpr (G == 2)
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  else
    *p = x[0];
}

template <int G>
__device__ __forceinline__ void store_g(__nv_bfloat16* p, const float (&x)[G]) {
  static_assert(G == 1 || G == 4, "bf16 groups of 1 or 4");
  if constexpr (G == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                              *reinterpret_cast<const unsigned*>(&hi));
  } else {
    store(p, x[0]);
  }
}

// Widen n staged steps into pk and pv, G rows (columns) an item: 4 on the
// aligned path, where K and V are multiples of 4. True if this thread met
// a w_i == 0.
template <typename E, bool ALIGNED>
__device__ __forceinline__ bool widen_chunk(const Smem<E>& sm, const Rows& rows, int n) {
  constexpr int G = ALIGNED ? 4 : 1;
  bool zero = false;
  for (int x = threadIdx.x; x < n * (KMAX / G); x += THREADS) {
    const int at = x * G;                // step at / KMAX, rows from at % KMAX
    if (at % KMAX < rows.K) {
      float rg[G], kg[G], wg[G];
      load_g<G>(sm.rr + at, rg);
      load_g<G>(sm.rk + at, kg);
      load_g<G>(sm.rw + at, wg);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        zero |= wg[g] == 0.0f;
        sm.pk[at + g] = make_float4(rg[g], kg[g], wg[g], 0.0f);
      }
    }
  }
  for (int x = threadIdx.x; x < n * (VB / G); x += THREADS) {
    const int at = x * G;
    if (at % VB < rows.V) {
      float vg[G];
      load_g<G>(sm.rv + at, vg);
      store_g<G>(sm.pv + at, vg);
    }
  }
  return zero;
}

// Fold and write n buffered steps of out, starting at step t0, G columns
// an item: out_j = (acc_0 + acc_1) + (acc_2 + acc_3).
template <typename E, bool ALIGNED>
__device__ __forceinline__ void store_chunk(const Smem<E>& sm, const Rows& rows, E* out,
                                            int t0, int n) {
  constexpr int G = ALIGNED ? 4 : 1;
  E* o = out + rows.at(t0, rows.V);
  const size_t step = (size_t)rows.H * rows.V;
  for (int x = threadIdx.x; x < n * (VB / G); x += THREADS) {
    const int tt = x * G / VB, jj = x * G % VB;
    if (jj < rows.V) {
      const float* a = sm.ob + tt * SPLIT * VB + jj;
      float a0[G], a1[G], a2[G], a3[G], y[G];
      load_g<G>(a, a0);
      load_g<G>(a + VB, a1);
      load_g<G>(a + 2 * VB, a2);
      load_g<G>(a + 3 * VB, a3);
#pragma unroll
      for (int g = 0; g < G; ++g) y[g] = (a0[g] + a1[g]) + (a2[g] + a3[g]);
      store_g<G>(o + tt * step + jj, y);
    }
  }
}

// The n steps of a widened chunk for this thread's J columns of partial p,
// their partial sums into ob. FULL: K == KMAX, so no row needs a guard.
// RESET: some w_i of the chunk is 0, so each update selects kv where
// w_i == 0; in a chunk with none the select would take fmaf every time,
// and fmaf alone is what runs.
template <bool FULL, bool RESET>
__device__ __forceinline__ void chunk_steps(const float4* pk, const float* pv, float* ob,
                                            float (&s)[J][ROWS], const float (&ui)[ROWS],
                                            int p, int j0, int K, int n) {
#pragma unroll (STEP_UNROLL)
  for (int tt = 0; tt < n; ++tt) {
    const float4* e_t = pk + tt * KMAX + p;
    float vj[J], acc[J];
    load_g<J>(pv + tt * VB + j0, vj);
#pragma unroll
    for (int c = 0; c < J; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int ii = 0; ii < ROWS; ++ii) {
      if (FULL || ii * SPLIT + p < K) {
        const float4 e = e_t[ii * SPLIT];
#pragma unroll
        for (int c = 0; c < J; ++c) {
          const float kv = e.y * vj[c];
          acc[c] = fmaf(e.x, fmaf(ui[ii], kv, s[c][ii]), acc[c]);
          const float decayed = fmaf(e.z, s[c][ii], kv);
          s[c][ii] = RESET && e.z == 0.0f ? kv : decayed;
        }
      }
    }
    store_g<J>(ob + (tt * SPLIT + p) * VB + j0, acc);
  }
}

template <typename E, bool ALIGNED, bool FULL>
__global__ void __launch_bounds__(THREADS, 2)
wkv6_kernel(const E* __restrict__ r, const E* __restrict__ k,
            const E* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            E* __restrict__ out, float* __restrict__ s_out,
            int T, int H, int K, int V) {
  extern __shared__ float4 smem_base[];
  const Smem<E> sm(smem_base, min(T, CHUNK));
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const Rows rows{(size_t)b * T * H + h, H, K, V};
  const int tid = threadIdx.x;
  const int p = tid / LANES;             // partial: rows p, p + SPLIT, ...
  const int j0 = (tid % LANES) * J;      // first of this thread's columns in the block

  float s[J][ROWS], ui[ROWS];
  const size_t sbase = (size_t)bh * K * V;
#pragma unroll
  for (int ii = 0; ii < ROWS; ++ii) {
    const int i = ii * SPLIT + p;
    ui[ii] = i < K ? __ldg(u + (size_t)h * K + i) : 0.0f;
    float row[J] = {};                   // aligned: one 4 * J-byte load (V % 4 == 0)
    if constexpr (ALIGNED) {
      if (i < K && j0 < V) load_g<J>(s0 + sbase + (size_t)i * V + j0, row);
    } else {
#pragma unroll
      for (int c = 0; c < J; ++c)
        if (i < K && j0 + c < V) row[c] = s0[sbase + (size_t)i * V + j0 + c];
    }
#pragma unroll
    for (int c = 0; c < J; ++c) s[c][ii] = row[c];
  }

  if (T > 0) stage<E, ALIGNED>(r, k, v, w, sm, rows, 0, min(CHUNK, T));
  for (int t0 = 0; t0 < T; t0 += CHUNK) {
    const int n = min(CHUNK, T - t0);
    if constexpr (ALIGNED) cp_async_wait_all();
    __syncthreads();                     // chunk staged; the last chunk's steps done
    if (t0 > 0) store_chunk<E, ALIGNED>(sm, rows, out, t0 - CHUNK, CHUNK);
    // chunk widened (and whether it holds a w_i == 0); staging buffers free
    const bool resets = __syncthreads_or(widen_chunk<E, ALIGNED>(sm, rows, n));
    if (t0 + CHUNK < T)
      stage<E, ALIGNED>(r, k, v, w, sm, rows, t0 + CHUNK, min(CHUNK, T - t0 - CHUNK));
    if (resets)
      chunk_steps<FULL, true>(sm.pk, sm.pv, sm.ob, s, ui, p, j0, K, n);
    else
      chunk_steps<FULL, false>(sm.pk, sm.pv, sm.ob, s, ui, p, j0, K, n);
  }
#pragma unroll
  for (int ii = 0; ii < ROWS; ++ii) {
    const int i = ii * SPLIT + p;
    float row[J];
#pragma unroll
    for (int c = 0; c < J; ++c) row[c] = s[c][ii];
    if constexpr (ALIGNED) {
      if (i < K && j0 < V) store_g<J>(s_out + sbase + (size_t)i * V + j0, row);
    } else {
#pragma unroll
      for (int c = 0; c < J; ++c)
        if (i < K && j0 + c < V) s_out[sbase + (size_t)i * V + j0 + c] = row[c];
    }
  }
  if (T > 0) {                           // the last chunk's out, after the state
    const int last = (T - 1) / CHUNK * CHUNK;
    __syncthreads();
    store_chunk<E, ALIGNED>(sm, rows, out, last, T - last);
  }
}

// Opt `kernel` into `bytes` of dynamic shared memory, once per device (a
// bit per device id in `done`): setting it at every launch costs time.
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

template <typename E, bool ALIGNED, bool FULL>
int launch_path(const E* r, const E* k, const E* v, const float* w, const float* u,
                const float* s0, E* out, float* s_out, int B, int T, int H, int K, int V,
                cudaStream_t stream) {
  auto kernel = wkv6_kernel<E, ALIGNED, FULL>;
  static std::atomic<unsigned long long> done{0};
  const cudaError_t err = smem_opt_in(kernel, CHUNK * Smem<E>::step_bytes, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H));
  const int bytes = (T < CHUNK ? T : CHUNK) * Smem<E>::step_bytes;
  kernel<<<grid, THREADS, bytes, stream>>>(r, k, v, w, u, s0, out, s_out, T, H, K, V);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The path by shape and pointer: cp.async copies 16 aligned bytes, so every
// staged row (r, k: K * sizeof(E) bytes; w: K * 4; v: V * sizeof(E)) must
// start on a 16-byte boundary; the
// aligned path also reads and writes out and the state 4 columns at a time.
template <typename E>
int launch(const E* r, const E* k, const E* v, const float* w, const float* u,
           const float* s0, E* out, float* s_out, int B, int T, int H, int K,
           int V, void* stream) {
  if (K < 1 || K > KMAX || V < 1 || V > KMAX || T < 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool aligned = (K * sizeof(E)) % 16 == 0 && K % 4 == 0 && (V * sizeof(E)) % 16 == 0 &&
                       aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) &&
                       aligned16(out) && aligned16(s0) && aligned16(s_out);
  if (!aligned)
    return launch_path<E, false, false>(r, k, v, w, u, s0, out, s_out, B, T, H, K, V, st);
  if (K == KMAX)
    return launch_path<E, true, true>(r, k, v, w, u, s0, out, s_out, B, T, H, K, V, st);
  return launch_path<E, true, false>(r, k, v, w, u, s0, out, s_out, B, T, H, K, V, st);
}

}  // namespace

// r, k (B, T, H, K), v (B, T, H, V) and out (B, T, H, V) float32 (_f32) or
// bfloat16 (_bf16); w (B, T, H, K), u (H, K), s0 and s_out (B, H, K, V)
// float32; all contiguous. 1 <= K, V <= 64; T >= 0. Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int wkv6_f32(const float* r, const float* k, const float* v,
                        const float* w, const float* u, const float* s0,
                        float* out, float* s_out, int B, int T, int H, int K,
                        int V, void* stream) {
  return launch(r, k, v, w, u, s0, out, s_out, B, T, H, K, V, stream);
}

extern "C" int wkv6_bf16(const __nv_bfloat16* r, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, const float* w, const float* u,
                         const float* s0, __nv_bfloat16* out, float* s_out, int B,
                         int T, int H, int K, int V, void* stream) {
  return launch(r, k, v, w, u, s0, out, s_out, B, T, H, K, V, stream);
}
