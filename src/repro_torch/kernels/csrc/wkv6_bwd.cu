// The gradient of the RWKV-6 (Finch) WKV recurrence, for Hopper (sm_90a).
//
// Replaces no TPU kernel: src/repro/kernels/wkv6.py has no backward, and
// the reference trains through jax.vjp of its plain scan
// (src/repro/kernels/ref.py::wkv6_ref, the default of
// src/repro/models/rwkv6.py). This kernel computes that vjp; the plain
// version is kernels/ref.py::wkv6_bwd_ref.
//
// The forward, per (batch b, head h), with a K x V float32 state S:
//   out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
//   S_t   = diag(w_t) S_{t-1} + k_t v_t^T     (w_i == 0 resets row i to k_i v^T)
// Every element S_ij is a scalar recurrence of its own; only the outputs
// sum over rows or columns. Backwards, from G = dS_T (G the gradient of
// S_t; Gs it with the rows where w_i == 0 zeroed: the reset's select passes
// nothing to the earlier state):
//   dr_t = S_{t-1} do_t + u (.) k_t (v_t . do_t)      (a sum over columns)
//   dk_t = G v_t + u (.) r_t (v_t . do_t)              (over columns)
//   dw_t = rowsum(Gs (.) S_{t-1})                      (over columns; 0 at a
//                                                      reset row of a finite S)
//   dv_t = G^T k_t + (sum_i u_i r_i k_i) do_t          (over rows)
//   du  += r_t (.) k_t (v_t . do_t), summed over t and then over b
//   G    = diag(w_t) Gs + r_t do_t^T
// dw_t needs S_{t-1} and G at the same step, running in opposite
// directions.
//
// Bound on this card, per (b, t, h) and state element (i, j): forming
// S_{t-1} (a multiply and an FMA), one FMA each for dr, dk, dw and dv, and a
// multiply and an FMA for G: 14 operations (FMA = 2), plus O(K + V). At the
// training shape of rwkv6-7b (B=4, T=512, H=64, K=V=64; bf16 r, k, v, out
// and their gradients, float32 w, dw and states) that is 7.5 G operations,
// 0.112 ms at 67 TFLOP/s float32, against 197 MB read and written (0.059 ms
// at 3.35 TB/s): the operations bind.
//
// Design (simple first). One block of 128 threads a (b, h); the sequential
// T axis is a loop inside it. Threads 0..63 own a state row i each (all V
// columns of S and of G in registers), threads 64..127 a column j each (all
// K rows of G): the row threads' sums over columns (dr, dk, dw) and the
// column threads' sum over rows (dv) are each one thread's chain, in a fixed
// order, with no shuffle and no atomic, so a run repeats bit for bit. Both
// kinds run the same G recurrence, in the same operations, so their G
// agree bit for bit.
// - States: first a forward sweep from s0 (the row threads) writes S at the
//   start of every chunk of CK steps to a checkpoint buffer (B H ceil(T/CK)
//   states). Then the chunks run from the last: the row threads recompute
//   the chunk's states from its checkpoint (computing dr on the way, which
//   needs S_{t-1} in forward order) into a scratch buffer of CK states a
//   block, and walk the chunk backwards reading them (dk, dw, du); the
//   column threads walk it backwards too (dv). A thread reads back only
//   what it wrote itself, so the scratch needs no barrier. The recompute
//   uses the forward kernel's update, (w_i == 0) ? kv : fmaf(w_i, S, kv),
//   so the states are the forward's bits.
// - Staging: a chunk's r, k, w, v and do are widened into shared memory
//   (float, zero-padded to 64), with the per-step sums v_t . do_t and
//   sum_i u_i r_i k_i; every read inside a step is a broadcast or
//   conflict-free.
// - du: each row thread sums its u row over t; a second launch sums the
//   (B, H, K) partials over b in order (no atomics).
// - Scratch traffic: the row threads write and read every state once (4.3
//   GB at the training shape). With CK = 16 the live scratch is 16 states a
//   block (64 MB for 256 blocks at the training shape, against 50 MB of
//   L2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int KMAX = 64;
constexpr int CK = 16;                   // steps a checkpoint covers (kernels/wkv6.py's BWD_CHUNK)
constexpr int THREADS = 2 * KMAX;        // KMAX row threads, then KMAX column threads
static_assert(CK >= 1 && CK <= KMAX, "1 <= CK <= 64 (a thread a step sums v . do)");

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Shared floats for `cap` staged steps: r, k, w, v, do (cap x KMAX each),
// v . do and sum_i u_i r_i k_i (cap each), u (KMAX).
__host__ __device__ constexpr int smem_floats(int cap) { return cap * (5 * KMAX + 2) + KMAX; }

template <typename E, bool FULL>
__global__ void __launch_bounds__(THREADS, 2)
wkv6_bwd_kernel(const E* __restrict__ r, const E* __restrict__ k, const E* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ s0, const E* __restrict__ dout,
                const float* __restrict__ dsT, E* __restrict__ dr, E* __restrict__ dk,
                E* __restrict__ dv, float* __restrict__ dw, float* __restrict__ du_part,
                float* __restrict__ ds0, float* __restrict__ ckpt,
                float* __restrict__ states, int T, int H, int K, int V) {
  extern __shared__ float smem[];
  const int cap = T < CK ? T : CK;
  float* s_r = smem;
  float* s_k = s_r + cap * KMAX;
  float* s_w = s_k + cap * KMAX;
  float* s_v = s_w + cap * KMAX;
  float* s_do = s_v + cap * KMAX;
  float* s_vdo = s_do + cap * KMAX;
  float* s_ruk = s_vdo + cap;
  float* s_u = s_ruk + cap;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t row0 = (size_t)b * T * H + h;   // (t, x) of a (B, T, H, D) array: (row0 + t H) D + x
  const int tid = threadIdx.x;
  const bool is_row = tid < KMAX;
  const int i = tid;                           // a row thread's row
  const int j = tid - KMAX;                    // a column thread's column
  const bool active = is_row ? i < K : j < V;
  const int nc = (T + CK - 1) / CK;
  float* ck = ckpt + (size_t)bh * nc * V * K;  // checkpoint c, column jj, row i: (c V + jj) K + i
  float* st = states + (size_t)bh * cap * V * K;  // step tt of a chunk, column jj, row i: (tt V + jj) K + i
  const size_t sbase = (size_t)bh * K * V;     // (B, H, K, V) arrays

  for (int x = tid; x < KMAX; x += THREADS) s_u[x] = x < K ? u[(size_t)h * K + x] : 0.0f;

  auto stage = [&](int t0, int n) {
    for (int x = tid; x < n * KMAX; x += THREADS) {
      const int tt = x / KMAX, q = x % KMAX;
      const size_t at = row0 + (size_t)(t0 + tt) * H;
      const bool rk = q < K, cv = q < V;
      s_r[x] = rk ? widen(r[at * K + q]) : 0.0f;
      s_k[x] = rk ? widen(k[at * K + q]) : 0.0f;
      s_w[x] = rk ? w[at * K + q] : 0.0f;
      s_v[x] = cv ? widen(v[at * V + q]) : 0.0f;
      s_do[x] = cv ? widen(dout[at * V + q]) : 0.0f;
    }
  };

  float S[KMAX];                               // a row thread's state row
  float G[KMAX];                               // a row thread's G row, a column thread's G column

  // the forward sweep: a checkpoint at the start of every chunk
  if (is_row && active) {
#pragma unroll
    for (int jj = 0; jj < KMAX; ++jj) S[jj] = (FULL || jj < V) ? s0[sbase + (size_t)i * V + jj] : 0.0f;
  }
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * CK, n = min(CK, T - t0);
    const bool last = c + 1 == nc;
    if (!last) {
      __syncthreads();
      stage(t0, n);
      __syncthreads();
    }
    if (is_row && active) {
#pragma unroll
      for (int jj = 0; jj < KMAX; ++jj)
        if (FULL || jj < V) ck[((size_t)c * V + jj) * K + i] = S[jj];
      if (!last) {
        for (int tt = 0; tt < n; ++tt) {
          const float ki = s_k[tt * KMAX + i], wi = s_w[tt * KMAX + i];
#pragma unroll
          for (int jj = 0; jj < KMAX; ++jj) {
            const float kv = ki * s_v[tt * KMAX + jj];
            S[jj] = wi == 0.0f ? kv : fmaf(wi, S[jj], kv);
          }
        }
      }
    }
  }

  // backwards, chunk by chunk
  if (active) {
#pragma unroll
    for (int x = 0; x < KMAX; ++x) {
      float g = 0.0f;
      if (is_row && (FULL || x < V)) g = dsT[sbase + (size_t)i * V + x];
      if (!is_row && (FULL || x < K)) g = dsT[sbase + (size_t)x * V + j];
      G[x] = g;
    }
  }
  const float ui = is_row && active ? s_u[i] : 0.0f;  // the entry this thread wrote
  float du_acc = 0.0f;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * CK, n = min(CK, T - t0);
    __syncthreads();
    stage(t0, n);
    __syncthreads();
    if (tid < n) {                             // v_t . do_t
      float acc = 0.0f;
      for (int jj = 0; jj < V; ++jj) acc = fmaf(s_v[tid * KMAX + jj], s_do[tid * KMAX + jj], acc);
      s_vdo[tid] = acc;
    } else if (tid >= KMAX && tid - KMAX < n) {  // sum_i u_i r_i k_i
      const int tt = tid - KMAX;
      float acc = 0.0f;
      for (int ii = 0; ii < K; ++ii)
        acc = fmaf(s_u[ii] * s_r[tt * KMAX + ii], s_k[tt * KMAX + ii], acc);
      s_ruk[tt] = acc;
    }
    __syncthreads();
    if (!active) continue;
    if (is_row) {
      // recompute the chunk's states S_{t-1} into the scratch; dr on the way
#pragma unroll
      for (int jj = 0; jj < KMAX; ++jj)
        S[jj] = (FULL || jj < V) ? ck[((size_t)c * V + jj) * K + i] : 0.0f;
      for (int tt = 0; tt < n; ++tt) {
        const float ki = s_k[tt * KMAX + i], wi = s_w[tt * KMAX + i];
        float acc = 0.0f;
#pragma unroll
        for (int jj = 0; jj < KMAX; ++jj) {
          if (FULL || jj < V) {
            const float sp = S[jj];
            st[((size_t)tt * V + jj) * K + i] = sp;
            acc = fmaf(sp, s_do[tt * KMAX + jj], acc);
            const float kv = ki * s_v[tt * KMAX + jj];
            S[jj] = wi == 0.0f ? kv : fmaf(wi, sp, kv);
          }
        }
        store(dr + (row0 + (size_t)(t0 + tt) * H) * K + i, fmaf(ui * ki, s_vdo[tt], acc));
      }
      // the chunk backwards: dk, dw, du and G
      for (int tt = n - 1; tt >= 0; --tt) {
        const float ri = s_r[tt * KMAX + i], ki = s_k[tt * KMAX + i], wi = s_w[tt * KMAX + i];
        float dk_acc = 0.0f, dw_acc = 0.0f;
#pragma unroll
        for (int jj = 0; jj < KMAX; ++jj) {
          if (FULL || jj < V) {
            const float sp = st[((size_t)tt * V + jj) * K + i];
            const float g = G[jj];
            dk_acc = fmaf(g, s_v[tt * KMAX + jj], dk_acc);
            const float gs = wi == 0.0f ? 0.0f : g;
            dw_acc = fmaf(gs, sp, dw_acc);
            G[jj] = fmaf(wi, gs, ri * s_do[tt * KMAX + jj]);
          }
        }
        const size_t at = (row0 + (size_t)(t0 + tt) * H) * K + i;
        store(dk + at, fmaf(ui * ri, s_vdo[tt], dk_acc));
        dw[at] = dw_acc;
        du_acc = fmaf(ri * ki, s_vdo[tt], du_acc);
      }
    } else {
      // the chunk backwards: dv and G
      for (int tt = n - 1; tt >= 0; --tt) {
        const float doj = s_do[tt * KMAX + j];
        float acc = 0.0f;
#pragma unroll
        for (int ii = 0; ii < KMAX; ++ii) {
          if (FULL || ii < K) {
            const float g = G[ii];
            acc = fmaf(g, s_k[tt * KMAX + ii], acc);
            const float wi = s_w[tt * KMAX + ii];
            const float gs = wi == 0.0f ? 0.0f : g;
            G[ii] = fmaf(wi, gs, s_r[tt * KMAX + ii] * doj);
          }
        }
        store(dv + (row0 + (size_t)(t0 + tt) * H) * V + j, fmaf(s_ruk[tt], doj, acc));
      }
    }
  }
  if (active) {
    if (is_row) {
      du_part[(size_t)bh * K + i] = du_acc;
    } else {
#pragma unroll
      for (int ii = 0; ii < KMAX; ++ii)
        if (FULL || ii < K) ds0[sbase + (size_t)ii * V + j] = G[ii];
    }
  }
}

// du[h][i] = sum over b of du_part[b][h][i], b ascending (no atomics).
__global__ void du_sum_kernel(const float* __restrict__ du_part, float* __restrict__ du,
                              int B, int HK) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= HK) return;
  float acc = B > 0 ? du_part[x] : 0.0f;
  for (int b = 1; b < B; ++b) acc = __fadd_rn(acc, du_part[(size_t)b * HK + x]);
  du[x] = acc;
}

// Opt `kernel` into `bytes` of dynamic shared memory once per device (a bit
// per device id in `done`), where it needs more than the default 48 KB.
template <typename Kernel>
cudaError_t smem_opt_in(Kernel kernel, int bytes, std::atomic<unsigned long long>& done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
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

template <typename E, bool FULL>
int launch_path(const E* r, const E* k, const E* v, const float* w, const float* u,
                const float* s0, const E* dout, const float* dsT, E* dr, E* dk, E* dv,
                float* dw, float* du_part, float* ds0, float* ckpt, float* states, int B,
                int T, int H, int K, int V, cudaStream_t stream) {
  auto kernel = wkv6_bwd_kernel<E, FULL>;
  static std::atomic<unsigned long long> done{0};
  const int bytes = smem_floats(T < CK ? T : CK) * (int)sizeof(float);
  const cudaError_t err = smem_opt_in(kernel, smem_floats(CK) * (int)sizeof(float), done);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(B * H), THREADS, bytes, stream>>>(r, k, v, w, u, s0, dout, dsT, dr, dk,
                                                        dv, dw, du_part, ds0, ckpt, states, T,
                                                        H, K, V);
  return (int)cudaGetLastError();
}

template <typename E>
int launch(const E* r, const E* k, const E* v, const float* w, const float* u,
           const float* s0, const E* dout, const float* dsT, E* dr, E* dk, E* dv, float* dw,
           float* du, float* ds0, float* du_part, float* ckpt, float* states, int B, int T,
           int H, int K, int V, void* stream) {
  if (K < 1 || K > KMAX || V < 1 || V > KMAX || T < 0 || B < 0 || H < 0)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (B > 0 && H > 0) {
    const int err =
        K == KMAX && V == KMAX
            ? launch_path<E, true>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du_part, ds0,
                                   ckpt, states, B, T, H, K, V, st)
            : launch_path<E, false>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du_part,
                                    ds0, ckpt, states, B, T, H, K, V, st);
    if (err) return err;
  }
  const int hk = H * K;
  if (hk > 0) {
    du_sum_kernel<<<(unsigned)((hk + 255) / 256), 256, 0, st>>>(du_part, du, B, hk);
    return (int)cudaGetLastError();
  }
  return 0;
}

}  // namespace

// Inputs: r, k (B, T, H, K), v (B, T, H, V), dout (B, T, H, V) float32
// (_f32) or bfloat16 (_bf16); w (B, T, H, K), u (H, K), s0 and dsT
// (B, H, K, V) float32. Outputs: dr, dk (B, T, H, K) and dv (B, T, H, V)
// in the inputs' type; dw (B, T, H, K), du (H, K) and ds0 (B, H, K, V)
// float32. Scratch (float32): du_part B H K, ckpt B H ceil(T / CK) K V,
// states B H min(T, CK) K V, CK = 16. All contiguous; 1 <= K, V <= 64; T >= 0.
// Launches on `stream` (the gradient kernel, then the sum of du over b),
// allocates nothing, returns cudaGetLastError().
extern "C" int wkv6_bwd_f32(const float* r, const float* k, const float* v, const float* w,
                            const float* u, const float* s0, const float* dout,
                            const float* dsT, float* dr, float* dk, float* dv, float* dw,
                            float* du, float* ds0, float* du_part, float* ckpt,
                            float* states, int B, int T, int H, int K, int V, void* stream) {
  return launch(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0, du_part, ckpt, states,
                B, T, H, K, V, stream);
}

extern "C" int wkv6_bwd_bf16(const __nv_bfloat16* r, const __nv_bfloat16* k,
                             const __nv_bfloat16* v, const float* w, const float* u,
                             const float* s0, const __nv_bfloat16* dout, const float* dsT,
                             __nv_bfloat16* dr, __nv_bfloat16* dk, __nv_bfloat16* dv,
                             float* dw, float* du, float* ds0, float* du_part, float* ckpt,
                             float* states, int B, int T, int H, int K, int V,
                             void* stream) {
  return launch(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0, du_part, ckpt, states,
                B, T, H, K, V, stream);
}
