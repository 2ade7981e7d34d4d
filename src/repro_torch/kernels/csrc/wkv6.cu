// RWKV-6 (Finch) WKV recurrence, for Hopper (sm_90a).
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
// 0.053 ms). This kernel does 7 K V (the bonus term per (i, j)). At decode
// (T=1) the bound is microseconds and the launch sets the time.
//
// Design: the TPU kernel walks a (B*H, T/chunk) grid in order and carries S
// in VMEM scratch from one chunk step to the next. Blocks on Hopper run in
// no order, so the sequential T axis becomes a loop inside one block: one
// block per (b, h), holding S in registers for the whole sequence. The
// steps of T are a chain, and at rwkv6-7b's B*H = 256 blocks the card has
// few warps to hide each step's latency with, so each state column j is
// split over SPLIT = 4 neighbouring threads: thread p of column j holds rows
// i = p, p + 4, ... (16 floats at K = 64), which gives 4x the warps and a
// 4x shorter dependent chain per step, and its partial sum is folded with
// two quad shuffles. Each step stages (r_i, k_i, w_i, u_i) as one float4 per
// i in shared memory (the four threads of a column read four neighbouring
// float4s: no bank conflict), double-buffered so a step needs one barrier.
// The next step's loads are issued before this step's arithmetic, so their
// latency overlaps it. r, k, v, w are read in place from their (B, T, H, .)
// layout and out is written in its (B, T, H, V) layout: no transposed copy
// is made. The sum over i runs in a fixed order (each thread's rows in
// order, then (p0 + p1) + (p2 + p3)). K and V are at most 64. r, k, v and
// out are float32 or bfloat16 (widened exactly as a step is staged, out
// rounded to nearest even on store); w, u and the state are float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 64;
constexpr int SPLIT = 4;                 // threads per state column
constexpr int ROWS = KMAX / SPLIT;       // state rows per thread
constexpr int THREADS = KMAX * SPLIT;

// Loads keep the element type; widening happens when a step is staged, so
// the next step's loads stay in flight under this step's arithmetic (a
// widening right after the load would wait for it).
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 load(const __nv_bfloat16* p) { return *p; }
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename E>
__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const E* __restrict__ r, const E* __restrict__ k,
            const E* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            E* __restrict__ out, float* __restrict__ s_out,
            int T, int H, int K, int V) {
  __shared__ float4 s_rkwu[2][KMAX];     // (r_i, k_i, w_i, u_i) per step

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int j = tid / SPLIT;             // state column of this thread
  const int p = tid % SPLIT;             // its rows: p, p + SPLIT, ...
  const bool col = j < V;
  const bool row = tid < K;              // this thread stages element i = tid

  float s[ROWS];
  const size_t sbase = (size_t)bh * K * V;
#pragma unroll
  for (int ii = 0; ii < ROWS; ++ii) {
    const int i = ii * SPLIT + p;
    s[ii] = (col && i < K) ? s0[sbase + (size_t)i * V + j] : 0.0f;
  }
  const float ui = row ? __ldg(u + (size_t)h * K + tid) : 0.0f;

  // element (b, t, h, i) of a (B, T, H, D) array is at ((b*T + t)*H + h)*D + i
  const size_t row0 = (size_t)b * T * H + h;
  const size_t kstep = (size_t)H * K;
  const size_t vstep = (size_t)H * V;
  const E* rp = r + row0 * K + tid;
  const E* kp = k + row0 * K + tid;
  const float* wp = w + row0 * K + tid;
  const E* vp = v + row0 * V + j;
  E* op = out + row0 * V + j;

  E nr{}, nk{}, nv{};
  float nw = 0.0f;
  if (T > 0) {
    if (row) { nr = load(rp); nk = load(kp); nw = load(wp); }
    if (col) nv = load(vp);
  }
  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    if (row) s_rkwu[buf][tid] = make_float4(widen(nr), widen(nk), nw, ui);
    const float vj = widen(nv);
    __syncthreads();
    if (t + 1 < T) {
      const size_t kn = (size_t)(t + 1) * kstep, vn = (size_t)(t + 1) * vstep;
      if (row) { nr = load(rp + kn); nk = load(kp + kn); nw = load(wp + kn); }
      if (col) nv = load(vp + vn);
    }
    float acc = 0.0f;
    if (col) {
#pragma unroll
      for (int ii = 0; ii < ROWS; ++ii) {
        const int i = ii * SPLIT + p;
        if (i < K) {
          const float4 e = s_rkwu[buf][i];
          const float kv = e.y * vj;
          acc = fmaf(e.x, fmaf(e.w, kv, s[ii]), acc);
          s[ii] = e.z == 0.0f ? kv : fmaf(e.z, s[ii], kv);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (col && p == 0) store(op + (size_t)t * vstep, acc);
  }
  if (col) {
#pragma unroll
    for (int ii = 0; ii < ROWS; ++ii) {
      const int i = ii * SPLIT + p;
      if (i < K) s_out[sbase + (size_t)i * V + j] = s[ii];
    }
  }
}

template <typename E>
int launch(const E* r, const E* k, const E* v, const float* w, const float* u,
           const float* s0, E* out, float* s_out, int B, int T, int H, int K,
           int V, void* stream) {
  if (K < 1 || K > KMAX || V < 1 || V > KMAX || T < 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  wkv6_kernel<E><<<(unsigned)(B * H), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      r, k, v, w, u, s0, out, s_out, T, H, K, V);
  return (int)cudaGetLastError();
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
