// The RG-LRU's linear scan for Hopper (sm_90a).
//
// Replaces no TPU kernel: src/repro/models/recurrentgemma.py::_rg_lru runs
// the recurrence as a lax.scan over time, outside Pallas. Run eagerly, that
// scan is T dependent steps of small tensor ops a recurrent layer (512 steps
// a prefill wave, two launches each, over 18 recurrent layers); this kernel
// does a layer's scan in one launch.
//
// For every (b, r): h = h0[b][r], then for t = 0 .. T-1
//   h = a[b][t][r] * h + g[b][t][r],   y[b][t][r] = h,
// and hT[b][r] = h. All float32. The multiply and the add are each rounded
// (__fmul_rn then __fadd_rn: nvcc may not contract them into an fmaf), so
// the kernel equals kernels/ref.py::rg_lru_scan_ref, a torch.mul then a
// torch.add a step, bit for bit on the card and on the CPU.
//
// Bound: bytes. a and g are read once and y written once (12 bytes a
// (b, t, r)), against two FP32 operations: at the prefill shape (4, 512,
// 2560) 62.9 MB, 0.0188 ms of HBM at 3.35 TB/s.
//
// Design (simple first): one thread a (b, r), consecutive threads on
// consecutive channels, so every step's loads and stores are coalesced
// across a warp; the thread loops over T. The loads of a_t and g_t do not
// depend on h, so they are issued a chunk of kAhead steps ahead of the
// dependent chain: the next chunk is loaded into registers while the
// current one is applied. At the prefill shape that is 10,240 threads,
// 80 blocks on 132 SMs: the card is far from full, and each thread's
// chain of 2 T dependent operations sets the time once the loads are
// hidden.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAhead = 8;                // steps loaded ahead of the chain

__global__ void rg_lru_scan_kernel(const float* __restrict__ a,    // (B, T, R)
                                   const float* __restrict__ g,    // (B, T, R)
                                   const float* __restrict__ h0,   // (B, R)
                                   float* __restrict__ y,          // (B, T, R)
                                   float* __restrict__ hT,         // (B, R)
                                   int T, int R, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long b = idx / R;
  const long long r = idx - b * R;
  const long long stride = R;
  const long long base = b * static_cast<long long>(T) * R + r;
  const float* ap = a + base;
  const float* gp = g + base;
  float* yp = y + base;
  float h = h0[idx];

  const int full = T / kAhead * kAhead;
  float an[kAhead], gn[kAhead];
  if (full > 0) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      an[j] = ap[j * stride];
      gn[j] = gp[j * stride];
    }
  }
  for (int t = 0; t < full; t += kAhead) {
    float ac[kAhead], gc[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      ac[j] = an[j];
      gc[j] = gn[j];
    }
    if (t + kAhead < full) {
      const long long off = static_cast<long long>(t + kAhead) * stride;
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        an[j] = ap[off + j * stride];
        gn[j] = gp[off + j * stride];
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      h = __fadd_rn(__fmul_rn(ac[j], h), gc[j]);
      yp[static_cast<long long>(t + j) * stride] = h;
    }
  }
  for (int t = full; t < T; ++t) {
    const long long off = static_cast<long long>(t) * stride;
    h = __fadd_rn(__fmul_rn(ap[off], h), gp[off]);
    yp[off] = h;
  }
  hT[idx] = h;
}

}  // namespace

extern "C" int rg_lru_scan_f32(const void* a, const void* g, const void* h0, void* y,
                               void* hT, int B, int T, int R, void* stream) {
  const long long total = static_cast<long long>(B) * R;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  rg_lru_scan_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(g),
      static_cast<const float*>(h0), static_cast<float*>(y), static_cast<float*>(hT), T, R,
      total);
  return static_cast<int>(cudaGetLastError());
}
