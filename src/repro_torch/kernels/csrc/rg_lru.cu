// The RG-LRU's linear scan for Hopper (sm_90a), and its gradient
// (rg_lru_scan_bwd, below the forward).
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

// The scan's gradient, read backwards (rg_lru_scan_bwd): for every (b, r),
// c = dhT[b][r], then for t = T-1 .. 0
//   dh = dy_t + c,   dg_t = dh,   da_t = dh * h_{t-1},   c = a_t * dh,
// with h_{t-1} the forward's y_{t-1} (h0 at t = 0), and dh0 = c. Each
// multiply and add rounded on its own (__fmul_rn, __fadd_rn): bit for bit
// kernels/ref.py::rg_lru_scan_bwd_ref.
//
// Bound: bytes. a, y and dy are read once and da and dg written once (20
// bytes a (b, t, r)) against three FP32 operations: at the training shape
// (4, 512, 2560) 104.9 MB, 0.031 ms of HBM at 3.35 TB/s.
//
// Design: the forward's, run from the last step: one thread a (b, r) on
// consecutive channels (coalesced across a warp), the loads of kAhead
// steps (a_t, dy_t, y_{t-1}) issued ahead of the dependent chain.
__global__ void rg_lru_scan_bwd_kernel(const float* __restrict__ a,    // (B, T, R)
                                       const float* __restrict__ y,    // (B, T, R)
                                       const float* __restrict__ h0,   // (B, R)
                                       const float* __restrict__ dy,   // (B, T, R)
                                       const float* __restrict__ dhT,  // (B, R)
                                       float* __restrict__ da,         // (B, T, R)
                                       float* __restrict__ dg,         // (B, T, R)
                                       float* __restrict__ dh0,        // (B, R)
                                       int T, int R, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long b = idx / R;
  const long long r = idx - b * R;
  const long long stride = R;
  const long long base = b * static_cast<long long>(T) * R + r;
  const float* ap = a + base;
  const float* yp = y + base;
  const float* dyp = dy + base;
  float* dap = da + base;
  float* dgp = dg + base;
  const float h_init = h0[idx];
  float c = dhT[idx];

  // steps T-1 .. T-rem one at a time, then whole chunks of kAhead
  const int rem = T % kAhead;
  for (int t = T - 1; t >= T - rem; --t) {
    const long long off = static_cast<long long>(t) * stride;
    const float dh = __fadd_rn(dyp[off], c);
    dgp[off] = dh;
    dap[off] = __fmul_rn(dh, t ? yp[off - stride] : h_init);
    c = __fmul_rn(ap[off], dh);
  }
  const int full = T - rem;                 // steps [0, full) in chunks
  float an[kAhead], dyn[kAhead], hn[kAhead];
  auto load = [&](int t0, float (&ax)[kAhead], float (&dyx)[kAhead], float (&hx)[kAhead]) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const long long off = static_cast<long long>(t0 + j) * stride;
      ax[j] = ap[off];
      dyx[j] = dyp[off];
      hx[j] = t0 + j ? yp[off - stride] : h_init;
    }
  };
  if (full > 0) load(full - kAhead, an, dyn, hn);
  for (int t0 = full - kAhead; t0 >= 0; t0 -= kAhead) {
    float ac[kAhead], dyc[kAhead], hc[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      ac[j] = an[j];
      dyc[j] = dyn[j];
      hc[j] = hn[j];
    }
    if (t0 > 0) load(t0 - kAhead, an, dyn, hn);
#pragma unroll
    for (int j = kAhead - 1; j >= 0; --j) {
      const long long off = static_cast<long long>(t0 + j) * stride;
      const float dh = __fadd_rn(dyc[j], c);
      dgp[off] = dh;
      dap[off] = __fmul_rn(dh, hc[j]);
      c = __fmul_rn(ac[j], dh);
    }
  }
  dh0[idx] = c;
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

// a, y, dy, da, dg (B, T, R) and h0, dhT, dh0 (B, R), float32, contiguous.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int rg_lru_scan_bwd_f32(const void* a, const void* y, const void* h0,
                                   const void* dy, const void* dhT, void* da, void* dg,
                                   void* dh0, int B, int T, int R, void* stream) {
  const long long total = static_cast<long long>(B) * R;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  rg_lru_scan_bwd_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(y),
      static_cast<const float*>(h0), static_cast<const float*>(dy),
      static_cast<const float*>(dhT), static_cast<float*>(da), static_cast<float*>(dg),
      static_cast<float*>(dh0), T, R, total);
  return static_cast<int>(cudaGetLastError());
}
