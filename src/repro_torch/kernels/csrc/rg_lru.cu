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
// 2560) 62.9 MB, 0.0188 ms of HBM at 3.35 TB/s. The chain of one channel
// is 2 T dependent operations (~8 cycles a step, ~4,100 cycles or ~2.3 us
// at that shape): a tenth of the bound. So the kernel is as fast as the
// bytes it keeps in flight. Streaming at 3.35 TB/s with a loaded latency of
// ~0.65 us needs ~2 MB in flight across the card, ~15 KB an SM.
//
// Why no scan over time in parallel: a chunked scan would compute h_t as
// A h_s plus a local sum, which rounds otherwise than the chain above, and
// the contract is the plain version's bits. Each channel's chain stays
// sequential, step for step; the designs differ only in how its operands
// arrive.
//
// v1 (rg_lru_scan_kernel; the plan's choice for decode, T = 1, for R not a
// multiple of 4 and for operands not 16-byte aligned): one thread a (b, r),
// consecutive threads on consecutive channels (coalesced across a warp),
// blocks of 128; each thread loads kAhead = 8 steps of a and g ahead of its
// chain. At the prefill shape: 10,240 threads in 80 blocks, 52 of the 132
// SMs idle, at most 8 steps x 2 streams x 4 B x 10,240 = 655 KB in flight,
// a third of what the card needs (measured: 38% of the bound).
//
// v2 (rg_lru_scan_v2_kernel; kernels/rg_lru.py::_plan picks it from the
// shape and the pointers' alignment before the launch): one warp a block,
// 32 consecutive channels r0 .. r0 + 31 of one batch row b (B * ceil(R /
// 32) blocks: 320 at the prefill shape, every SM busy). Its operands come
// through a ring of kStages stages in shared memory, each a tile of kSteps
// steps x 32 channels of a and of g (8 KB at kSteps = 32; 32 KB a block),
// filled by cp.async.cg 16-byte copies (8 lanes a 128-byte row) and
// completed by commit and wait groups: the warp issues the copies of tile
// k + kStages - 1 before it waits for tile k, so kStages - 1 tiles are in
// flight while it runs the chain on the oldest. That is 24 KB a block,
// ~7.7 MB across the card at the prefill shape, ~4x the ~2 MB needed, with
// no producer warp and no registers held for it. The chain reads its
// operands from shared memory (a full tile unrolled, so the loads never
// wait on h) and writes y straight from registers, 128 coalesced bytes a
// warp a step. Preconditions (the plan's, and checked here): R % 4 == 0
// and a, g, y 16-byte aligned, so every 16-byte copy is aligned. A ragged
// tile (T % kSteps, or R % 32 channels) copies and stores only what exists.
// Measured (tools/kernel_ab.py --kernel rg_lru, H100 80GB HBM3 at 700 W):
// 0.0235-0.0240 ms at the prefill shape, 78-80% of the bound, from v1's
// 0.0499-0.0507, against 0.0218-0.0228 ms for a torch.add of the same bytes
// (no chain): near what the card streams at this mix. More in flight was
// slower, not faster (5 stages 74.5%, 6 stages 72%, 16-step stages 72-79%).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;            // v1: threads a block
constexpr int kAhead = 8;                // v1: steps loaded ahead of the chain
constexpr int kLanes = 32;               // v2: channels (threads) a block
constexpr int kSteps = 32;               // v2 forward: steps a stage of the ring
constexpr int kStages = 4;               // v2 forward: stages of the ring
constexpr int kBwdSteps = 16;            // v2 backward: steps a stage (3 streams)
constexpr int kBwdStages = 3;            // v2 backward: stages of the ring
constexpr int kRowChunks = kLanes / 4;   // 16-byte copies a stage row
constexpr int kRowsAtOnce = kLanes / kRowChunks;   // stage rows a warp copies at once

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies `rows` rows of a (T, R) slab, from slab row `row0` on, into the
// stage `tile` (Steps x kLanes floats, row i from slab row row0 + i): the
// `chunks` 16-byte pieces of the block's channels. `src` points at the
// block's first channel of the slab's row 0.
template <int Steps>
__device__ __forceinline__ void stage_rows(float* tile, const float* src, long long R,
                                           int row0, int rows, int chunks) {
  const int c = threadIdx.x % kRowChunks;
  if (c >= chunks) return;
#pragma unroll
  for (int m = 0; m < Steps / kRowsAtOnce; ++m) {
    const int i = m * kRowsAtOnce + static_cast<int>(threadIdx.x) / kRowChunks;
    if (i < rows) cp_async16(tile + i * kLanes + 4 * c, src + (row0 + i) * R + 4 * c);
  }
}

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

__global__ void __launch_bounds__(kLanes)
rg_lru_scan_v2_kernel(const float* __restrict__ a, const float* __restrict__ g,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ hT, int T, int R) {
  __shared__ __align__(16) float sa[kStages][kSteps * kLanes];
  __shared__ __align__(16) float sg[kStages][kSteps * kLanes];
  const int lane = threadIdx.x;
  const int tiles_r = (R + kLanes - 1) / kLanes;
  const int b = blockIdx.x / tiles_r;
  const int r0 = (blockIdx.x - b * tiles_r) * kLanes;
  const int nc = min(kLanes, R - r0);     // a multiple of 4
  const bool live = lane < nc;
  const long long stride = R;
  const long long slab = static_cast<long long>(b) * T * R + r0;
  const float* ap = a + slab;
  const float* gp = g + slab;
  float* yp = y + slab + lane;
  const long long hidx = static_cast<long long>(b) * R + r0 + lane;
  float h = live ? h0[hidx] : 0.0f;
  const int tiles = (T + kSteps - 1) / kSteps;

  auto issue = [&](int k) {     // the copies of tile k into stage k % kStages
    if (k < tiles) {
      const int t0 = k * kSteps, n = min(kSteps, T - t0);
      stage_rows<kSteps>(sa[k % kStages], ap, stride, t0, n, nc / 4);
      stage_rows<kSteps>(sg[k % kStages], gp, stride, t0, n, nc / 4);
    }
    cp_async_commit();          // an empty group past the last tile
  };
  for (int k = 0; k < kStages - 1; ++k) issue(k);
  for (int k = 0; k < tiles; ++k) {
    issue(k + kStages - 1);     // into the stage read in step k - 1
    cp_async_wait<kStages - 1>();   // this lane's copies of tile k have landed
    __syncwarp();                   // and every lane's
    const float* ta = sa[k % kStages] + lane;
    const float* tg = sg[k % kStages] + lane;
    const int t0 = k * kSteps;
    float* yt = yp + t0 * stride;
    if (T - t0 >= kSteps) {
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        h = __fadd_rn(__fmul_rn(ta[j * kLanes], h), tg[j * kLanes]);
        if (live) yt[j * stride] = h;
      }
    } else {
      for (int j = 0; j < T - t0; ++j) {
        h = __fadd_rn(__fmul_rn(ta[j * kLanes], h), tg[j * kLanes]);
        if (live) yt[j * stride] = h;
      }
    }
    __syncwarp();               // the stage is read before step k + 1 refills it
  }
  if (live) hT[hidx] = h;
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
// v1: the forward's v1 run from the last step, the loads of kAhead steps
// (a_t, dy_t, y_{t-1}) issued ahead of the chain: ~983 KB in flight at the
// training shape (measured: 47% of the bound).
//
// v2: the forward's v2 run from the last tile down, with three streams a
// stage (a, dy and y one step behind: the tile of steps [t0, t0 + kBwdSteps)
// holds y at [t0 - 1, t0 + kBwdSteps - 1), and h0 in the row of t = -1):
// 6 KB a stage at kBwdSteps = 16, kBwdStages = 3 (18 KB a block), 12 KB a
// block and ~3.8 MB across the card in flight at the training shape. da
// and dg are written straight from registers. Measured as the forward:
// 0.0386-0.0397 ms, 79-81% of the bound, from v1's 0.0670; stages of 32 steps
// (4 stages 68.8%, 3 stages 69.6%, 2 stages 78.4%) and deeper rings of
// smaller stages (8 steps: 69.1-80.2%) were no faster.
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

__global__ void __launch_bounds__(kLanes)
rg_lru_scan_bwd_v2_kernel(const float* __restrict__ a, const float* __restrict__ y,
                          const float* __restrict__ h0, const float* __restrict__ dy,
                          const float* __restrict__ dhT, float* __restrict__ da,
                          float* __restrict__ dg, float* __restrict__ dh0, int T, int R) {
  __shared__ __align__(16) float sa[kBwdStages][kBwdSteps * kLanes];
  __shared__ __align__(16) float sdy[kBwdStages][kBwdSteps * kLanes];
  __shared__ __align__(16) float sy[kBwdStages][kBwdSteps * kLanes];   // y one step behind
  const int lane = threadIdx.x;
  const int tiles_r = (R + kLanes - 1) / kLanes;
  const int b = blockIdx.x / tiles_r;
  const int r0 = (blockIdx.x - b * tiles_r) * kLanes;
  const int nc = min(kLanes, R - r0);     // a multiple of 4
  const bool live = lane < nc;
  const long long stride = R;
  const long long slab = static_cast<long long>(b) * T * R + r0;
  const float* ap = a + slab;
  const float* yp = y + slab;
  const float* dyp = dy + slab;
  float* dap = da + slab + lane;
  float* dgp = dg + slab + lane;
  const long long hidx = static_cast<long long>(b) * R + r0 + lane;
  const float h_init = live ? h0[hidx] : 0.0f;
  float c = live ? dhT[hidx] : 0.0f;
  const int tiles = (T + kBwdSteps - 1) / kBwdSteps;

  auto issue = [&](int i) {     // the copies of tile tiles - 1 - i into stage i % kBwdStages
    if (i < tiles) {
      const int t0 = (tiles - 1 - i) * kBwdSteps, n = min(kBwdSteps, T - t0);
      const int s = i % kBwdStages;
      stage_rows<kBwdSteps>(sa[s], ap, stride, t0, n, nc / 4);
      stage_rows<kBwdSteps>(sdy[s], dyp, stride, t0, n, nc / 4);
      if (t0 > 0) stage_rows<kBwdSteps>(sy[s], yp, stride, t0 - 1, n, nc / 4);
      else stage_rows<kBwdSteps>(sy[s] + kLanes, yp, stride, 0, n - 1, nc / 4);   // row 0: h0
    }
    cp_async_commit();
  };
  for (int i = 0; i < kBwdStages - 1; ++i) issue(i);
  for (int i = 0; i < tiles; ++i) {
    issue(i + kBwdStages - 1);
    cp_async_wait<kBwdStages - 1>();
    __syncwarp();
    const int s = i % kBwdStages;
    const int t0 = (tiles - 1 - i) * kBwdSteps;
    if (t0 == 0) sy[s][lane] = h_init;    // this lane's column only: no barrier
    const float* ta = sa[s] + lane;
    const float* tdy = sdy[s] + lane;
    const float* ty = sy[s] + lane;
    float* dat = dap + t0 * stride;
    float* dgt = dgp + t0 * stride;
    if (T - t0 >= kBwdSteps) {
#pragma unroll
      for (int j = kBwdSteps - 1; j >= 0; --j) {
        const float dh = __fadd_rn(tdy[j * kLanes], c);
        if (live) {
          dgt[j * stride] = dh;
          dat[j * stride] = __fmul_rn(dh, ty[j * kLanes]);
        }
        c = __fmul_rn(ta[j * kLanes], dh);
      }
    } else {
      for (int j = T - t0 - 1; j >= 0; --j) {
        const float dh = __fadd_rn(tdy[j * kLanes], c);
        if (live) {
          dgt[j * stride] = dh;
          dat[j * stride] = __fmul_rn(dh, ty[j * kLanes]);
        }
        c = __fmul_rn(ta[j * kLanes], dh);
      }
    }
    __syncwarp();
  }
  if (live) dh0[hidx] = c;
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

}  // namespace

// a, g, y (B, T, R) and h0, hT (B, R), float32, contiguous, T > 0. v1:
// rg_lru_scan_f32; v2: rg_lru_scan_v2_f32, which returns -1 (and launches
// nothing) unless R % 4 == 0 and a, g and y are 16-byte aligned. Each
// launches on `stream`, allocates nothing, returns cudaGetLastError().
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

extern "C" int rg_lru_scan_v2_f32(const void* a, const void* g, const void* h0, void* y,
                                  void* hT, int B, int T, int R, void* stream) {
  if (R % 4 || !aligned16(a) || !aligned16(g) || !aligned16(y)) return -1;
  const long long blocks = static_cast<long long>(B) * ((R + kLanes - 1) / kLanes);
  if (blocks == 0) return 0;
  rg_lru_scan_v2_kernel<<<static_cast<unsigned int>(blocks), kLanes, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(g),
      static_cast<const float*>(h0), static_cast<float*>(y), static_cast<float*>(hT), T, R);
  return static_cast<int>(cudaGetLastError());
}

// a, y, dy, da, dg (B, T, R) and h0, dhT, dh0 (B, R), float32, contiguous,
// T > 0. v1: rg_lru_scan_bwd_f32; v2: rg_lru_scan_bwd_v2_f32, which returns
// -1 (and launches nothing) unless R % 4 == 0 and a, y, dy, da and dg are
// 16-byte aligned. Each launches on `stream`, allocates nothing, returns
// cudaGetLastError().
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

extern "C" int rg_lru_scan_bwd_v2_f32(const void* a, const void* y, const void* h0,
                                      const void* dy, const void* dhT, void* da, void* dg,
                                      void* dh0, int B, int T, int R, void* stream) {
  if (R % 4 || !aligned16(a) || !aligned16(y) || !aligned16(dy) || !aligned16(da) ||
      !aligned16(dg))
    return -1;
  const long long blocks = static_cast<long long>(B) * ((R + kLanes - 1) / kLanes);
  if (blocks == 0) return 0;
  rg_lru_scan_bwd_v2_kernel<<<static_cast<unsigned int>(blocks), kLanes, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(y),
      static_cast<const float*>(h0), static_cast<const float*>(dy),
      static_cast<const float*>(dhT), static_cast<float*>(da), static_cast<float*>(dg),
      static_cast<float*>(dh0), T, R);
  return static_cast<int>(cudaGetLastError());
}
