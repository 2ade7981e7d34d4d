// The gradient of the RWKV-6 (Finch) WKV recurrence, for Hopper (sm_90a): v2.
//
// Replaces no TPU kernel: src/repro/kernels/wkv6.py has no backward, and
// the reference trains through jax.vjp of its plain scan
// (src/repro/kernels/ref.py::wkv6_ref, the default of
// src/repro/models/rwkv6.py). This kernel computes that vjp; the plain
// version is kernels/ref.py::wkv6_bwd_ref, and kernels/ref.py::
// wkv6_bwd_fma_ref repeats this kernel's arithmetic bit for bit.
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
// and their gradients, float32 w, dw and states) that is 7.6 G operations,
// 0.114 ms at 67 TFLOP/s float32, against 197 MB read and written (0.059 ms
// at 3.35 TB/s): the operations bind.
//
// Design (v2). v1 (one row thread and one column thread a state row and
// column, 128 threads a (b, h)) wrote every recomputed state to device
// memory and read it back (4.3 GB at the training shape), ran 64-long FMA
// chains with 2 warps a scheduler, and ran the G recurrence twice. v2:
// - A block of 512 threads a (b, h), one block an SM (<= 128 registers a
//   thread); the sequential T axis is a loop inside it. Thread (warp w,
//   lane l) owns the 2 x 4 tile of rows 2 rg, 2 rg + 1 (rg = 2 w + l / 16)
//   and columns 4 cg .. 4 cg + 3 (cg = l % 16) of S and of G. K and V are
//   padded to 64 in shared memory (r, k, v, do, u and the states 0, w 1),
//   so the tile runs the same code at every K, V <= 64.
// - States stay on the SM. A forward sweep from s0 keeps the state in
//   registers and writes a checkpoint (thread-native order, 32 bytes a
//   thread) at the start of chunks 1 .. nc - 2 of CK steps (nc chunks);
//   its last chunk's end state is the first backward chunk's start. Then
//   the chunks run from the last: a chunk's CK states are recomputed from
//   its checkpoint into registers (dr on the way, which needs S_{t-1} in
//   forward order), and the chunk is walked backwards from them (dk, dw, dv
//   and G). At CK = 8 that is 64 registers of states a thread and 2 x
//   4 x 64 x 62 x 16 KB = 260 MB of checkpoint traffic at the training
//   shape, against v1's 4.3 GB of states.
// - Sums in a fixed order, no atomics. A thread's partial over its 4
//   columns is one chain (the first term a rounded multiply, then fmaf);
//   the 16 lanes of a row then add in a butterfly over lane masks 8, 4, 2,
//   1. Inside a step only the first levels run as shuffles, halving (a lane
//   keeps half of its values and sends the other half): dr mask 8, dk and dw
//   masks 8 and 4; each lane stores its one partial, and the pass after the
//   chunk adds the rest of the same tree. dv: a thread's partial over its 2
//   rows, the two half-warps added (mask 16), each warp's sum of its 4 rows
//   stored, and after the chunk the 16 warps' sums added in warp order.
//   v . do and sum_i u_i r_i k_i: a warp a step, lane l summing elements l
//   and l + 32, then masks 16 .. 1. du: one thread a row, an fmaf chain over
//   t descending; a second launch sums the (B, H, K) partials over b in
//   order. The steps of a whole chunk are straight-line code: no branch
//   (the last chunk, when shorter, takes a guarded copy).
// - G is formed once a step, and dv reads it from the same tile as dk and
//   dw.
// - Staging. The sweep copies SW = 4 CK steps of k, w and v at a time by
//   cp.async (16 bytes a copy) into one of two buffers while the other is
//   swept, and reads the copies as they are: one barrier per SW steps, which
//   also ORs "some w_i == 0" over the block, so a block without one runs
//   the update as fmaf alone. The backward copies the next chunk's r, k, w,
//   v and do and its checkpoint the same way; a widening pass fills one of
//   two padded float buffers, and the pass that folds and writes a chunk's
//   gradients runs between the same two barriers as the widening of the
//   next. Shapes other than K = V = 64, or views off 16-byte alignment,
//   stage with plain loads (the element path); the arithmetic is the same.
// Explicit __fmul_rn / __fmaf_rn / __fadd_rn keep every rounding where
// wkv6_bwd_fma_ref puts it; bf16 inputs are widened exactly and bf16
// gradients rounded once, to nearest even.
// v1 -> v2 device time at the training shape (tools/kernel_ab.py --kernel
// wkv6_bwd, H100 80GB HBM3 at 700 W): 1.9981 -> 0.6563 ms with bf16 r, k,
// v (17.4% of the bound), 1.9507 -> 0.6656 in float32; v1 with 8-step
// chunks (its scratch inside L2) 1.6935. CK = 8 was chosen by measurement
// (kernel_ab's --trial LABEL=CK=N builds a copy with another CK): 4, 6
// and 10 were slower. Where a block's cycles go (tools/wkv6_bwd_probe.py):
// the sweep 18% (its 260 MB of checkpoint writes bind it), the chunks'
// steps 52%, folding and writing the gradients 13-15%, the copies 7-11%,
// widening 4%. Folding inside the steps instead, a tree over the warps' dv
// sums, or copies spread evenly over the threads were no faster.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int KMAX = 64;                 // state rows and columns a block holds (K, V padded)
constexpr int CK = 8;                    // steps a checkpoint covers (kernels/wkv6.py's BWD_CHUNK)
constexpr int SW = 4 * CK;               // steps the sweep stages at a time
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr unsigned ALL = 0xffffffffu;
static_assert(CK >= 1 && CK <= 16, "1 <= CK <= 16: a chunk's states live in registers");
static_assert(THREADS * 8 == KMAX * KMAX, "8 state elements a thread: 2 rows x 4 columns");

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Two (four) neighbouring elements as floats, widened exactly: one access.
__device__ __forceinline__ void load2(const float* p, float (&x)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  x[0] = t.x; x[1] = t.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float (&x)[2]) {
  const unsigned t = *reinterpret_cast<const unsigned*>(p);
  x[0] = __uint_as_float(t << 16); x[1] = __uint_as_float(t & 0xFFFF0000u);
}
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(t.x << 16); x[1] = __uint_as_float(t.x & 0xFFFF0000u);
  x[2] = __uint_as_float(t.y << 16); x[3] = __uint_as_float(t.y & 0xFFFF0000u);
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

__host__ __device__ constexpr int up16(int bytes) { return (bytes + 15) / 16 * 16; }

// One of the two widened, padded chunk buffers (a step's row or column x
// at tt * KMAX + x): pk (r, k, w, 0) a row, pv and pdo a column; vdo and
// ruk a step.
struct Wide {
  float4* pk;
  float* pv;
  float* pdo;
  float* vdo;
  float* ruk;
  static constexpr int bytes = CK * KMAX * 24 + 2 * up16(CK * 4);
  __device__ explicit Wide(char* p)
      : pk(reinterpret_cast<float4*>(p)),
        pv(reinterpret_cast<float*>(p + CK * KMAX * 16)),
        pdo(pv + CK * KMAX),
        vdo(pdo + CK * KMAX),
        ruk(reinterpret_cast<float*>(p + CK * KMAX * 24 + up16(CK * 4))) {}
};

// Shared memory of a block. ck: two checkpoint buffers, 8 floats a thread.
// Per chunk, the partial sums the steps leave (prd: dr after mask 8, prw:
// dk and dw after masks 8 and 4, each a float a lane and step, at tt *
// THREADS + tid; dvp: each warp's sum of dv over its 4 rows, step, warp,
// column); the sweep's two buffers of SW steps of k, w and v as copied use
// the same bytes. The backward's copies of a chunk (rw, rr, rk, rv, rdo;
// real rows and columns only); su = u.
template <typename E>
struct Smem {
  static constexpr int kSteps = CK * KMAX;
  static constexpr int kWide = 0;
  static constexpr int kCk = kWide + 2 * Wide::bytes;
  static constexpr int kPart = kCk + 2 * THREADS * 32;
  static constexpr int kPartBytes = 2 * CK * THREADS * 4 + CK * WARPS * KMAX * 4;
  static constexpr int kSweepBuf = up16(SW * KMAX * (2 * (int)sizeof(E) + 4));
  static_assert(2 * kSweepBuf <= kPartBytes, "the sweep's buffers fit in the partial sums'");
  static constexpr int kU = kPart + kPartBytes;
  static constexpr int kRw = kU + KMAX * 4;
  static constexpr int kRaw = up16(kSteps * (int)sizeof(E));
  static constexpr int kRr = kRw + kSteps * 4;
  static constexpr int bytes = kRr + 4 * kRaw;
  char* base;
  float4* ck;
  float* prd;
  float* prw;
  float* dvp;
  float* su;
  float* rw;
  E* rr;
  E* rk;
  E* rv;
  E* rdo;
  __device__ explicit Smem(char* p)
      : base(p),
        ck(reinterpret_cast<float4*>(p + kCk)),
        prd(reinterpret_cast<float*>(p + kPart)),
        prw(prd + CK * THREADS),
        dvp(prw + CK * THREADS),
        su(reinterpret_cast<float*>(p + kU)),
        rw(reinterpret_cast<float*>(p + kRw)),
        rr(reinterpret_cast<E*>(p + kRr)),
        rk(reinterpret_cast<E*>(p + kRr + kRaw)),
        rv(reinterpret_cast<E*>(p + kRr + 2 * kRaw)),
        rdo(reinterpret_cast<E*>(p + kRr + 3 * kRaw)) {}
  __device__ Wide wide(int c) const { return Wide(base + kWide + (c & 1) * Wide::bytes); }
  // sweep buffer j & 1: k (SW x KMAX of E), w (float), v (E)
  __device__ E* sk(int j) const { return reinterpret_cast<E*>(base + kPart + (j & 1) * kSweepBuf); }
  __device__ float* sw(int j) const {
    return reinterpret_cast<float*>(base + kPart + (j & 1) * kSweepBuf + SW * KMAX * sizeof(E));
  }
  __device__ E* sv(int j) const {
    return reinterpret_cast<E*>(base + kPart + (j & 1) * kSweepBuf + SW * KMAX * (sizeof(E) + 4));
  }
};

// Element (b, t, h, x) of a (B, T, H, D) array is at (row0 + t * H) * D + x,
// row0 = b * T * H + h.
struct Rows {
  size_t row0;
  int H, K, V;
  __device__ size_t at(int t, int dim) const { return (row0 + (size_t)t * H) * dim; }
};

// Copy n steps from step t0 of k, w, v (and with `full` r and do) to the
// step-major buffers at dk_, dw_, ... (KMAX elements a step): cp.async 16
// bytes a copy (ALIGNED: K = V = 64; the caller commits and waits), else
// plain loads, with `pad` writing 0 (w: 1) at rows and columns past K, V.
// True if a w this thread copied is 0 (its own copies are visible to it
// once it has waited).
template <typename E, bool ALIGNED>
__device__ __forceinline__ void stage(const E* r, const E* k, const E* v, const float* w,
                                      const E* dout, E* rr, E* rk, float* rw, E* rv, E* rdo,
                                      const Rows& rows, int t0, int n, bool full, bool pad) {
  const int tid = threadIdx.x;
  if constexpr (ALIGNED) {
    constexpr int EP = 16 / sizeof(E);              // elements of E a copy
    constexpr int P = KMAX / EP;
    for (int x = tid; x < n * P; x += THREADS) {
      const int tt = x / P, q = x % P * EP;
      const size_t g = rows.at(t0 + tt, KMAX) + q;
      cp_async16(rk + tt * KMAX + q, k + g);
      cp_async16(rv + tt * KMAX + q, v + g);
      if (full) {
        cp_async16(rr + tt * KMAX + q, r + g);
        cp_async16(rdo + tt * KMAX + q, dout + g);
      }
    }
    for (int x = tid; x < n * (KMAX / 4); x += THREADS) {
      const int tt = x / (KMAX / 4), q = x % (KMAX / 4) * 4;
      cp_async16(rw + tt * KMAX + q, w + rows.at(t0 + tt, KMAX) + q);
    }
  } else {
    const int K = rows.K, V = rows.V;
    for (int x = tid; x < n * KMAX; x += THREADS) {
      const int tt = x / KMAX, q = x % KMAX;
      if (q < K) {
        const size_t g = rows.at(t0 + tt, K) + q;
        rk[x] = k[g];
        rw[x] = w[g];
        if (full) rr[x] = r[g];
      } else if (pad) {
        rk[x] = E(0.0f);
        rw[x] = 1.0f;
      }
      if (q < V) {
        const size_t g = rows.at(t0 + tt, V) + q;
        rv[x] = v[g];
        if (full) rdo[x] = dout[g];
      } else if (pad) {
        rv[x] = E(0.0f);
      }
    }
  }
}

// Whether a w that this thread staged by stage() is 0.
template <bool ALIGNED>
__device__ __forceinline__ bool staged_zero(const float* rw, int K, int n) {
  bool zero = false;
  if constexpr (ALIGNED) {
    for (int x = threadIdx.x; x < n * (KMAX / 4); x += THREADS) {
      const float4 q = *reinterpret_cast<const float4*>(rw + x * 4);
      zero |= q.x == 0.0f || q.y == 0.0f || q.z == 0.0f || q.w == 0.0f;
    }
  } else {
    for (int x = threadIdx.x; x < n * KMAX; x += THREADS)
      zero |= x % KMAX < K && rw[x] == 0.0f;
  }
  return zero;
}

// Widen and pad n staged steps into `wd`. True if this thread met a w_i ==
// 0 of a real row.
template <typename E>
__device__ __forceinline__ bool widen_chunk(const Smem<E>& sm, const Wide& wd, int K, int V,
                                            int n) {
  bool zero = false;
  for (int x = threadIdx.x; x < n * KMAX; x += THREADS) {
    const int q = x % KMAX;
    const bool row = q < K, col = q < V;
    const float wv = row ? sm.rw[x] : 1.0f;
    zero |= wv == 0.0f;
    wd.pk[x] = make_float4(row ? widen(sm.rr[x]) : 0.0f, row ? widen(sm.rk[x]) : 0.0f, wv, 0.0f);
    wd.pv[x] = col ? widen(sm.rv[x]) : 0.0f;
    wd.pdo[x] = col ? widen(sm.rdo[x]) : 0.0f;
  }
  return zero;
}

// v . do and sum_i (u_i r_i) k_i of a widened chunk's n steps into `wd`, a
// warp a sum: lane l takes elements l and l + 32 (fmaf(a_y, b_y, a_x b_x)),
// then masks 16 .. 1. FULL: n == CK.
template <bool FULL>
__device__ __forceinline__ void chunk_sums(const Wide& wd, const float* su, int n) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  auto sum = [&](int s) {
    const int tt = s < CK ? s : s - CK;
    const int x = tt * KMAX + lane, y = x + 32;
    const bool vd = s < CK;
    const float4 e0 = wd.pk[x], e1 = wd.pk[y];
    const float ax = vd ? wd.pv[x] : __fmul_rn(su[lane], e0.x), bx = vd ? wd.pdo[x] : e0.y;
    const float ay = vd ? wd.pv[y] : __fmul_rn(su[lane + 32], e1.x), by = vd ? wd.pdo[y] : e1.y;
    float a = __fmaf_rn(ay, by, __fmul_rn(ax, bx));
#pragma unroll
    for (int m = 16; m >= 1; m /= 2) a = __fadd_rn(a, __shfl_xor_sync(ALL, a, m));
    if (lane == 0) (vd ? wd.vdo : wd.ruk)[tt] = a;
  };
  if constexpr (FULL && 2 * CK == WARPS) {
    sum(warp);
  } else {
    for (int s = warp; s < 2 * CK; s += WARPS)
      if ((s < CK ? s : s - CK) < n) sum(s);
  }
}

// This thread's tile: rows i0, i0 + 1 and columns j0 .. j0 + 3.
struct Tile {
  int warp, cg, rsub, i0, j0;
  __device__ Tile() {
    warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    cg = lane % 16;
    rsub = lane / 16;
    i0 = 2 * (2 * warp + rsub);
    j0 = 4 * cg;
  }
};

// One step of the forward update on a tile: S = (w_i == 0) ? kv : fmaf(w_i,
// S, kv), kv = k_i v_j rounded; the forward kernel's update, bit for bit.
template <bool RESET>
__device__ __forceinline__ void update(const float (&kk)[2], const float (&ww)[2],
                                       const float (&vv)[4], const float (&s)[2][4],
                                       float (&out)[2][4]) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float kv = __fmul_rn(kk[a], vv[c]);
      const float d = __fmaf_rn(ww[a], s[a][c], kv);
      out[a][c] = RESET && ww[a] == 0.0f ? kv : d;
    }
}

// The sweep over CK steps of a staged block, from step `first` of it.
template <typename E, bool RESET>
__device__ __forceinline__ void sweep(const E* sk, const float* sw, const E* sv, const Tile& tl,
                                      int first, float (&s)[2][4]) {
#pragma unroll
  for (int tt = 0; tt < CK; ++tt) {
    const int at = (first + tt) * KMAX;
    float kk[2], ww[2], vv[4];
    load2(sk + at + tl.i0, kk);
    load2(sw + at + tl.i0, ww);
    load4(sv + at + tl.j0, vv);
    update<RESET>(kk, ww, vv, s, s);
  }
}

// The chunk's states st[0 .. n-1] from st[0], and each step's dr partial:
// sum_j S_ij do_j over a thread's 4 columns as a chain, then mask 8 halving
// (the lanes of cg < 8 keep row i0, the others row i0 + 1). FULL: n == CK,
// no guard; else every update selects (exact wherever no w_i is 0).
template <bool FULL, bool RESET>
__device__ __forceinline__ void recompute(const Wide& wd, float* prd, const Tile& tl,
                                          float (&st)[CK][2][4], int n) {
  const bool b8 = tl.cg & 8;
#pragma unroll
  for (int tt = 0; tt < CK; ++tt) {
    if (FULL || tt < n) {
      const float4 e0 = wd.pk[tt * KMAX + tl.i0], e1 = wd.pk[tt * KMAX + tl.i0 + 1];
      float vv[4], dd[4], p[2];
      load4(wd.pv + tt * KMAX + tl.j0, vv);
      load4(wd.pdo + tt * KMAX + tl.j0, dd);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        p[a] = __fmul_rn(st[tt][a][0], dd[0]);
#pragma unroll
        for (int c = 1; c < 4; ++c) p[a] = __fmaf_rn(st[tt][a][c], dd[c], p[a]);
      }
      if (tt + 1 < CK) {
        const float kk[2] = {e0.y, e1.y}, ww[2] = {e0.z, e1.z};
        update<RESET || !FULL>(kk, ww, vv, st[tt], st[tt + 1 < CK ? tt + 1 : tt]);
      }
      prd[tt * THREADS + threadIdx.x] =
          __fadd_rn(b8 ? p[1] : p[0], __shfl_xor_sync(ALL, b8 ? p[0] : p[1], 8));
    }
  }
}

// The chunk backwards from G = dS of its last step: dk and dw partials (a
// thread's chains, then masks 8 and 4 halving: lanes cg & 8 keep dw, cg & 4
// row i0 + 1), dv's warp sums (a thread's 2-row chain, then mask 16), and
// G = fmaf(w_i, Gs, r_i do_j).
template <bool FULL, bool RESET>
__device__ __forceinline__ void walk_back(const Wide& wd, float* prw, float* dvp, const Tile& tl,
                                          const float (&st)[CK][2][4], float (&G)[2][4], int n) {
  constexpr bool SEL = RESET || !FULL;
  const bool b8 = tl.cg & 8, b4 = tl.cg & 4, hi = tl.rsub;
#pragma unroll
  for (int tt = CK - 1; tt >= 0; --tt) {
    if (FULL || tt < n) {
      const float4 e[2] = {wd.pk[tt * KMAX + tl.i0], wd.pk[tt * KMAX + tl.i0 + 1]};
      float vv[4], dd[4], pk[2], pw[2], pv[4];
      load4(wd.pv + tt * KMAX + tl.j0, vv);
      load4(wd.pdo + tt * KMAX + tl.j0, dd);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float g = G[a][c];
          const float gs = SEL && e[a].z == 0.0f ? 0.0f : g;
          pk[a] = c ? __fmaf_rn(g, vv[c], pk[a]) : __fmul_rn(g, vv[c]);
          pw[a] = c ? __fmaf_rn(gs, st[tt][a][c], pw[a]) : __fmul_rn(gs, st[tt][a][c]);
          pv[c] = a ? __fmaf_rn(g, e[a].y, pv[c]) : __fmul_rn(g, e[a].y);
          G[a][c] = __fmaf_rn(e[a].z, gs, __fmul_rn(e[a].x, dd[c]));
        }
      const float y0 = __fadd_rn(b8 ? pw[0] : pk[0], __shfl_xor_sync(ALL, b8 ? pk[0] : pw[0], 8));
      const float y1 = __fadd_rn(b8 ? pw[1] : pk[1], __shfl_xor_sync(ALL, b8 ? pk[1] : pw[1], 8));
      prw[tt * THREADS + threadIdx.x] =
          __fadd_rn(b4 ? y1 : y0, __shfl_xor_sync(ALL, b4 ? y0 : y1, 4));
      const float c0 = __fadd_rn(hi ? pv[2] : pv[0], __shfl_xor_sync(ALL, hi ? pv[0] : pv[2], 16));
      const float c1 = __fadd_rn(hi ? pv[3] : pv[1], __shfl_xor_sync(ALL, hi ? pv[1] : pv[3], 16));
      *reinterpret_cast<float2*>(dvp + (tt * WARPS + tl.warp) * KMAX + tl.j0 + 2 * tl.rsub) =
          make_float2(c0, c1);
    }
  }
}

// Fold and write a chunk's gradients. Row i's partials of a step sit at
// lanes of row group i / 2: dr after mask 8 at cg = 8 (i % 2) + m, m < 8,
// then masks 4, 2, 1: ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7));
// dk (dw) after masks 8 and 4 at cg = 4 (i % 2) + m (+ 8), m < 4:
// (p0 + p2) + (p1 + p3). dr_i = fmaf(u_i k_i, v . do, sum), dk_i =
// fmaf(u_i r_i, v . do, sum); dv_j = fmaf(sum u r k, do_j, the 16 warps'
// sums added in warp order). du: thread i (a row) adds the chunk's steps,
// t descending.
template <typename E>
__device__ __forceinline__ void write_chunk(const Smem<E>& sm, const Wide& wd, const Rows& rows,
                                            E* dr, E* dk, E* dv, float* dw, int t0, int n,
                                            float& du_acc) {
  const int K = rows.K, V = rows.V;
  for (int x = threadIdx.x; x < n * KMAX; x += THREADS) {
    const int tt = x / KMAX, q = x % KMAX;
    if (q < V) {
      const float* p = sm.dvp + tt * WARPS * KMAX + q;
      float s = p[0];
#pragma unroll
      for (int wp = 1; wp < WARPS; ++wp) s = __fadd_rn(s, p[wp * KMAX]);
      store(dv + rows.at(t0 + tt, V) + q, __fmaf_rn(wd.ruk[tt], wd.pdo[x], s));
    }
    if (q < K) {
      const int lane0 = tt * THREADS + (q / 2) * 16;   // the row group's first lane
      const float4 e = wd.pk[x];
      const float vdo = wd.vdo[tt], ui = sm.su[q];
      const float4 a = *reinterpret_cast<const float4*>(sm.prd + lane0 + (q % 2) * 8);
      const float4 b = *reinterpret_cast<const float4*>(sm.prd + lane0 + (q % 2) * 8 + 4);
      const float sr = __fadd_rn(__fadd_rn(__fadd_rn(a.x, b.x), __fadd_rn(a.z, b.z)),
                                 __fadd_rn(__fadd_rn(a.y, b.y), __fadd_rn(a.w, b.w)));
      const float4 pk = *reinterpret_cast<const float4*>(sm.prw + lane0 + (q % 2) * 4);
      const float4 pw = *reinterpret_cast<const float4*>(sm.prw + lane0 + 8 + (q % 2) * 4);
      const float sk = __fadd_rn(__fadd_rn(pk.x, pk.z), __fadd_rn(pk.y, pk.w));
      const size_t g = rows.at(t0 + tt, K) + q;
      store(dr + g, __fmaf_rn(__fmul_rn(ui, e.y), vdo, sr));
      store(dk + g, __fmaf_rn(__fmul_rn(ui, e.x), vdo, sk));
      dw[g] = __fadd_rn(__fadd_rn(pw.x, pw.z), __fadd_rn(pw.y, pw.w));
    }
  }
  if ((int)threadIdx.x < K) {
    for (int tt = n - 1; tt >= 0; --tt) {
      const float4 e = wd.pk[tt * KMAX + threadIdx.x];
      du_acc = __fmaf_rn(__fmul_rn(e.x, e.y), wd.vdo[tt], du_acc);
    }
  }
}

// A tile of a (K, V) state at p (0 outside it).
__device__ __forceinline__ void load_tile(const float* p, const Tile& tl, int K, int V,
                                          float (&x)[2][4]) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = tl.i0 + a, j = tl.j0 + c;
      x[a][c] = i < K && j < V ? p[(size_t)i * V + j] : 0.0f;
    }
}

template <bool FULL, bool RESET>
__device__ __forceinline__ void chunk(const Wide& wd, const float* su, float* prd, float* prw,
                                      float* dvp, const Tile& tl, float (&st)[CK][2][4],
                                      float (&G)[2][4], int n) {
  chunk_sums<FULL>(wd, su, n);
  recompute<FULL, RESET>(wd, prd, tl, st, n);
  walk_back<FULL, RESET>(wd, prw, dvp, tl, st, G, n);
}

template <typename E, bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 1)
wkv6_bwd_kernel(const E* __restrict__ r, const E* __restrict__ k, const E* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ s0, const E* __restrict__ dout,
                const float* __restrict__ dsT, E* __restrict__ dr, E* __restrict__ dk,
                E* __restrict__ dv, float* __restrict__ dw, float* __restrict__ du_part,
                float* __restrict__ ds0, float* __restrict__ ckpt, int T, int H, int K, int V) {
  extern __shared__ float4 smem_base[];
  const Smem<E> sm(reinterpret_cast<char*>(smem_base));
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const Rows rows{(size_t)b * T * H + h, H, K, V};
  const Tile tl;
  const int tid = threadIdx.x;
  const int nc = (T + CK - 1) / CK;      // chunks; chunk c holds steps [c CK, c CK + CK)
  const int nck = nc > 2 ? nc - 2 : 0;   // checkpoints: the starts of chunks 1 .. nc - 2
  float4* ckp = reinterpret_cast<float4*>(ckpt) + ((size_t)bh * nck * THREADS + tid) * 2;
  const size_t sbase = (size_t)bh * K * V;

  if (tid < KMAX) sm.su[tid] = tid < K ? u[(size_t)h * K + tid] : 0.0f;
  float st[CK][2][4], G[2][4];
  load_tile(s0 + sbase, tl, K, V, st[0]);
  load_tile(dsT + sbase, tl, K, V, G);
  float du_acc = 0.0f;
  auto stage_chunk = [&](int c) {        // chunk c's r, k, w, v, do, and its checkpoint
    stage<E, ALIGNED>(r, k, v, w, dout, sm.rr, sm.rk, sm.rw, sm.rv, sm.rdo, rows, c * CK,
                      min(CK, T - c * CK), true, false);
    if (c >= 1 && c <= nc - 2) {
      float4* buf = sm.ck + ((c & 1) * THREADS + tid) * 2;
      const float4* src = ckp + (size_t)(c - 1) * THREADS * 2;
      cp_async16(buf, src);
      cp_async16(buf + 1, src + 1);
    }
    cp_async_commit();
  };

  // The sweep: steps 0 .. nsw - 1 (chunks 0 .. nc - 2), SW at a time.
  const int nsw = nc > 1 ? (nc - 1) * CK : 0;
  const int nblk = (nsw + SW - 1) / SW;
  if (nblk > 0) {
    stage<E, ALIGNED>(r, k, v, w, dout, nullptr, sm.sk(0), sm.sw(0), sm.sv(0), nullptr, rows, 0,
                      min(SW, nsw), false, true);
    cp_async_commit();
  } else if (nc > 0) {
    stage_chunk(0);
  }
  for (int j = 0; j < nblk; ++j) {
    const int first = j * SW, n = min(SW, nsw - first);
    cp_async_wait_all();
    const bool resets = __syncthreads_or(staged_zero<ALIGNED>(sm.sw(j), K, n));
    if (j + 1 < nblk) {
      stage<E, ALIGNED>(r, k, v, w, dout, nullptr, sm.sk(j + 1), sm.sw(j + 1), sm.sv(j + 1),
                        nullptr, rows, first + SW, min(SW, nsw - first - SW), false, true);
      cp_async_commit();
    } else {
      stage_chunk(nc - 1);
    }
    for (int off = 0; off < n; off += CK) {
      if (resets) sweep<E, true>(sm.sk(j), sm.sw(j), sm.sv(j), tl, off, st[0]);
      else sweep<E, false>(sm.sk(j), sm.sw(j), sm.sv(j), tl, off, st[0]);
      const int c = (first + off) / CK;
      if (c <= nc - 3) {                 // the start of chunk c + 1
        float4* dst = ckp + (size_t)c * THREADS * 2;
        dst[0] = make_float4(st[0][0][0], st[0][0][1], st[0][0][2], st[0][0][3]);
        dst[1] = make_float4(st[0][1][0], st[0][1][1], st[0][1][2], st[0][1][3]);
      }
    }
  }

  // Backwards, chunk by chunk: stage c - 1 while c computes; then c's
  // gradients are written while c - 1 is widened, between two barriers.
  bool resets = false;
  if (nc > 0) {
    cp_async_wait_all();
    __syncthreads();                     // chunk nc - 1 staged; the sweep's buffers free
    resets = __syncthreads_or(widen_chunk(sm, sm.wide(nc - 1), K, V, min(CK, T - (nc - 1) * CK)));
  }
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * CK, n = min(CK, T - t0);
    if (c >= 1) stage_chunk(c - 1);
    if (c == 0 && nc > 1) {
      load_tile(s0 + sbase, tl, K, V, st[0]);
    } else if (c >= 1 && c <= nc - 2) {
      const float4* buf = sm.ck + ((c & 1) * THREADS + tid) * 2;
      const float4 x0 = buf[0], x1 = buf[1];
      st[0][0][0] = x0.x; st[0][0][1] = x0.y; st[0][0][2] = x0.z; st[0][0][3] = x0.w;
      st[0][1][0] = x1.x; st[0][1][1] = x1.y; st[0][1][2] = x1.z; st[0][1][3] = x1.w;
    }                                    // else (c == nc - 1) st[0] is the sweep's end, or s0
    const Wide wd = sm.wide(c);
    if (n < CK) chunk<false, true>(wd, sm.su, sm.prd, sm.prw, sm.dvp, tl, st, G, n);
    else if (resets) chunk<true, true>(wd, sm.su, sm.prd, sm.prw, sm.dvp, tl, st, G, n);
    else chunk<true, false>(wd, sm.su, sm.prd, sm.prw, sm.dvp, tl, st, G, n);
    cp_async_wait_all();
    __syncthreads();                     // c's partial sums written; c - 1 staged
    write_chunk(sm, wd, rows, dr, dk, dv, dw, t0, n, du_acc);
    const bool zero = c >= 1 && widen_chunk(sm, sm.wide(c - 1), K, V, CK);
    resets = __syncthreads_or(zero);     // c written, c - 1 widened
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = tl.i0 + a, j = tl.j0 + c;
      if (i < K && j < V) ds0[sbase + (size_t)i * V + j] = G[a][c];
    }
  if (tid < K) du_part[(size_t)bh * K + tid] = du_acc;
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
// per device id in `done`).
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

template <typename E, bool ALIGNED>
int launch_path(const E* r, const E* k, const E* v, const float* w, const float* u,
                const float* s0, const E* dout, const float* dsT, E* dr, E* dk, E* dv,
                float* dw, float* du_part, float* ds0, float* ckpt, int B, int T, int H,
                int K, int V, cudaStream_t stream) {
  auto kernel = wkv6_bwd_kernel<E, ALIGNED>;
  static std::atomic<unsigned long long> done{0};
  const cudaError_t err = smem_opt_in(kernel, Smem<E>::bytes, done);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(B * H), THREADS, Smem<E>::bytes, stream>>>(
      r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du_part, ds0, ckpt, T, H, K, V);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename E>
int launch(const E* r, const E* k, const E* v, const float* w, const float* u,
           const float* s0, const E* dout, const float* dsT, E* dr, E* dk, E* dv, float* dw,
           float* du, float* ds0, float* du_part, float* ckpt, int B, int T, int H, int K,
           int V, void* stream) {
  if (K < 1 || K > KMAX || V < 1 || V > KMAX || T < 0 || B < 0 || H < 0)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (B > 0 && H > 0) {
    // cp.async copies 16 aligned bytes: the copying path takes K = V = 64
    // (every staged row a multiple of 16 bytes) and 16-byte aligned bases
    const bool aligned = K == KMAX && V == KMAX && aligned16(r) && aligned16(k) &&
                         aligned16(v) && aligned16(w) && aligned16(dout);
    const int err =
        aligned ? launch_path<E, true>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du_part,
                                       ds0, ckpt, B, T, H, K, V, st)
                : launch_path<E, false>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du_part,
                                        ds0, ckpt, B, T, H, K, V, st);
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
// float32. Scratch (float32): du_part B H K; ckpt B H max(nc - 2, 0) 4096,
// nc = ceil(T / CK), 16-byte aligned. All contiguous; 1 <= K,
// V <= 64; T >= 0. Launches on `stream` (the gradient kernel, then the sum
// of du over b), allocates nothing, returns cudaGetLastError().
extern "C" int wkv6_bwd_f32(const float* r, const float* k, const float* v, const float* w,
                            const float* u, const float* s0, const float* dout,
                            const float* dsT, float* dr, float* dk, float* dv, float* dw,
                            float* du, float* ds0, float* du_part, float* ckpt, int B, int T,
                            int H, int K, int V, void* stream) {
  return launch(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0, du_part, ckpt, B, T, H,
                K, V, stream);
}

extern "C" int wkv6_bwd_bf16(const __nv_bfloat16* r, const __nv_bfloat16* k,
                             const __nv_bfloat16* v, const float* w, const float* u,
                             const float* s0, const __nv_bfloat16* dout, const float* dsT,
                             __nv_bfloat16* dr, __nv_bfloat16* dk, __nv_bfloat16* dv,
                             float* dw, float* du, float* ds0, float* du_part, float* ckpt,
                             int B, int T, int H, int K, int V, void* stream) {
  return launch(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0, du_part, ckpt, B, T, H,
                K, V, stream);
}
