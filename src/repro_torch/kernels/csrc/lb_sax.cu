// LB_SAX (MINDIST) over packed iSAX codes, for Hopper (sm_90a): v2.
//
// Replaces: src/repro/kernels/lb_sax.py::lb_sax_matrix (_lb_sax_kernel).
//
// out[q, j] = seg_len * sum_i d_i^2, d_i = max(lo[c_ji] - p_qi, p_qi - hi[c_ji], 0),
// where c_ji is series j's code of segment i, [lo, hi] its cell and p_qi the
// query's PAA. Each term is rounded as the plain version rounds it
// (repro_torch.core.lower_bounds.lb_sax): two subtractions, the max with 0,
// one multiply; the m terms fold by pairwise halving (summaries.
// fixed_order_sum), then one multiply by seg_len, with no fused
// multiply-add and no reordering, so kernel and plain version agree bit for
// bit. The tiling below decides only which thread computes which output.
//
// Bound on this card (3.35 TB/s; 67 TFLOP/s float32, an FMA counted as two
// operations): per series m bytes of codes in and 4*Q bytes out, per output
// 6m + 1 operations. At the main path's Q=1 x 4,198,400 x 16 (exact_knn
// phase 3, once a query) that is bytes, 84 MB in 0.0251 ms. At ooc-local's
// Q=128 x 131,072 x 16 (the LSD filter of a streamed block) it is
// operations, 1.63 G in 0.0243 ms; none of them is an FMA, so the issue
// slots (one warp instruction a clock on each of 528 schedulers) set a
// ceiling near 0.045 ms there.
//
// v1 (one thread per series, a block per 256 series and 8 queries) ran at
// 30% of the bound at Q=1 and 16% at Q=128 (device time 0.0829 / 0.1470
// ms, tools/kernel_ab.py, H100 80GB HBM3 at 700 W). v2 takes 0.0348 /
// 0.0564 ms there (72% / 43%). What held v1 back, and what v2 does:
// 1. The fold: nvcc unrolls a halving loop (w /= 2) only partly and then
//    indexes v[] at run time through predicated moves, ~280 issue cycles
//    an output. v2 folds one template instantiation a level (halve), fully
//    unrolled; this alone took v1 to 0.0789 / 0.0817 ms.
// 2. Gathers with bank conflicts: two 4-byte lookups a segment, indexed by
//    data into 256-word tables (a warp's 32 random codes collide 3-4 ways).
//    v2 packs {lo, hi} into one float2 and keeps one copy of the table per
//    lane, interleaved (entry [code][lane], 64 KB of dynamic shared
//    memory), so a warp's 32 lookups take two wavefronts, the least for
//    256 bytes; the byte offset code * 256 + lane * 8 is one byte permute.
//    (16 copies, lane l reading copy l mod 16, measured 1-3% faster: not
//    kept.)
// 3. A block prologue for one series a thread: 16,400 blocks at Q=1, each
//    copying the tables. v2 launches persistent blocks, as many as fit on
//    the card (read once per device), that stage the table once and walk
//    the series grid-stride, U=2 series a thread, the next U rows' codes in
//    flight while the current ones are computed. A single query has its own
//    instantiation (56 registers, 3 blocks an SM: 8% faster at Q=1).
// 4. Queries tiled by 8 over blockIdx.y, so each series' bounds were
//    gathered Q/8 times. v2 gathers a series' bounds once into registers
//    and loops over every query of the call (staged QT at a time in shared
//    memory, read as broadcasts), computing both rows without a branch
//    (only the store is guarded, so the rows' chains interleave) and
//    storing each query's row coalesced.
// 5. Instructions: the max with 0 of two differences is one DPX
//    max-with-relu on the float bits (max_relu below; the same bits), 17%
//    faster at Q=128 than two FMNMX. Each output is then 80 float and
//    integer instructions; at Q=128 v2 issues about 0.76 a clock on each
//    scheduler, so the issue slots, not bytes, hold it at 43%.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int U = 2;              // series a thread holds at once
constexpr int QT = 128;           // queries staged in shared memory per pass
constexpr int ALPHABET = 256;
constexpr int LANES = 32;
constexpr int TABLE_BYTES = ALPHABET * LANES * (int)sizeof(float2);   // 64 KB

template <int M>
constexpr int smem_bytes() { return TABLE_BYTES + QT * M * (int)sizeof(float); }

// The M codes of series `row` as M/4 little-endian words (one 16- or
// 8-byte load; rows are M-byte aligned); zeros past the last series.
template <int M>
__device__ __forceinline__ void load_codes(const uint8_t* __restrict__ codes, long long row,
                                           long long num_s, uint32_t (&w)[M / 4]) {
  if (row >= num_s) {
#pragma unroll
    for (int k = 0; k < M / 4; ++k) w[k] = 0;
  } else if constexpr (M == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(codes) + row);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(codes) + row);
    w[0] = v.x; w[1] = v.y;
  }
}

// v[i] += v[i + H] for i < H, then the next halving: the plain version's
// pairwise fold. One instantiation a level, so each loop has a constant trip
// count and unrolls fully (nvcc unrolls a halving loop, w /= 2, only
// partly, and then indexes v[] at run time through predicated moves).
template <int H, int M>
__device__ __forceinline__ void halve(float (&v)[M]) {
#pragma unroll
  for (int i = 0; i < H; ++i) v[i] = __fadd_rn(v[i], v[i + H]);
  if constexpr (H > 1) halve<H / 2>(v);
}

// max(a, b, 0) for non-NaN a, b in one instruction: Hopper's DPX
// max-with-relu (VIMNMX.RELU) on the float bits as int32. A non-negative
// float orders as its bits do and a negative one has negative bits, so a
// positive max (+inf included) is picked as fmaxf picks it, and when both
// are <= 0 (-0.0 included) the result is +0.0, whose square is the same
// +0.0 as fmaxf(fmaxf(a, b), 0)'s. One instruction in place of two FMNMX.
__device__ __forceinline__ float max_relu(float a, float b) {
  return __int_as_float(__vimax_s32_relu(__float_as_int(a), __float_as_int(b)));
}

// seg_len * (pairwise-halved sum over i of d_i^2): the plain version's chain.
template <int M>
__device__ __forceinline__ float lb_sax_row(const float (&lo)[M], const float (&hi)[M],
                                            const float (&p)[M], float seg_len) {
  float v[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float d = max_relu(__fsub_rn(lo[i], p[i]), __fsub_rn(p[i], hi[i]));
    v[i] = __fmul_rn(d, d);
  }
  halve<M / 2>(v);
  return __fmul_rn(seg_len, v[0]);
}

// kOne: a single query (exact_knn's phase 3), fixed at compile time, so
// fewer registers stay live and 3 blocks fit an SM (more code loads in
// flight, where bytes bound the call); else 2 blocks of up to 128 registers.
template <int M, bool kOne>
__global__ void __launch_bounds__(THREADS, kOne ? 3 : 2)
lb_sax_v2(const float* __restrict__ q_paa, const uint8_t* __restrict__ codes,
          const float* __restrict__ lo_tab, const float* __restrict__ hi_tab,
          float* __restrict__ out, int num_q, int num_s, int alphabet, float seg_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* const s_tab = reinterpret_cast<float2*>(smem);           // [code][lane]
  float* const s_q = reinterpret_cast<float*>(smem + TABLE_BYTES);  // [QT][M]

  for (int e = threadIdx.x; e < alphabet * LANES; e += THREADS)
    s_tab[e] = make_float2(lo_tab[e / LANES], hi_tab[e / LANES]);
  const uint32_t lane8 = (threadIdx.x % LANES) * (uint32_t)sizeof(float2);
  const long long stride = (long long)gridDim.x * THREADS * U;

  for (int q0 = 0; q0 < num_q; q0 += QT) {
    const int qn = kOne ? 1 : min(QT, num_q - q0);
    __syncthreads();   // the table is staged; the previous pass is done with s_q
    for (int e = threadIdx.x; e < qn * M; e += THREADS) s_q[e] = q_paa[(long long)q0 * M + e];
    __syncthreads();

    // series j0 + u * THREADS, u < U: a warp's lanes take consecutive rows
    long long j0 = (long long)blockIdx.x * THREADS * U + threadIdx.x;
    uint32_t w[U][M / 4];
#pragma unroll
    for (int u = 0; u < U; ++u) load_codes<M>(codes, j0 + u * THREADS, num_s, w[u]);
    for (; j0 < num_s; j0 += stride) {
      uint32_t next[U][M / 4];
#pragma unroll
      for (int u = 0; u < U; ++u) load_codes<M>(codes, j0 + stride + u * THREADS, num_s, next[u]);
      // each series' cell bounds, gathered once for every query of the pass
      float lo[U][M], hi[U][M];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int i = 0; i < M; ++i) {
          // byte 0: lane * 8, byte 1: code i, bytes 2-3: 0
          const uint32_t off = __byte_perm(w[u][i / 4], lane8, 0x5504 | ((i % 4) << 4));
          const float2 e = *reinterpret_cast<const float2*>(smem + off);
          lo[u][i] = e.x;
          hi[u][i] = e.y;
        }
      }
      bool valid[U];
#pragma unroll
      for (int u = 0; u < U; ++u) valid[u] = j0 + u * THREADS < num_s;
      float* o = out + (long long)q0 * num_s + j0;
#pragma unroll 1   // unrolled by 2 it ran 2% slower at Q=128 (more registers)
      for (int qi = 0; qi < qn; ++qi) {
        float p[M];
#pragma unroll
        for (int k = 0; k < M / 4; ++k) {
          const float4 t = reinterpret_cast<const float4*>(s_q + qi * M)[k];
          p[4 * k] = t.x; p[4 * k + 1] = t.y; p[4 * k + 2] = t.z; p[4 * k + 3] = t.w;
        }
        // every row computed (a row past the end has zero codes), only the
        // store guarded: no branch splits the U rows, so their chains
        // interleave
        float r[U];
#pragma unroll
        for (int u = 0; u < U; ++u) r[u] = lb_sax_row<M>(lo[u], hi[u], p, seg_len);
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (valid[u]) o[u * THREADS] = r[u];
        o += num_s;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < M / 4; ++k) w[u][k] = next[u][k];
    }
  }
}

// Persistent grid size (SMs x resident blocks) and the > 48 KB shared
// memory opt-in, once per device (a bit and a slot per device id).
template <int M, bool kOne>
int launch(const float* q_paa, const uint8_t* codes, const float* lo_tab, const float* hi_tab,
           float* out, int num_q, int num_s, int alphabet, float seg_len, void* stream) {
  constexpr int bytes = smem_bytes<M>();
  auto kernel = lb_sax_v2<M, kOne>;
  static std::atomic<unsigned long long> ready{0};
  static std::atomic<int> slots[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(ready.load() & bit)) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, bytes);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    slots[dev & 63].store(sms * per_sm);
    ready.fetch_or(bit);
  }
  const long long needed = ((long long)num_s + THREADS * U - 1) / (THREADS * U);
  const int grid = (int)(needed < slots[dev & 63].load() ? needed : slots[dev & 63].load());
  kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      q_paa, codes, lo_tab, hi_tab, out, num_q, num_s, alphabet, seg_len);
  return (int)cudaGetLastError();
}

}  // namespace

// (Q, m) float32 query PAA x (N, m) uint8 codes -> (Q, N) float32 squared
// LB_SAX. m is 8 or 16; alphabet 2..256; codes m-byte aligned. Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int lb_sax_matrix_f32(const float* q_paa, const uint8_t* codes,
                                 const float* lo_tab, const float* hi_tab,
                                 float* out, int num_q, int num_s, int m,
                                 int alphabet, float seg_len, void* stream) {
  if (num_q <= 0 || num_s <= 0) return (int)cudaSuccess;
  if (alphabet < 2 || alphabet > ALPHABET) return (int)cudaErrorInvalidValue;
  const bool one = num_q == 1;
  if (m == 16)
    return (one ? launch<16, true> : launch<16, false>)(q_paa, codes, lo_tab, hi_tab, out,
                                                        num_q, num_s, alphabet, seg_len, stream);
  if (m == 8)
    return (one ? launch<8, true> : launch<8, false>)(q_paa, codes, lo_tab, hi_tab, out,
                                                      num_q, num_s, alphabet, seg_len, stream);
  return (int)cudaErrorInvalidValue;
}
