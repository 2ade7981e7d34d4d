// LB_SAX (MINDIST) over packed iSAX codes, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/lb_sax.py::lb_sax_matrix (_lb_sax_kernel).
//
// Bound on this card: memory. Each series brings 16 bytes of codes and
// takes 4*Q bytes of output against 16 segments of arithmetic per query, so
// at the main path's Q=1 (exact_knn phase 3, once per query) the kernel
// moves ~20 bytes per series and the floor is bytes / HBM bandwidth.
//
// Design: the TPU kernel expressed the code -> cell-bound lookup as a
// one-hot matmul because the TPU's vector unit has no cheap gather; on
// Hopper a gather from shared memory is cheap, so each block stages the two
// alphabet-sized bound tables (lo, hi) and its query rows in shared memory.
// One thread owns one series: a single 16-byte vector load brings its codes
// (rows are 16-byte aligned), the bounds are gathered from shared memory,
// and the per-query result is stored so that a warp writes 128 contiguous
// bytes. The Q axis is tiled over blockIdx.y in groups of QB queries, so
// Q=1 launches exactly one thread per series. The per-segment terms are
// rounded and folded pairwise in the same order as the plain version
// (repro_torch.core.lower_bounds.lb_sax), with no fused multiply-add, so
// kernel and plain version agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int QB = 8;            // queries per block (blockIdx.y tile)
constexpr int MAX_ALPHABET = 256;

template <int M>
struct Codes;

template <>
struct Codes<16> {
  __device__ __forceinline__ static void load(const uint8_t* codes, long long row,
                                              uint8_t (&c)[16]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(codes) + row);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) c[i] = (w[i / 4] >> (8 * (i % 4))) & 0xFF;
  }
};

template <>
struct Codes<8> {
  __device__ __forceinline__ static void load(const uint8_t* codes, long long row,
                                              uint8_t (&c)[8]) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(codes) + row);
    const uint32_t w[2] = {v.x, v.y};
#pragma unroll
    for (int i = 0; i < 8; ++i) c[i] = (w[i / 4] >> (8 * (i % 4))) & 0xFF;
  }
};

template <int M>
__global__ void __launch_bounds__(THREADS)
lb_sax_kernel(const float* __restrict__ q_paa, const uint8_t* __restrict__ codes,
              const float* __restrict__ lo_tab, const float* __restrict__ hi_tab,
              float* __restrict__ out, int num_q, int num_s, int alphabet,
              float seg_len) {
  __shared__ float s_lo[MAX_ALPHABET];
  __shared__ float s_hi[MAX_ALPHABET];
  __shared__ float s_q[QB * M];

  const int q0 = blockIdx.y * QB;
  const int qn = min(QB, num_q - q0);
  for (int i = threadIdx.x; i < alphabet; i += blockDim.x) {
    s_lo[i] = lo_tab[i];
    s_hi[i] = hi_tab[i];
  }
  for (int i = threadIdx.x; i < qn * M; i += blockDim.x)
    s_q[i] = q_paa[(size_t)q0 * M + i];
  __syncthreads();

  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= num_s) return;

  uint8_t c[M];
  Codes<M>::load(codes, j, c);
  float lo[M], hi[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    lo[i] = s_lo[c[i]];
    hi[i] = s_hi[c[i]];
  }

  for (int qi = 0; qi < qn; ++qi) {
    float v[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float p = s_q[qi * M + i];
      const float d = fmaxf(fmaxf(__fsub_rn(lo[i], p), __fsub_rn(p, hi[i])), 0.0f);
      v[i] = __fmul_rn(d, d);
    }
#pragma unroll
    for (int w = M; w > 1; w /= 2) {
#pragma unroll
      for (int i = 0; i < w / 2; ++i) v[i] = __fadd_rn(v[i], v[i + w / 2]);
    }
    out[(size_t)(q0 + qi) * num_s + j] = __fmul_rn(seg_len, v[0]);
  }
}

}  // namespace

// (Q, m) float32 query PAA x (N, m) uint8 codes -> (Q, N) float32 squared
// LB_SAX. m is 8 or 16; alphabet <= 256; codes 16-byte aligned (m=16) or
// 8-byte aligned (m=8). Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int lb_sax_matrix_f32(const float* q_paa, const uint8_t* codes,
                                 const float* lo_tab, const float* hi_tab,
                                 float* out, int num_q, int num_s, int m,
                                 int alphabet, float seg_len, void* stream) {
  if (num_q <= 0 || num_s <= 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((num_s + THREADS - 1) / THREADS),
                  (unsigned)((num_q + QB - 1) / QB));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m == 16) {
    lb_sax_kernel<16><<<grid, THREADS, 0, st>>>(q_paa, codes, lo_tab, hi_tab, out,
                                                 num_q, num_s, alphabet, seg_len);
  } else if (m == 8) {
    lb_sax_kernel<8><<<grid, THREADS, 0, st>>>(q_paa, codes, lo_tab, hi_tab, out,
                                                num_q, num_s, alphabet, seg_len);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
