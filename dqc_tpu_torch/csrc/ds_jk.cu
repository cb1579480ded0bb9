// Fused J+K contraction of a dense 4-index float64 tensor with a density
// matrix, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel dqc_tpu/ops/pallas_jk.py::ds_jk. In one read of
// T (n,n,n,n) it forms
//
//   out_trail[i,a] = sum_{b,l} T[i,a,b,l] * dm[b,l]
//   out_mid[i,b]   = sum_{a,l} T[i,a,b,l] * dm[a,l]
//
// With T = eri_k (eri_k[i,j,k,l] = (ik|jl)) these are K and J.
//
// Bound: bytes. T is read once (n^4 * 8 B; 1,351,168,128 B at n = 114) for
// 4 n^4 float64 operations, about half an operation per byte, far below
// what the card can do per byte it moves. At the 3.35 TB/s of the H100 SXM
// data sheet the least time at n = 114 is about 0.40 ms.
//
// Design. The TPU kernel splits f64 into hi/lo f32 planes and does
// double-single arithmetic because that chip has no f64 units, pads to its
// (8,128) tiles and carries an accumulator along a sequential grid axis.
// None of that is kept: the f64 tensor is the input, arithmetic is f64 FMA,
// nothing is padded in memory and no block depends on another.
//   * grid (chunks of a, i). A block walks the contiguous (b,l) tiles
//     T[i,a,:,:] of its chunk of a. One warp takes a row b at a time, its
//     lanes stride over l, so a warp reads consecutive doubles. T is loaded
//     with the streaming hint (it is used once); dm stays in L1/L2.
//   * per element one FMA into the thread's tile sum (trailing contraction)
//     and one into the row sum (middle contraction). The row sum is reduced
//     inside the warp and added to mid_acc[b] in shared memory: a row b is
//     always handled by the same warp, so this needs no atomics. The tile
//     sum is reduced over the block in a fixed order and out_trail[i,a] is
//     written by exactly one block.
//   * the middle contraction also sums over a, which spans blocks: every
//     block writes its partial row to mid_part[i, chunk, :], and a second
//     small kernel adds the chunks in index order.
// No floating-point atomics anywhere, and every reduction has a fixed
// order, so the result is bit-identical from run to run.
// Ragged n (114 is not a multiple of 32) is handled by the loop bounds.
//
// Plain C interface for ctypes: the caller allocates everything, passes
// device pointers and the stream; nothing synchronises here.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
ds_jk_pass(const double* __restrict__ T, const double* __restrict__ dm,
           double* __restrict__ out_trail, double* __restrict__ mid_part,
           int n, int a_chunk, int n_chunks) {
  extern __shared__ double smem[];
  double* mid_acc = smem;          // n accumulators of the middle contraction
  double* warp_part = smem + n;    // kWarps partial tile sums

  const int i = blockIdx.y;
  const int chunk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int b = tid; b < n; b += kThreads) mid_acc[b] = 0.0;
  __syncthreads();

  const size_t n2 = (size_t)n * (size_t)n;
  const int a0 = chunk * a_chunk;
  const int a1 = min(a0 + a_chunk, n);
  for (int a = a0; a < a1; ++a) {
    const double* tile = T + ((size_t)i * n + a) * n2;
    const double* dm_a = dm + (size_t)a * n;
    double trail = 0.0;
    for (int b = warp; b < n; b += kWarps) {
      const double* row = tile + (size_t)b * n;
      const double* dm_b = dm + (size_t)b * n;
      double mid = 0.0;
#pragma unroll 4
      for (int l = lane; l < n; l += 32) {
        const double t = __ldcs(row + l);
        trail = fma(t, __ldg(dm_b + l), trail);
        mid = fma(t, __ldg(dm_a + l), mid);
      }
      mid = warp_sum(mid);
      if (lane == 0) mid_acc[b] += mid;   // row b belongs to this warp only
    }
    trail = warp_sum(trail);
    if (lane == 0) warp_part[warp] = trail;
    __syncthreads();
    if (tid == 0) {
      double s = 0.0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += warp_part[w];
      out_trail[(size_t)i * n + a] = s;
    }
    __syncthreads();
  }

  double* part = mid_part + ((size_t)i * n_chunks + chunk) * n;
  for (int b = tid; b < n; b += kThreads) part[b] = mid_acc[b];
}

__global__ void __launch_bounds__(kThreads)
ds_jk_fold(const double* __restrict__ mid_part, double* __restrict__ out_mid,
           int n, int n_chunks) {
  const int i = blockIdx.x;
  const double* part = mid_part + (size_t)i * n_chunks * n;
  for (int b = threadIdx.x; b < n; b += kThreads) {
    double s = 0.0;
    for (int c = 0; c < n_chunks; ++c) s += part[(size_t)c * n + b];
    out_mid[(size_t)i * n + b] = s;
  }
}

}  // namespace

// Returns 0 or the cudaError_t of the launch that was refused.
// T (n,n,n,n), dm (n,n), out_trail (n,n), out_mid (n,n),
// mid_part (n, n_chunks, n) scratch; all contiguous float64 on the device of
// `stream`; n_chunks * a_chunk >= n.
extern "C" int ds_jk_launch(const void* T, const void* dm, void* out_trail,
                            void* out_mid, void* mid_part, int n, int a_chunk,
                            int n_chunks, void* stream) {
  if (n <= 0 || a_chunk <= 0 || n_chunks <= 0 ||
      (long long)a_chunk * n_chunks < n)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(n + kWarps) * sizeof(double);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)n_chunks, (unsigned)n);
  ds_jk_pass<<<grid, kThreads, smem, s>>>(
      (const double*)T, (const double*)dm, (double*)out_trail,
      (double*)mid_part, n, a_chunk, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ds_jk_fold<<<(unsigned)n, kThreads, 0, s>>>(
      (const double*)mid_part, (double*)out_mid, n, n_chunks);
  return (int)cudaGetLastError();
}
