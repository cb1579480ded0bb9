// Assembly of the raw GGA exchange-correlation matrix, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel dqc_tpu/ops/pallas_xc.py::ds_vxc_gga together
// with its prologue build_wt. From the AO tables phi (ng, nao), dphi
// (3, ng, nao) and the pointwise potentials vrho (ng), vgrad (3, ng), all
// float64 with the quadrature weights already folded into the potentials,
// it forms
//
//   WT[i,g]  = vrho[g] phi_i(g) + 2 sum_d vgrad[d,g] dphi_d,i(g)
//   V[i,j]   = sum_g WT[i,g] phi_j(g)
//
// V is the raw (unsymmetrised) matrix; the caller symmetrises it.
//
// Bound: bytes. The four tables are read once (4 ng nao * 8 B) for
// 2 ng nao^2 operations of the product (plus 7 ng nao for WT), about
// nao/16 operations per byte, 7 at nao = 114: below the card's balance
// point. At ng = 78,144 and nao = 114 the data-sheet bound is 0.086 ms
// (287.6 MB at 3.35 TB/s).
//
// Design. The TPU version builds WT in f64 in a separate program, splits
// it into hi/lo f32 planes, and accumulates lane groups of 128 with
// double-single arithmetic in a (2, jb, P, 128) scratch. Here WT is formed
// on the fly in shared memory from the tables and the potentials, so the
// (nao, ng) matrix WT never reaches device memory, and the arithmetic is
// f64 FMA.
//   * a block owns a kTile x kTile (64 x 64) tile of V and one slice of the
//     grid axis (split-K: the grid axis is long, the matrix small). It walks
//     its slice in chunks of kK = 16 points: the WT tile WT[i-tile, chunk]
//     and the phi tile phi[chunk, j-tile] are staged in shared memory, and
//     each thread accumulates a 4 x 4 register tile of V.
//   * each block writes its partial tile to part[slice] of an
//     (n_split, nao, nao) scratch; a second small kernel adds the slices
//     in index order. No atomics, so the result is bit-identical from run
//     to run (the pattern of the middle contraction of ds_jk.cu).
// Ragged ng and nao are handled by bounds checks on the loads (entries out
// of range are staged as zeros); nothing is padded in memory.
//
// Plain C interface for ctypes: the caller allocates everything, passes
// device pointers and the stream; nothing synchronises here.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;   // rows and columns of V per block
constexpr int kK = 16;      // grid points per chunk

__global__ void __launch_bounds__(kThreads)
ds_vxc_gga_kernel(const double* __restrict__ ao,
                  const double* __restrict__ ag,
                  const double* __restrict__ vrho,
                  const double* __restrict__ vgrad,
                  double* __restrict__ part, int ng, int nao,
                  int pts_per_split, int n_jtiles) {
  __shared__ double Ws[kK][kTile];
  __shared__ double Ps[kK][kTile];

  const int tid = threadIdx.x;
  const int tj = tid & 15;    // j = j0 + tj + 16 q
  const int ti = tid >> 4;    // i = i0 + ti + 16 p
  const int split = blockIdx.x;
  const int i0 = (blockIdx.y / n_jtiles) * kTile;
  const int j0 = (blockIdx.y % n_jtiles) * kTile;
  const int gbeg = split * pts_per_split;
  const int gend = min(gbeg + pts_per_split, ng);
  const size_t tab = (size_t)ng * nao;

  double acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.0;

  for (int c0 = gbeg; c0 < gend; c0 += kK) {
    __syncthreads();   // the previous chunk is no longer read
#pragma unroll
    for (int k = 0; k < kK * kTile / kThreads; ++k) {
      const int e = tid + k * kThreads;
      const int gk = e / kTile, l = e % kTile;
      const int g = c0 + gk;
      const int i = i0 + l, j = j0 + l;
      double w = 0.0, f = 0.0;
      if (g < gend) {
        const size_t row = (size_t)g * nao;
        if (i < nao) {
          const double gx = __ldg(ag + row + i);
          const double gy = __ldg(ag + tab + row + i);
          const double gz = __ldg(ag + 2 * tab + row + i);
          double s = __ldg(vgrad + g) * gx;
          s = fma(__ldg(vgrad + ng + g), gy, s);
          s = fma(__ldg(vgrad + 2 * (size_t)ng + g), gz, s);
          w = fma(__ldg(vrho + g), __ldg(ao + row + i), 2.0 * s);
        }
        if (j < nao) f = __ldg(ao + row + j);
      }
      Ws[gk][l] = w;
      Ps[gk][l] = f;
    }
    __syncthreads();
#pragma unroll
    for (int gk = 0; gk < kK; ++gk) {
      double w[4], f[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) w[p] = Ws[gk][ti + 16 * p];
#pragma unroll
      for (int q = 0; q < 4; ++q) f[q] = Ps[gk][tj + 16 * q];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fma(w[p], f[q], acc[p][q]);
    }
  }

  double* out = part + (size_t)split * nao * nao;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = i0 + ti + 16 * p;
    if (i >= nao) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tj + 16 * q;
      if (j < nao) out[(size_t)i * nao + j] = acc[p][q];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ds_vxc_fold(const double* __restrict__ part, double* __restrict__ v,
            int nn, int n_split) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= nn) return;
  double s = 0.0;
  for (int c = 0; c < n_split; ++c) s += part[(size_t)c * nn + e];
  v[e] = s;
}

}  // namespace

// Returns 0 or the cudaError_t of the launch that was refused.
// ao (ng, nao), ag (3, ng, nao), vrho (ng), vgrad (3, ng), v (nao, nao),
// part (n_split, nao, nao) scratch; all contiguous float64 on the device of
// `stream`; n_split * pts_per_split >= ng.
extern "C" int ds_vxc_gga_launch(const void* ao, const void* ag,
                                 const void* vrho, const void* vgrad, void* v,
                                 void* part, int ng, int nao,
                                 int pts_per_split, int n_split,
                                 void* stream) {
  if (ng <= 0 || nao <= 0 || pts_per_split <= 0 || n_split <= 0 ||
      (long long)pts_per_split * n_split < ng)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (nao + kTile - 1) / kTile;
  dim3 grid((unsigned)n_split, (unsigned)(tiles * tiles));
  ds_vxc_gga_kernel<<<grid, kThreads, 0, s>>>(
      (const double*)ao, (const double*)ag, (const double*)vrho,
      (const double*)vgrad, (double*)part, ng, nao, pts_per_split, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nn = nao * nao;
  ds_vxc_fold<<<(unsigned)((nn + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      (const double*)part, (double*)v, nn, n_split);
  return (int)cudaGetLastError();
}
