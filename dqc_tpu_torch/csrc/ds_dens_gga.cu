// Density and density gradient of a GGA on the grid, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel dqc_tpu/ops/pallas_xc.py::ds_dens_gga. From the
// AO tables phi (ng, nao), dphi (3, ng, nao) and a density matrix dm
// (nao, nao), all float64, it forms
//
//   rho[g]    = sum_j phi_j(g) * sum_i phi_i(g)   dm[i,j]
//   gdot[d,g] = 2 sum_j phi_j(g) * sum_i dphi_d,i(g) dm[i,j]
//
// that is B_t = T_t dm for the four tables T_t = (phi, dphi_x, dphi_y,
// dphi_z), each followed by a row-wise dot with phi, fused so that the
// (ng, nao) products B_t never reach device memory.
//
// Bound: operations. 8 ng nao^2 float64 operations (four GEMMs) against
// 4 ng nao * 8 bytes of tables: about nao/4 operations per byte, 28 at
// nao = 114, above the card's balance point in f64. At ng = 78,144 and
// nao = 114 the data-sheet bound is 0.121 ms (8.1 GFLOP at 67 TFLOP/s);
// this kernel uses the f64 FMA units, not the tensor cores, so it cannot
// come closer than about twice that.
//
// Design. The TPU kernel stores the tables transposed as hi/lo f32 planes
// padded to (8,128) tiles, selects dm columns with a masked iota and does
// double-single arithmetic, because that chip has no f64 units; it also
// asserts nao <= 128. None of that is kept: the f64 tables are read as they
// are, arithmetic is f64 FMA, and any nao works.
//   * a block owns kG = 32 grid points. It walks the columns j in tiles of
//     kJ = 64 and, inside, the rows i in chunks of kI = 16: the four table
//     tiles T_t[g, i-chunk] and the dm tile dm[i-chunk, j-tile] are staged
//     in shared memory (26 KB), and each thread keeps a 4 tables x 2 points
//     x 4 columns register tile of B_t.
//   * at the end of a column tile each thread multiplies its B_t by
//     phi_j(g) and adds the products into its own 4 x 2 partial sums.
//   * after the last column tile the 16 threads that share a point reduce
//     their partial sums with xor shuffles inside a half warp, in a fixed
//     order, and one thread writes rho[g] and gdot[:, g].
// No atomics: the result is bit-identical from run to run. Ragged ng and
// nao are handled by bounds checks on the loads (out-of-range entries are
// staged as zeros); nothing is padded in memory.
//
// Plain C interface for ctypes: the caller allocates everything, passes
// device pointers and the stream; nothing synchronises here.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kG = 32;   // grid points per block
constexpr int kJ = 64;   // columns of dm per tile
constexpr int kI = 16;   // rows of dm per chunk
constexpr int kT = 4;    // tables: phi, dphi_x, dphi_y, dphi_z

__global__ void __launch_bounds__(kThreads)
ds_dens_gga_kernel(const double* __restrict__ ao,
                   const double* __restrict__ ag,
                   const double* __restrict__ dm,
                   double* __restrict__ rho, double* __restrict__ gdot,
                   int ng, int nao) {
  // +1: rows of neighbouring points fall in different banks
  __shared__ double As[kT][kG][kI + 1];
  __shared__ double Ds[kI][kJ];

  const int tid = threadIdx.x;
  const int tj = tid & 15;    // column lane: j = j0 + tj + 16 p
  const int tg = tid >> 4;    // point lane:  g = g0 + tg + 16 q
  const int g0 = blockIdx.x * kG;
  const size_t tab = (size_t)ng * nao;

  double part[kT][2];
#pragma unroll
  for (int t = 0; t < kT; ++t) part[t][0] = part[t][1] = 0.0;

  for (int j0 = 0; j0 < nao; j0 += kJ) {
    double acc[kT][2][4];
#pragma unroll
    for (int t = 0; t < kT; ++t)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int p = 0; p < 4; ++p) acc[t][q][p] = 0.0;

    for (int i0 = 0; i0 < nao; i0 += kI) {
      __syncthreads();   // the previous chunk is no longer read
#pragma unroll
      for (int k = 0; k < kT * kG * kI / kThreads; ++k) {
        const int e = tid + k * kThreads;
        const int t = e / (kG * kI);
        const int r = e % (kG * kI);
        const int gl = r / kI, il = r % kI;
        const int g = g0 + gl, i = i0 + il;
        const double* T = t == 0 ? ao : ag + (size_t)(t - 1) * tab;
        As[t][gl][il] = (g < ng && i < nao) ? __ldg(T + (size_t)g * nao + i)
                                            : 0.0;
      }
#pragma unroll
      for (int k = 0; k < kI * kJ / kThreads; ++k) {
        const int e = tid + k * kThreads;
        const int il = e / kJ, jl = e % kJ;
        const int i = i0 + il, j = j0 + jl;
        Ds[il][jl] = (i < nao && j < nao) ? __ldg(dm + (size_t)i * nao + j)
                                          : 0.0;
      }
      __syncthreads();
#pragma unroll 4
      for (int il = 0; il < kI; ++il) {
        double d[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) d[p] = Ds[il][tj + 16 * p];
#pragma unroll
        for (int t = 0; t < kT; ++t)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const double a = As[t][tg + 16 * q][il];
#pragma unroll
            for (int p = 0; p < 4; ++p) acc[t][q][p] = fma(a, d[p], acc[t][q][p]);
          }
      }
    }

    // B_t[g, j] times phi_j(g), summed over this thread's columns
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int g = g0 + tg + 16 * q;
      if (g >= ng) continue;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int j = j0 + tj + 16 * p;
        if (j >= nao) continue;
        const double phi = __ldg(ao + (size_t)g * nao + j);
#pragma unroll
        for (int t = 0; t < kT; ++t) part[t][q] = fma(acc[t][q][p], phi, part[t][q]);
      }
    }
  }

  // the 16 column lanes of a point sit in one half warp
#pragma unroll
  for (int t = 0; t < kT; ++t)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      double v = part[t][q];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      part[t][q] = v;
    }
  if (tj == 0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int g = g0 + tg + 16 * q;
      if (g >= ng) continue;
      rho[g] = part[0][q];
#pragma unroll
      for (int d = 0; d < 3; ++d) gdot[(size_t)d * ng + g] = 2.0 * part[1 + d][q];
    }
  }
}

}  // namespace

// Returns 0 or the cudaError_t of the launch that was refused.
// ao (ng, nao), ag (3, ng, nao), dm (nao, nao), rho (ng), gdot (3, ng); all
// contiguous float64 on the device of `stream`.
extern "C" int ds_dens_gga_launch(const void* ao, const void* ag,
                                  const void* dm, void* rho, void* gdot,
                                  int ng, int nao, void* stream) {
  if (ng <= 0 || nao <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((ng + kG - 1) / kG);
  ds_dens_gga_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)ao, (const double*)ag, (const double*)dm, (double*)rho,
      (double*)gdot, ng, nao);
  return (int)cudaGetLastError();
}
