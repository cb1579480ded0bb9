// Density and density gradient of a GGA on the grid, for NVIDIA Hopper
// (sm_90a), on the float64 tensor cores.
//
// Replaces the TPU kernel dqc_tpu/ops/pallas_xc.py::ds_dens_gga. From the
// AO tables phi (ng, nao), dphi (3, ng, nao) and a density matrix dm
// (nao, nao), all float64, it forms
//
//   C[g,i]    = sum_j phi_j(g) dm[i,j]          (C = phi dm^T, one GEMM)
//   rho[g]    = sum_i phi_i(g)    C[g,i]
//   gdot[d,g] = 2 sum_i dphi_d,i(g) C[g,i]       (d = x, y, z)
//
// which equals sum_ij dm[i,j] phi_i phi_j and 2 sum_ij dm[i,j] dphi_d,i
// phi_j for any dm, symmetric or not. The TPU kernel formed T dm for each
// of the four tables T: four GEMMs, 8 ng nao^2 operations. One GEMM does:
// 2 ng nao^2 + 8 ng nao.
//
// Batch: B members at once (the counterpart of jax.vmap of the TPU kernel,
// which adds a grid axis): member m reads its tables and dm at the member
// strides the caller passes and writes rho[m], gdot[m]. The member is the
// grid's y axis; each member keeps its own blocks, panels and tile walk,
// so a member's result has the bits of its unbatched call at the same
// block count, and one launch serves the whole batch. A batch of one
// takes the variant without the member offsets.
//
// Bound: bytes. The four tables are 4 ng nao * 8 bytes; at ng = 78,144,
// nao = 114 the function moves 287.7 MB, 0.0859 ms at 3.35 TB/s, against
// 2.10 GFLOP, 0.031 ms at the tensor cores' 67 TFLOP/s. On the f64 FMA
// units (34 TFLOP/s) the GEMM alone would take 0.062 ms, 72 % of the byte
// bound: a kernel on them would in practice be held by arithmetic, so the
// GEMM runs on the f64 tensor cores, through mma.sync.aligned.m16n8k4 with
// .f64 operands (sm_90; wgmma has no f64 form).
//
// Design: keep HBM busy with every table read once, and keep dm out of the
// way of that stream.
//   * One persistent block of 16 warps per multiprocessor walks tiles of
//     kBM = 16 grid points with a grid stride. dm is cut into sub-blocks of
//     at most 128 x 128 (panel p of rows i, block q of columns j); for
//     nao <= 128 there is one. Warp w owns the 8 rows i of n-tile w of the
//     panel: it loads their B fragments (dm as stored is B as N x K
//     row-major, which .row.col takes: N = i, K = j) into registers once
//     per sub-block, zero beyond nao, and keeps them for all its tiles. So
//     dm takes no shared memory, and all of it goes to the stream.
//   * The tile's phi rows (the A operand, columns of block q) and its
//     gradient rows (columns of panel p) stream in with cp.async (16 bytes,
//     .cg, where the rows are 16-byte aligned, else 8) into a ring of two or
//     three stages: the next tiles load while this one multiplies. Rows past
//     ng are zero-filled by the copy, the K tail columns of A are zeroed in
//     shared memory; nothing is padded in memory.
//   * Each warp runs its K loop as two chains of m16n8k4 MMAs (even and odd
//     k steps) and adds them; C stays in registers.
//   * Epilogue: each thread multiplies its C fragment by phi (from the A
//     tile when p == q, else from a staged phi panel) and dphi_d at the same
//     (g, i); the four lanes of a quad, which share a row, reduce with xor
//     shuffles; the warps of a row add in index order through shared
//     memory; the first sub-block writes rho and gdot, later ones add to
//     them (only the block that owns a tile touches its points).
// For nao <= 128 each of the four tables is read from device memory once;
// for a larger nao phi is read once per panel as the A operand and each
// gradient table once per column block. No atomics: the result is
// bit-identical from run to run.
//
// The host side (ops/hopper_xc.py::dens_plan) chooses the panel width, the
// number of stages, the dynamic shared memory and the block count; the
// launch checks them against the layout below and refuses a mismatch.
//
// Plain C interface for ctypes: the caller allocates everything, passes
// device pointers and the stream; nothing synchronises here.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16;                    // grid points per tile
constexpr int kMaxPanel = 8 * kWarps;      // one 8-row n-tile per warp
constexpr int kMaxKSteps = kMaxPanel / 4;  // k steps of 4 in a column block
constexpr int kRed = kWarps * 4 * kBM;     // doubles of the reduction buffer

// Shared-memory row strides, in doubles. A: panel + 4, which is 4 or 12 mod
// 16, so the fragment loads of a half warp (8 rows x 4 columns) fall in
// distinct banks. Gradient tables: 8 mod 16, so the 16-byte epilogue loads
// of a quarter warp (2 rows x 4 column pairs) do.
__host__ __device__ inline int a_stride(int panel) { return panel + 4; }
__host__ __device__ inline int e_stride(int panel) {
  return panel % 16 == 8 ? panel : panel + 8;
}
// staged epilogue tables: dphi_x,y,z, and a phi panel when dm has more than
// one panel (off the diagonal the A tile holds other columns)
__host__ __device__ inline int e_tables(int panel, int nao) {
  return nao <= panel ? 3 : 4;
}
__host__ __device__ inline long stage_doubles(int panel, int nao) {
  return (long)kBM * (a_stride(panel) + e_tables(panel, nao) * e_stride(panel));
}

__device__ __forceinline__ void mma_f64(double (&c)[4], double a0, double a1,
                                        double b0) {
  // D (16x8) += A (16x4, row) * B (4x8, col), float64 on the tensor cores
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b0));
}

__device__ __forceinline__ void cp_async16(double* dst, const double* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;   // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(s), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows g0 .. g0 + kBM - 1, columns [c0, c0 + w) of the (ng, nao) table
// `src` into `dst` (row stride ds); rows past ng are zero-filled. `wide`:
// every row start is 16-byte aligned and w is even.
__device__ __forceinline__ void copy_rows(double* dst, int ds,
                                          const double* src, int g0, int c0,
                                          int w, int ng, int nao, bool wide) {
  if (wide) {
    const int cpr = w >> 1;
    for (int c = threadIdx.x; c < kBM * cpr; c += kThreads) {
      const int r = c / cpr, cc = c - r * cpr;
      const bool ok = g0 + r < ng;
      cp_async16(dst + r * ds + 2 * cc,
                 ok ? src + (size_t)(g0 + r) * nao + c0 + 2 * cc : src, ok);
    }
  } else {
    for (int c = threadIdx.x; c < kBM * w; c += kThreads) {
      const int r = c / w, cc = c - r * w;
      const bool ok = g0 + r < ng;
      cp_async8(dst + r * ds + cc,
                ok ? src + (size_t)(g0 + r) * nao + c0 + cc : src, ok);
    }
  }
}

template <int kStages, bool kBatched>
__global__ void __launch_bounds__(kThreads, 1)
ds_dens_gga_kernel(const double* __restrict__ ao,
                   const double* __restrict__ ag,
                   const double* __restrict__ dm,
                   double* __restrict__ rho, double* __restrict__ gdot,
                   int ng, int nao, int panel, int wide, long long ao_member,
                   long long ag_member, long long dm_member) {
  // this block's member: its tables, dm and outputs (a batch of one takes
  // the variant without the offsets, the unbatched kernel's code)
  if (kBatched) {
    const long long m = blockIdx.y;
    ao += m * ao_member;
    ag += m * ag_member;
    dm += m * dm_member;
    rho += m * ng;
    gdot += m * 3LL * ng;
  }
  // stage st: A [kBM][sa], then the epilogue tables [ne][kBM][se];
  // after the ring: the reduction buffer [kWarps][4][kBM]
  extern __shared__ __align__(128) double smem[];
  const int sa = a_stride(panel), se = e_stride(panel);
  const int stage = (int)stage_doubles(panel, nao);
  double* red_s = smem + kStages * stage;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2;           // row of the fragment (groupID)
  const int tq = lane & 3;            // thread in the group
  const int ntiles = (ng + kBM - 1) / kBM;
  const int npanel = (nao + panel - 1) / panel;
  const size_t tab = (size_t)ng * nao;

  for (int sb = 0; sb < npanel * npanel; ++sb) {
    const int p = sb % npanel, q = sb / npanel;
    const int p0 = p * panel, q0 = q * panel;
    const int pw = min(panel, nao - p0), kw = min(panel, nao - q0);
    const int ksteps = (kw + 3) >> 2;
    const bool diag = p == q;
    const int nwork = (pw + 7) >> 3;  // warps with rows of this panel
    const bool mine = warp < nwork;

    // this warp's B fragments: b[ks] = dm[p0 + 8 warp + gq, q0 + 4 ks + tq]
    double bf[kMaxKSteps];
    {
      const int n = warp * 8 + gq;
      const double* row = dm + (size_t)(p0 + n) * nao + q0;
#pragma unroll
      for (int ks = 0; ks < kMaxKSteps; ++ks) {
        const int k = 4 * ks + tq;
        bf[ks] = (mine && n < pw && k < kw) ? __ldg(row + k) : 0.0;
      }
    }

    __syncthreads();                  // the previous sub-block is done
    // the K tail columns of every stage's A tile are read as zeros
    for (int e = tid; e < kStages * kBM * 4; e += kThreads) {
      const int k = kw + (e & 3), r = e >> 2;
      if (k < ksteps * 4) smem[(r / kBM) * stage + (r % kBM) * sa + k] = 0.0;
    }

    auto load_stage = [&](int st, int tile) {
      double* a = smem + st * stage;
      double* e = a + kBM * sa;
      const int g0 = tile * kBM;
      copy_rows(a, sa, ao, g0, q0, kw, ng, nao, wide);
#pragma unroll
      for (int d = 0; d < 3; ++d)
        copy_rows(e + d * kBM * se, se, ag + d * tab, g0, p0, pw, ng, nao,
                  wide);
      if (!diag) copy_rows(e + 3 * kBM * se, se, ao, g0, p0, pw, ng, nao, wide);
    };

    // prologue: the first kStages - 1 tiles of this block
    for (int st = 0; st < kStages - 1; ++st) {
      const int tile = blockIdx.x + st * gridDim.x;
      if (tile < ntiles) load_stage(st, tile);
      cp_async_commit();
    }

    int it = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
      cp_async_wait<kStages - 2>();   // this tile's rows have landed
      __syncthreads();                // ... for every thread; and the stage
                                      // read by the last tile is free
      {
        const int nxt = tile + (kStages - 1) * gridDim.x;
        if (nxt < ntiles) load_stage((it + kStages - 1) % kStages, nxt);
        cp_async_commit();
      }
      const double* a = smem + (it % kStages) * stage;
      const double* e = a + kBM * sa;

      if (mine) {
        double acc0[4] = {0.0, 0.0, 0.0, 0.0}, acc1[4] = {0.0, 0.0, 0.0, 0.0};
        const double* a_lo = a + gq * sa + tq;
        const double* a_hi = a_lo + 8 * sa;
#pragma unroll
        for (int ks = 0; ks < kMaxKSteps; ks += 2) {
          if (ks < ksteps)
            mma_f64(acc0, a_lo[4 * ks], a_hi[4 * ks], bf[ks]);
          if (ks + 1 < ksteps)
            mma_f64(acc1, a_lo[4 * ks + 4], a_hi[4 * ks + 4], bf[ks + 1]);
        }

        // epilogue: row dots of C with phi and dphi_d over this thread's
        // two columns, in a fixed order
        const int il = warp * 8 + 2 * tq;     // column within the panel
        const double* ph = diag ? a : e + 3 * kBM * se;
        const int sp = diag ? sa : se;
        double part[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = gq + 8 * h;
          const double c0 = acc0[2 * h] + acc1[2 * h];
          const double c1 = acc0[2 * h + 1] + acc1[2 * h + 1];
          double v[4][2];                     // phi, dphi_x, dphi_y, dphi_z
          if (il + 1 < pw) {
            const double2 x = *reinterpret_cast<const double2*>(ph + r * sp + il);
            v[0][0] = x.x; v[0][1] = x.y;
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              const double2 y = *reinterpret_cast<const double2*>(
                  e + (d * kBM + r) * se + il);
              v[1 + d][0] = y.x; v[1 + d][1] = y.y;
            }
          } else {
            const bool ok = il < pw;
            v[0][0] = ok ? ph[r * sp + il] : 0.0;
            v[0][1] = 0.0;
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              v[1 + d][0] = ok ? e[(d * kBM + r) * se + il] : 0.0;
              v[1 + d][1] = 0.0;
            }
          }
#pragma unroll
          for (int t = 0; t < 4; ++t)
            part[h][t] = fma(c1, v[t][1], c0 * v[t][0]);
        }
        // the four lanes of a quad share a row
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            double x = part[h][t];
            x += __shfl_xor_sync(0xffffffffu, x, 1);
            x += __shfl_xor_sync(0xffffffffu, x, 2);
            part[h][t] = x;
          }
        if (tq == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int t = 0; t < 4; ++t)
              red_s[(warp * 4 + t) * kBM + gq + 8 * h] = part[h][t];
        }
      }
      __syncthreads();
      // the warps of a row, added in index order
      if (tid < 4 * kBM) {
        const int t = tid / kBM, r = tid - t * kBM;
        const int g = tile * kBM + r;
        if (g < ng) {
          double v = 0.0;
          for (int w = 0; w < nwork; ++w) v += red_s[(w * 4 + t) * kBM + r];
          double* out = t == 0 ? rho + g : gdot + (size_t)(t - 1) * ng + g;
          if (t > 0) v *= 2.0;
          *out = sb == 0 ? v : *out + v;
        }
      }
    }
    cp_async_wait<0>();               // nothing in flight into the ring
  }
}

constexpr int kMaxDevices = 64;

// Dynamic shared memory above 48 KB only after opting in, which holds for
// the current device and every later launch there; so it is asked once per
// device and stage count, for the largest plan seen so far (under a lock:
// ctypes calls in without the GIL).
template <int kStages, bool kBatched>
cudaError_t opt_in(int smem_bytes) {
  static std::mutex mu;
  static int granted[kMaxDevices] = {};
  std::lock_guard<std::mutex> lock(mu);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (granted[dev] >= smem_bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(ds_dens_gga_kernel<kStages, kBatched>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes);
  if (e == cudaSuccess) granted[dev] = smem_bytes;
  return e;
}

template <int kStages, bool kBatched>
int launch(const double* ao, const double* ag, const double* dm, double* rho,
           double* gdot, int ng, int nao, int panel, int smem_bytes,
           int blocks, int batch, long long ao_member, long long ag_member,
           long long dm_member, cudaStream_t stream) {
  const cudaError_t e = opt_in<kStages, kBatched>(smem_bytes);
  if (e != cudaSuccess) return (int)e;
  // 16-byte copies where every member's rows start on 16 bytes
  const int wide = nao % 2 == 0 && (uintptr_t)ao % 16 == 0 &&
                   (uintptr_t)ag % 16 == 0 &&
                   (batch == 1 || (ao_member % 2 == 0 && ag_member % 2 == 0));
  const dim3 grid((unsigned)blocks, (unsigned)batch);
  ds_dens_gga_kernel<kStages, kBatched>
      <<<grid, kThreads, smem_bytes, stream>>>(
      ao, ag, dm, rho, gdot, ng, nao, panel, wide, ao_member, ag_member,
      dm_member);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 or a cudaError_t: of the launch that was refused, or
// cudaErrorInvalidValue for a plan that does not match this kernel.
// For each of the `batch` members m: ao + m ao_member (ng, nao), ag + m
// ag_member (3, ng, nao), dm + m dm_member (nao, nao) (strides in doubles;
// each member's tables and dm contiguous), rho (batch, ng), gdot (batch, 3,
// ng); all float64 on the device of `stream`. The plan (tile_points,
// panel, stages, smem_bytes, blocks per member) comes from
// hopper_xc.dens_plan(ng, nao, sms, batch).
extern "C" int ds_dens_gga_launch(const void* ao, const void* ag,
                                  const void* dm, void* rho, void* gdot,
                                  int ng, int nao, int batch,
                                  long long ao_member, long long ag_member,
                                  long long dm_member, int tile_points,
                                  int panel, int stages, int smem_bytes,
                                  int blocks, void* stream) {
  if (ng <= 0 || nao <= 0 || blocks <= 0 || tile_points != kBM ||
      panel <= 0 || panel % 8 != 0 || panel > kMaxPanel ||
      (stages != 2 && stages != 3) || batch <= 0 || batch > 65535 ||
      ao_member < 0 || ag_member < 0 || dm_member < 0)
    return (int)cudaErrorInvalidValue;
  const long need = 8L * (stages * stage_doubles(panel, nao) + kRed);
  if (need != smem_bytes) return (int)cudaErrorInvalidValue;
  const double* a = (const double*)ao;
  const double* g = (const double*)ag;
  const double* d = (const double*)dm;
  cudaStream_t st = (cudaStream_t)stream;
  double* r = (double*)rho;
  double* gd = (double*)gdot;
  if (batch == 1)
    return stages == 3
               ? launch<3, false>(a, g, d, r, gd, ng, nao, panel, smem_bytes,
                                  blocks, 1, 0, 0, 0, st)
               : launch<2, false>(a, g, d, r, gd, ng, nao, panel, smem_bytes,
                                  blocks, 1, 0, 0, 0, st);
  return stages == 3
             ? launch<3, true>(a, g, d, r, gd, ng, nao, panel, smem_bytes,
                               blocks, batch, ao_member, ag_member, dm_member,
                               st)
             : launch<2, true>(a, g, d, r, gd, ng, nao, panel, smem_bytes,
                               blocks, batch, ao_member, ag_member, dm_member,
                               st);
}
