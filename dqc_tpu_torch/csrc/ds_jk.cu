// Fused J+K contraction of a dense 4-index float64 tensor with a density
// matrix, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel dqc_tpu/ops/pallas_jk.py::ds_jk. In one read of
// T (n,n,n,n) it forms
//
//   out_trail[i,a] = sum_{b,l} T[i,a,b,l] * dm[b,l]
//   out_mid[i,b]   = sum_{a,l} T[i,a,b,l] * dm[a,l]
//
// With T = eri_k (eri_k[i,j,k,l] = (ik|jl)) these are K and J. T need not
// have any symmetry, nor dm; n is anything from 1 to 256 (64-bit offsets;
// the dense route stops at n = 215).
//
// Batch: B members at once (the counterpart of jax.vmap of the TPU kernel,
// which adds a grid axis). Member m reads T + m * t_member and dm + m *
// dm_member (strides in doubles; B = 1 is the unbatched call) and writes
// out_trail[m], out_mid[m]. The B n^2 tiles (m, i, a) form one index t =
// (m n + i) n + a, and the launch below spreads all of them over the
// card's multiprocessors, so one launch serves the whole batch.
//
// Bound: bytes. T is read once (n^4 * 8 B; 1,351,168,128 B at n = 114) for
// 4 n^4 float64 operations, half an operation per byte: the f64 units would
// be the limit only above about 60 TB/s. At the 3.35 TB/s of the H100 SXM
// data sheet the least time at n = 114 is about 0.40 ms. So the whole job is
// to stream T once at the HBM rate and to do nothing per byte that costs
// more than the byte.
//
// Design. The n^2 tiles T[i,a,:,:] lie in memory one after the other, in
// (i,a) order, and each is n rows of n doubles.
//   * Persistent grid, one block per multiprocessor: block q owns the
//     contiguous tile range [q * tiles_per_block, ...), so the last wave is
//     short by less than one tile.
//   * Warp specialised. One producer thread streams the block's range
//     through a ring of shared-memory stages with 1-D bulk copies
//     (cp.async.bulk, completing on an mbarrier per stage); a stage is
//     stage_rows rows of one tile, about 32 KB, and several are in flight
//     per multiprocessor. 16 consumer warps read the stage from shared
//     memory and release it on a second mbarrier. A bulk copy needs 16-byte
//     aligned addresses and sizes: where a stage does not start or end on
//     16 bytes (odd n, or T 8 bytes into its storage) the copy takes the
//     aligned span around it and the consumers start one double in. The
//     span never leaves the 16-byte granules that hold T's own elements, so
//     nothing is padded and no page outside T is touched.
//   * Row b of every tile belongs to consumer warp b mod 16 (stage_rows is
//     a multiple of 16), as its m-th row (b = warp + 16 m); lane takes the
//     columns l = lane + 32 j. Per element two FMAs, one into the lane's
//     running K sum (dm[b,l]) and one into jacc[m], the lane's J sum of row
//     b (dm[a,l], which the lane holds in registers for the whole tile). m
//     and j run over fixed bounds (16 and 8, hence n <= 256), so jacc and
//     dm's row a stay in registers. At the end of each tile the warp reduces
//     its K sum with shuffles into its slot k_part[tile, warp]; at the end
//     of each i segment it reduces each jacc[m] into the segment's slot in
//     mid_part. No block barrier per tile, no shuffle per row.
//   * dm: kept in shared memory when it fits beside three stages
//     (dm_shared; n <= 128 on an H100), read from device memory once per
//     block. For a larger n each stage also carries the same rows of dm,
//     copied in bulk beside T's rows (dm stays in L2; its rows go to shared
//     memory with the stage). Either way a consumer reads dm[b,l] from
//     shared memory, never through L1/L2 on the per-element path.
//   * Batched: a block's tile range may cross from member m to m + 1;
//     with dm in shared memory the consumers then load the next member's dm
//     between two named barriers (the producer never reads dm there).
//   * A second small kernel adds, per tile, the 16 warp slots of K in warp
//     order and, per row (m, i), the J slots of the blocks that share it in
//     block order.
// No floating-point atomics, and every sum has a fixed order, so two
// launches give the same bits.
//
// The host side (ops/hopper_jk.py::jk_plan) decides the layout: blocks,
// tiles per block, stage rows, stages, the stage stride, whether dm is
// shared, the J slots per block and every shared-memory offset. The launch
// checks the plan against what this kernel needs (its consumer warps and
// largest ring and n, alignments, no overlap, the card's 227 KB) and
// refuses one that does not fit; it does not lay anything out itself.
//
// Plain C interface for ctypes: the caller allocates everything, passes
// device pointers and the stream; nothing synchronises here.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kConsumerWarps = 16;
constexpr int kThreads = 32 * (kConsumerWarps + 1);   // + one producer warp
constexpr int kMaxStages = 6;
// lane takes columns l = lane + 32 j (j < kMaxCols), warp takes rows
// b = warp + 16 m (m < kMaxRows): n up to 256
constexpr int kMaxCols = 8;
constexpr int kMaxRows = 16;
constexpr int kMaxN = 32 * kMaxCols;
static_assert(kConsumerWarps * kMaxRows == kMaxN, "rows and columns");
constexpr int kFoldThreads = 128;
constexpr long kSmemLimit = 232448;    // opt-in shared memory of an H100 block

__host__ __device__ __forceinline__ long lmin(long x, long y) {
  return x < y ? x : y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from the 16-byte aligned global address src to
// the 16-byte aligned shared address dst; completes on bar's transaction
// count
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <bool kDmShared>
__device__ __forceinline__ double dm_at(const double* p) {
  if (kDmShared) return *p;
  return __ldg(p);
}

// dm[a, lane + 32 j] for every j, zero past n
template <bool kDmShared>
__device__ __forceinline__ void load_row(double (&out)[kMaxCols],
                                         const double* row, int n, int lane) {
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    const int l = lane + 32 * j;
    out[j] = l < n ? dm_at<kDmShared>(row + l) : 0.0;
  }
}

// the aligned span of the bulk copy of count doubles at p: its start, its
// bytes, and where p lies in it (0 or 1 double in)
struct Span {
  uintptr_t lo;
  uint32_t bytes;
  int lead;
};

__device__ __forceinline__ Span span_of(const double* p, long count) {
  const uintptr_t a = (uintptr_t)p;
  const uintptr_t lo = a & ~(uintptr_t)15;
  const uintptr_t hi = (a + (uintptr_t)count * sizeof(double) + 15) &
                       ~(uintptr_t)15;
  return {lo, (uint32_t)(hi - lo), (int)((a - lo) >> 3)};
}

// A block's tiles in order: tile t = (m n + i) n + a is T[m, i, a, :, :]
// at T + m t_member + (t mod n^2) n^2, beside member m's dm. Advanced one
// tile at a time, with no division on the per-stage path.
struct TileWalk {
  const double* tile;   // the current tile's first row
  const double* dmm;    // its member's dm
  long left;            // tiles of the member from this one to its end

  __device__ __forceinline__ TileWalk(const double* T, const double* dm,
                                      long t, long n2, long long t_member,
                                      long long dm_member)
      : tile(T + (t / n2) * t_member + (t % n2) * n2),
        dmm(dm + (t / n2) * dm_member),
        left(n2 - t % n2) {}

  // the next tile; true when it is the first of the next member
  __device__ __forceinline__ bool next(long n2, long long t_member,
                                       long long dm_member) {
    if (--left > 0) {
      tile += n2;
      return false;
    }
    left = n2;
    tile += t_member - (n2 - 1) * n2;
    dmm += dm_member;
    return true;
  }
};

template <bool kDmShared>
__global__ void __launch_bounds__(kThreads, 1)
ds_jk_stream(const double* __restrict__ T, const double* __restrict__ dm,
             double* __restrict__ k_part, double* __restrict__ mid_part,
             int n, int batch, long long t_member, long long dm_member,
             int tiles_per_block, int stage_rows, int stages,
             int stage_doubles, int islots, int dm_offset, int bar_offset) {
  extern __shared__ __align__(128) unsigned char smem[];
  double* ring = reinterpret_cast<double*>(smem);
  double* dm_s = reinterpret_cast<double*>(smem + dm_offset);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + bar_offset);
  uint64_t* empty = full + stages;
  // without dm in shared memory a stage holds its T rows, then the same
  // rows of dm
  const int dm_half = stage_doubles / 2;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long n2 = (long)n * n;
  const long t0 = (long)blockIdx.x * tiles_per_block;
  const long t1 = lmin(t0 + tiles_per_block, (long)batch * n2);
  const long n_stages = (t1 - t0) * ((n + stage_rows - 1) / stage_rows);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {            // the producer
    if (lane == 0) {
      int s = 0, b0 = 0;
      uint32_t round = 0;
      TileWalk w(T, dm, t0, n2, t_member, dm_member);
      for (long k = 0; k < n_stages; ++k) {
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        const int g = (int)lmin(stage_rows, n - b0);
        const Span ts = span_of(w.tile + (long)b0 * n, (long)g * n);
        double* dst = ring + (long)s * stage_doubles;
        if (kDmShared) {
          mbar_expect_tx(&full[s], ts.bytes);
          bulk_load(dst, (const void*)ts.lo, ts.bytes, &full[s]);
        } else {
          const Span ds = span_of(w.dmm + (long)b0 * n, (long)g * n);
          mbar_expect_tx(&full[s], ts.bytes + ds.bytes);
          bulk_load(dst, (const void*)ts.lo, ts.bytes, &full[s]);
          bulk_load(dst + dm_half, (const void*)ds.lo, ds.bytes, &full[s]);
        }
        if (++s == stages) { s = 0; ++round; }
        b0 += stage_rows;
        if (b0 >= n) {
          b0 = 0;
          w.next(n2, t_member, dm_member);
        }
      }
    }
    return;
  }

  // consumers: dm into shared memory (when it fits) while the producer's
  // first copies are already in flight
  TileWalk w(T, dm, t0, n2, t_member, dm_member);
  if (kDmShared) {
    for (long x = threadIdx.x; x < n2; x += 32 * kConsumerWarps)
      dm_s[x] = w.dmm[x];
    asm volatile("bar.sync 1, %0;\n" :: "n"(32 * kConsumerWarps) : "memory");
  }

  // row b = warp + kConsumerWarps * m of every tile is this warp's; lane
  // takes columns l = lane + 32 * j. jacc[m]: the lane's J sum of row b
  // over the tiles of the current i; dma[j]: dm[a, l] of the current tile.
  double jacc[kMaxRows];
  double dma[kMaxCols];
#pragma unroll
  for (int m = 0; m < kMaxRows; ++m) jacc[m] = 0.0;
  double kacc = 0.0;
  long t = t0;
  long i = t0 / n;
  int a = (int)(t0 - i * n);
  const long i_first = i;
  int s = 0, b0 = 0;
  uint32_t phase = 0;
  load_row<kDmShared>(dma, (kDmShared ? dm_s : w.dmm) + (long)a * n, n,
                      lane);
  for (long k = 0; k < n_stages; ++k) {
    const int g = (int)lmin(stage_rows, n - b0);
    const double* stage = ring + (long)s * stage_doubles;
    const double* rows = stage + span_of(w.tile + (long)b0 * n, 0).lead;
    const double* dmb =
        kDmShared ? dm_s + (long)b0 * n
                  : stage + dm_half + span_of(w.dmm + (long)b0 * n, 0).lead;
    const int m0 = b0 / kConsumerWarps;
    mbar_wait(&full[s], phase);
#pragma unroll
    for (int m = 0; m < kMaxRows; ++m) {
      const int r = (m - m0) * kConsumerWarps + warp;   // row in the stage
      if (m >= m0 && r < g) {
        const double* x_row = rows + (long)r * n;
        const double* d_row = dmb + (long)r * n;
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j) {
          const int l = lane + 32 * j;
          if (l < n) {
            const double x = x_row[l];
            kacc = fma(x, d_row[l], kacc);
            jacc[m] = fma(x, dma[j], jacc[m]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == stages) { s = 0; phase ^= 1; }
    b0 += stage_rows;
    if (b0 < n) continue;
    // tile t ends here: the warp's K slot
    const double kw = warp_sum(kacc);
    kacc = 0.0;
    if (lane == 0) k_part[t * kConsumerWarps + warp] = kw;
    if (a == n - 1 || t == t1 - 1) {        // and so does an i segment
      double* part =
          mid_part + ((long)blockIdx.x * islots + (i - i_first)) * n;
#pragma unroll
      for (int m = 0; m < kMaxRows; ++m) {
        const int b = warp + kConsumerWarps * m;
        if (b < n) {                          // warp-uniform
          const double v = warp_sum(jacc[m]);
          if (lane == 0) part[b] = v;
        }
        jacc[m] = 0.0;
      }
    }
    b0 = 0;
    ++t;
    if (++a == n) { a = 0; ++i; }
    const bool new_member = w.next(n2, t_member, dm_member);
    if (t >= t1) continue;
    if (kDmShared && new_member) {
      // a new member: every consumer warp is done with the last one's dm
      // (all of them walk the same tiles), then its dm replaces it
      asm volatile("bar.sync 1, %0;\n" :: "n"(32 * kConsumerWarps)
                   : "memory");
      for (long x = threadIdx.x; x < n2; x += 32 * kConsumerWarps)
        dm_s[x] = w.dmm[x];
      asm volatile("bar.sync 1, %0;\n" :: "n"(32 * kConsumerWarps)
                   : "memory");
    }
    load_row<kDmShared>(dma, (kDmShared ? dm_s : w.dmm) + (long)a * n, n,
                        lane);
  }
}

__global__ void __launch_bounds__(kFoldThreads)
ds_jk_fold(const double* __restrict__ k_part,
           const double* __restrict__ mid_part, double* __restrict__ out_trail,
           double* __restrict__ out_mid, int n, int tiles_per_block,
           int islots) {
  const long i = blockIdx.x;
  for (int a = threadIdx.x; a < n; a += kFoldThreads) {
    const double* kp = k_part + (i * n + a) * kConsumerWarps;
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) s += kp[w];
    out_trail[i * n + a] = s;
  }
  // the blocks whose tile ranges meet row i of tiles, in block order
  const long q_lo = i * n / tiles_per_block;
  const long q_hi = ((i + 1) * n - 1) / tiles_per_block;
  for (int b = threadIdx.x; b < n; b += kFoldThreads) {
    double s = 0.0;
    for (long q = q_lo; q <= q_hi; ++q) {
      const long slot = i - q * tiles_per_block / n;
      s += mid_part[(q * islots + slot) * n + b];
    }
    out_mid[i * n + b] = s;
  }
}

constexpr int kMaxDevices = 64;

// Dynamic shared memory above 48 KB only after opting in, which holds for
// the current device and every later launch there; so it is asked once per
// device and variant, for the largest plan seen so far (under a lock:
// ctypes calls in without the GIL).
template <bool kDmShared>
cudaError_t opt_in(int smem_bytes) {
  static std::mutex mu;
  static int granted[kMaxDevices] = {};
  std::lock_guard<std::mutex> lock(mu);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (granted[dev] >= smem_bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(ds_jk_stream<kDmShared>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes);
  if (e == cudaSuccess) granted[dev] = smem_bytes;
  return e;
}

// Does the plan fit this kernel? Checks, lays out nothing.
bool plan_fits(int n, int batch, int blocks, int tiles_per_block,
               int stage_rows, int stages, int stage_doubles, int dm_shared,
               int islots, int dm_offset, int bar_offset, int smem_bytes) {
  if (n <= 0 || n > kMaxN || batch <= 0 || blocks <= 0 ||
      tiles_per_block <= 0 || islots <= 0 ||
      (dm_shared != 0 && dm_shared != 1))
    return false;
  const long n2 = (long)n * n * batch;   // all tiles of the batch
  if ((long)blocks * tiles_per_block < n2 ||
      (long)(blocks - 1) * tiles_per_block >= n2)
    return false;
  // a stage: its rows of T plus a double on each side for the aligned span,
  // and without dm in shared memory the same again for dm's rows
  const long rows = lmin(stage_rows, n) * n + 2;
  const long part = dm_shared ? stage_doubles : stage_doubles / 2;
  if (stage_rows <= 0 || stage_rows % kConsumerWarps != 0 || stages < 2 ||
      stages > kMaxStages || part % 16 != 0 || part < rows ||
      (!dm_shared && stage_doubles % 32 != 0))
    return false;
  for (long q = 0; q < blocks; ++q) {   // a J slot for every row it meets
    const long t0 = q * tiles_per_block;
    const long t1 = lmin(t0 + tiles_per_block, n2);
    if ((t1 - 1) / n - t0 / n >= islots) return false;
  }
  const long ring_end = 8L * stage_doubles * stages;
  if (dm_offset < ring_end || dm_offset % 16 != 0) return false;
  const long dm_end = (long)dm_offset + (dm_shared ? 8L * n * n : 0);
  if (bar_offset < dm_end || bar_offset % 8 != 0) return false;
  return (long)bar_offset + 16L * stages <= smem_bytes &&
         smem_bytes <= kSmemLimit;
}

template <bool kDmShared>
int launch(const double* T, const double* dm, double* k_part, double* mid_part,
           int n, int batch, long long t_member, long long dm_member,
           int blocks, int tiles_per_block, int stage_rows, int stages,
           int stage_doubles, int islots, int dm_offset, int bar_offset,
           int smem_bytes, cudaStream_t stream) {
  const cudaError_t e = opt_in<kDmShared>(smem_bytes);
  if (e != cudaSuccess) return (int)e;
  ds_jk_stream<kDmShared><<<blocks, kThreads, smem_bytes, stream>>>(
      T, dm, k_part, mid_part, n, batch, t_member, dm_member,
      tiles_per_block, stage_rows, stages, stage_doubles, islots, dm_offset,
      bar_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 or a cudaError_t: of a launch that was refused, or
// cudaErrorInvalidValue for a plan that does not fit this kernel.
// For each of the `batch` members m: T + m t_member (n,n,n,n) and dm + m
// dm_member (n,n) (strides in doubles, each tile 16-byte aligned or not);
// out_trail, out_mid (batch, n, n); scratch k_part (batch*n*n, 16) and
// mid_part (blocks, islots, n); all float64 on the device of `stream`. The
// plan (blocks ... smem_bytes) comes from hopper_jk.jk_plan(n, sms, batch).
extern "C" int ds_jk_launch(const void* T, const void* dm, void* out_trail,
                            void* out_mid, void* k_part, void* mid_part, int n,
                            int batch, long long t_member,
                            long long dm_member, int blocks,
                            int tiles_per_block, int stage_rows, int stages,
                            int stage_doubles, int dm_shared, int islots,
                            int dm_offset, int bar_offset, int smem_bytes,
                            void* stream) {
  if (!plan_fits(n, batch, blocks, tiles_per_block, stage_rows, stages,
                 stage_doubles, dm_shared, islots, dm_offset, bar_offset,
                 smem_bytes) || t_member < 0 || dm_member < 0)
    return (int)cudaErrorInvalidValue;
  const double* t = (const double*)T;
  const double* d = (const double*)dm;
  double* kp = (double*)k_part;
  double* mp = (double*)mid_part;
  cudaStream_t s = (cudaStream_t)stream;
  const int err =
      dm_shared ? launch<true>(t, d, kp, mp, n, batch, t_member, dm_member,
                               blocks, tiles_per_block, stage_rows, stages,
                               stage_doubles, islots, dm_offset, bar_offset,
                               smem_bytes, s)
                : launch<false>(t, d, kp, mp, n, batch, t_member, dm_member,
                                blocks, tiles_per_block, stage_rows, stages,
                                stage_doubles, islots, dm_offset, bar_offset,
                                smem_bytes, s);
  if (err != 0) return err;
  // one fold block per row (m, i) of the batch
  ds_jk_fold<<<(unsigned)(n * batch), kFoldThreads, 0, s>>>(
      kp, mp, (double*)out_trail, (double*)out_mid, n, tiles_per_block,
      islots);
  return (int)cudaGetLastError();
}
