// Assembly of the raw GGA exchange-correlation matrix, for NVIDIA Hopper
// (sm_90a), on the float64 tensor cores.
//
// Replaces the TPU kernel dqc_tpu/ops/pallas_xc.py::ds_vxc_gga together
// with its prologue build_wt. From the AO tables phi (ng, nao), dphi
// (3, ng, nao) and the pointwise potentials vrho (ng), vgrad (3, ng), all
// float64 with the quadrature weights already folded into the potentials,
// it forms
//
//   WT[g,i] = vrho[g] phi_i(g) + 2 sum_d vgrad[d,g] dphi_d,i(g)
//   V[i,j]  = sum_g WT[g,i] phi_j(g)              (V = WT^T phi, one GEMM)
//
// V is the raw (unsymmetrised) matrix; the caller symmetrises it.
//
// Batch: B members at once (the counterpart of jax.vmap of the TPU kernel,
// which adds a grid axis): member m reads its tables and potentials at the
// member strides the caller passes and writes V[m]. The member is the
// grid's y axis of both kernels: each member has its own blocks, its own
// partials part[m][block] and its own fold in the same fixed order, so a
// member's V has the bits of its unbatched call at the same block count,
// and one launch serves the whole batch. A batch of one takes the variant
// without the member offsets.
//
// Bound: bytes. The four tables are 4 ng nao * 8 bytes; at ng = 78,144,
// nao = 114 the function moves 287.7 MB, 0.0859 ms at 3.35 TB/s, against
// 2 ng nao^2 + 8 ng nao = 2.10 GFLOP (2.56 GFLOP as the padded 128 x 128
// product runs), 0.038 ms at the tensor cores' 67 TFLOP/s. The MMAs take
// under half of the byte bound, so the copies and the MMAs have to
// overlap; on the f64 FMA units alone the product would come close to the
// bound by itself. So V runs on the f64 tensor cores, through
// mma.sync.aligned.m16n8k4 with .f64 operands (sm_90; wgmma has no f64
// form), with M = i, N = j and K = g.
//
// Design: read every table once, never write WT to device memory.
//   * One persistent block of 16 warps per multiprocessor (no more blocks
//     than tiles) takes a contiguous range of tiles of kBK = 16 grid
//     points: block b owns tiles [b * tiles / blocks, (b + 1) * tiles /
//     blocks), so its partial V is a sum in a fixed order and the ranges
//     differ by at most one tile.
//   * V is cut into sub-blocks of panel x panel (panel a multiple of 16, at
//     most 128; the panels of an axis as even as 16 allows): panel p of
//     rows i takes WT, panel q of columns j takes phi. For nao <= 128 there
//     is one sub-block and each table is read from device memory exactly
//     once; above that, each sub-block streams the block's range again.
//   * Warp 0 streams the tiles with 1-D bulk copies (cp.async.bulk,
//     completing on one mbarrier per stage) into a ring of two or three
//     stages, each holding one tile of phi, dphi_x, dphi_y, dphi_z (and
//     phi of panel q off the diagonal) and its 4 x 16 potentials. With one
//     panel, a table's 16 rows are one contiguous span of 16 nao doubles:
//     one copy each. With more, each row's panel segment is a copy. A bulk
//     copy needs 16-byte aligned addresses and sizes; where a span does not
//     start or end on 16 bytes (ao_grad's table d starts at d ng nao
//     doubles, odd when ng nao is; a table 8 bytes into its storage), the
//     copy takes the aligned span around it, which never leaves the
//     16-byte granules of the table's own elements, and the readers start
//     one double in. Rows past ng are not copied. Nothing is padded in
//     memory. (A ring fed by cp.async, 16 bytes a thread as in
//     ds_dens_gga.cu, streamed these tables more slowly on the card.)
//   * All 16 warps then form, from the stage, the two operands in padded
//     shared memory: WT_s[g][i] = vrho phi + 2 (vx dphi_x + vy dphi_y +
//     vz dphi_z) (7 operations per element on the FMA units) and PH_s[g][j]
//     = phi; warp r forms row r, whose place in a stage is the same for
//     every tile (tiles start at even rows). Rows past ng and columns past
//     the panel's width are written as zeros, so the product's K axis sees
//     exact zeros and no stale value reaches V. Once formed, the stage is
//     free: warp 0 refills it with the tile kStages ahead while the MMAs
//     run. Two block barriers a tile: operands formed, operands read.
//   * Warp w owns the 32 x 32 of the sub-block at rows 32 (w / 4), columns
//     32 (w % 4): 2 x 4 MMA tiles, 32 accumulators a thread, one chain
//     each (the 8 independent MMAs of a k step are the ILP). Fragments come
//     straight from the g-major operands: a = WT_s[k][m], b = PH_s[k][n].
//     Row stride panel + 4 (4 mod 16 doubles), so the 8-byte fragment loads
//     of a half warp (4 rows k x 4 columns) fall in distinct banks. MMA
//     tiles wholly past the panel's width are skipped.
//   * Each block writes its partial V, all nao x nao of it, to
//     part[block]; a second small kernel adds the partials in a fixed
//     order: kFoldGroups groups of consecutive blocks, each summed in block
//     order, then the group sums in order.
// No atomics: the result is bit-identical from run to run.
//
// The host side (ops/hopper_xc.py::vxc_plan) chooses the panel width, the
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
constexpr int kBK = 16;                  // grid points per tile (K of the GEMM)
constexpr int kMaxPanel = 128;           // 4 x 4 warps of 32 x 32
constexpr int kVSlot = kBK + 2;          // one potential's span, with its lead
constexpr int kFoldGroups = 8;
constexpr int kFoldThreads = 32 * kFoldGroups;
constexpr long kSmemLimit = 232448;  // opt-in shared memory of an H100 block
static_assert(kWarps == kBK, "warp r forms row r of a tile");

// Shared memory, in doubles: the operands WT_s, PH_s [kBK][row_stride],
// then the ring of stages, then one mbarrier (8 bytes) per stage.
__host__ __device__ inline int row_stride(int panel) { return panel + 4; }
// tables of a stage: phi, dphi_x, dphi_y, dphi_z of panel p, and phi of
// panel q when V has more than one panel (off the diagonal)
__host__ __device__ inline int stage_tables(int panels) {
  return panels == 1 ? 4 : 5;
}
// one table in a stage: one span of kBK rows (and its lead) with one panel,
// else kBK row segments of panel + 2 doubles each
__host__ __device__ inline long slot_doubles(int nao, int panel, int panels) {
  return panels == 1 ? (long)kBK * nao + 2 : (long)kBK * (panel + 2);
}
__host__ __device__ inline long stage_doubles(int nao, int panel,
                                              int panels) {
  return stage_tables(panels) * slot_doubles(nao, panel, panels) + 4 * kVSlot;
}
__host__ __device__ inline long smem_bytes_of(int nao, int panel, int panels,
                                              int stages) {
  return 8 * (2L * kBK * row_stride(panel) +
              stages * stage_doubles(nao, panel, panels)) +
         8L * stages;
}
// the panel width for nao: as many panels as 128 forces, as even as 16 allows
inline int panel_width(int nao) {
  const int n = (nao + kMaxPanel - 1) / kMaxPanel;
  return ((nao + n - 1) / n + 15) / 16 * 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
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

// the aligned span of count doubles at p: its start and its bytes
struct Span {
  const void* lo;
  uint32_t bytes;
};

__device__ __forceinline__ Span span_of(const double* p, long count) {
  const uintptr_t a = (uintptr_t)p;
  const uintptr_t lo = a & ~(uintptr_t)15;
  const uintptr_t hi = (a + (uintptr_t)count * sizeof(double) + 15) &
                       ~(uintptr_t)15;
  return {(const void*)lo, (uint32_t)(hi - lo)};
}

// where p lies in its aligned span: 0 or 1 double in
__device__ __forceinline__ int lead_of(const double* p) {
  return (int)(((uintptr_t)p >> 3) & 1);
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

// What a sub-block reads: table t of a stage is phi (t = 0), dphi_x,y,z
// (t = 1..3) at the columns of panel p, or phi at those of panel q (t = 4,
// off the diagonal only); then the potentials vrho, vgrad_x,y,z.
struct SubBlock {
  const double* ao;
  const double* ag;
  const double* vrho;
  const double* vgrad;
  int ng, nao, panel, p0, pw, q0, qw;
  bool one_panel, diag;
  long slot;

  __device__ __forceinline__ int tables() const { return diag ? 4 : 5; }
  // row g of table t at its panel's first column
  __device__ __forceinline__ const double* row(int t, int g) const {
    const double* base =
        t == 0 || t == 4 ? ao : ag + (size_t)(t - 1) * ng * nao;
    return base + (size_t)g * nao + (t == 4 ? q0 : p0);
  }
  __device__ __forceinline__ int width(int t) const {
    return t == 4 ? qw : pw;
  }
  __device__ __forceinline__ const double* pot(int c) const {
    return c == 0 ? vrho : vgrad + (size_t)(c - 1) * ng;
  }
  // where row r of table t lies in a stage in every tile: its copied
  // span starts on the row (several panels) or on the tile, 0 or 1 double
  // before it; tiles start at even rows, so that lead is the same for all
  __device__ __forceinline__ int at(int t, int r) const {
    return one_panel ? t * (int)slot + lead_of(row(t, 0)) + r * nao
                     : t * (int)slot + r * (panel + 2) + lead_of(row(t, r));
  }
  // where potential c of row r lies in a stage (after the tables)
  __device__ __forceinline__ int pot_at(int c, int r) const {
    return tables() * (int)slot + c * kVSlot + lead_of(pot(c)) + r;
  }
};

// The bulk copies of tile `tile` that lane `lane` of warp 0 makes into
// stage `stg`: with one panel lane t < 4 copies table t's span, else lane
// r copies row r of every table; lanes 16-19 copy the potentials.
// Calls f(dst, span) for each.
template <typename F>
__device__ __forceinline__ void lane_copies(double* stg, const SubBlock& sb,
                                            int tile, int lane, F f) {
  const int g0 = tile * kBK;
  const int rows = min(kBK, sb.ng - g0);
  const int nt = sb.tables();
  if (lane < kBK) {
    if (sb.one_panel) {
      if (lane < nt)
        f(stg + lane * sb.slot, span_of(sb.row(lane, g0), (long)rows * sb.nao));
    } else if (lane < rows) {
#pragma unroll
      for (int t = 0; t < 5; ++t)
        if (t < nt)
          f(stg + t * sb.slot + lane * (sb.panel + 2),
            span_of(sb.row(t, g0 + lane), sb.width(t)));
    }
  } else if (lane < kBK + 4) {
    const int c = lane - kBK;
    f(stg + nt * sb.slot + c * kVSlot, span_of(sb.pot(c) + g0, rows));
  }
}

// warp 0: the bulk copies of tile `tile` into stage `stg`, completing on
// `bar`; lane 0 registers the bytes of all of them before any is made.
__device__ __forceinline__ void issue_tile(double* stg, uint64_t* bar,
                                           const SubBlock& sb, int tile) {
  const int lane = threadIdx.x & 31;
  uint32_t bytes = 0;
  lane_copies(stg, sb, tile, lane,
              [&](double*, const Span& sp) { bytes += sp.bytes; });
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    bytes += __shfl_xor_sync(0xffffffffu, bytes, off);
  if (lane == 0) mbar_arrive_expect_tx(bar, bytes);
  __syncwarp();
  lane_copies(stg, sb, tile, lane, [&](double* dst, const Span& sp) {
    bulk_load(dst, sp.lo, sp.bytes, bar);
  });
}

template <int kStages, bool kBatched>
__global__ void __launch_bounds__(kThreads, 1)
ds_vxc_gga_kernel(const double* __restrict__ ao,
                  const double* __restrict__ ag,
                  const double* __restrict__ vrho,
                  const double* __restrict__ vgrad,
                  double* __restrict__ part, int ng, int nao, int panel,
                  long long ao_member, long long ag_member,
                  long long pot_member) {
  extern __shared__ __align__(128) double smem[];
  // this block's member: its tables, potentials and partials (a batch of
  // one takes the variant without the offsets, the unbatched kernel's code)
  if (kBatched) {
    const long long m = blockIdx.y;
    ao += m * ao_member;
    ag += m * ag_member;
    vrho += m * pot_member;
    vgrad += m * 3LL * pot_member;
    part += m * (long long)gridDim.x * nao * nao;
  }
  const int ss = row_stride(panel);
  const int npanel = (nao + panel - 1) / panel;
  const bool one_panel = npanel == 1;
  const long slot = slot_doubles(nao, panel, npanel);
  const long stage = stage_doubles(nao, panel, npanel);
  double* wt_s = smem;                     // [kBK][ss]
  double* ph_s = smem + kBK * ss;          // [kBK][ss]
  double* ring = smem + 2 * kBK * ss;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * stage);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2;               // groupID of the fragments
  const int tq = lane & 3;                // thread in the group
  const int m_w = 32 * (warp >> 2);       // this warp's rows i in the panel
  const int n_w = 32 * (warp & 3);        // ... and columns j
  const int ntiles = (ng + kBK - 1) / kBK;
  const int t_begin = (int)((long long)blockIdx.x * ntiles / gridDim.x);
  const int t_end = (int)((long long)(blockIdx.x + 1) * ntiles / gridDim.x);
  double* out = part + (size_t)blockIdx.x * nao * nao;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int k = 0;   // tiles taken so far: stage k % kStages, its use k / kStages
  for (int sb = 0; sb < npanel * npanel; ++sb) {
    const int p = sb / npanel, q = sb % npanel;
    const int p0 = p * panel, q0 = q * panel;
    const int pw = min(panel, nao - p0), qw = min(panel, nao - q0);
    const bool diag = p == q;
    const SubBlock sub{ao, ag, vrho, vgrad, ng, nao, panel, p0, pw,
                       q0, qw, one_panel, diag, slot};
    // warp r forms row r of every tile; where that row of each table and
    // each potential lies in a stage is the same for every tile (a tile
    // starts at an even point)
    const int r = warp;
    const int x0 = sub.at(0, r), x1 = sub.at(1, r), x2 = sub.at(2, r);
    const int x3 = sub.at(3, r), xq = diag ? x0 : sub.at(4, r);
    const int v0 = sub.pot_at(0, r), v1 = sub.pot_at(1, r);
    const int v2 = sub.pot_at(2, r), v3 = sub.pot_at(3, r);

    if (warp == 0)
      for (int st = 0; st < kStages; ++st)
        if (t_begin + st < t_end)
          issue_tile(ring + ((k + st) % kStages) * stage,
                     &full[(k + st) % kStages], sub, t_begin + st);

    double acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[mt][n8][x] = 0.0;
    // MMA tiles of this warp inside the sub-block (uniform in the warp)
    bool m_on[2], n_on[4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) m_on[mt] = m_w + 16 * mt < pw;
#pragma unroll
    for (int n8 = 0; n8 < 4; ++n8) n_on[n8] = n_w + 8 * n8 < qw;

    for (int tile = t_begin; tile < t_end; ++tile, ++k) {
      const int st = k % kStages;
      double* stg = ring + st * stage;
      mbar_wait(&full[st], (uint32_t)(k / kStages) & 1);   // tile landed
      __syncthreads();                    // the last tile's MMAs are done

      // the operands of this tile, zeros past ng and past the panels'
      // widths; lane l forms the columns l + 32 c of row r
      {
        const bool live = tile * kBK + r < ng;
        double* wrow = wt_s + r * ss;
        double* prow = ph_s + r * ss;
        for (int col = lane; col < panel; col += 32) {
          double w = 0.0, f = 0.0;
          if (live) {
            if (col < pw) {
              w = stg[v1] * stg[x1 + col];
              w = fma(stg[v2], stg[x2 + col], w);
              w = fma(stg[v3], stg[x3 + col], w);
              w = fma(stg[v0], stg[x0 + col], 2.0 * w);
            }
            if (col < qw) f = stg[xq + col];
          }
          wrow[col] = w;
          prow[col] = f;
        }
      }
      __syncthreads();                    // operands formed; stage free
      if (warp == 0 && tile + kStages < t_end) {
        // the reads of the stage above come before the copies into it
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue_tile(stg, &full[st], sub, tile + kStages);
      }

      const double* wa = wt_s + tq * ss + m_w + gq;        // WT_s[k][m]
      const double* pb = ph_s + tq * ss + n_w + gq;        // PH_s[k][n]
#pragma unroll
      for (int ks = 0; ks < kBK / 4; ++ks) {
        // a tile past the panel's width reads nothing (its columns may lie
        // past the operand)
        double a[2][2], b[4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          a[mt][0] = m_on[mt] ? wa[4 * ks * ss + 16 * mt] : 0.0;
          a[mt][1] = m_on[mt] ? wa[4 * ks * ss + 16 * mt + 8] : 0.0;
        }
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8)
          b[n8] = n_on[n8] ? pb[4 * ks * ss + 8 * n8] : 0.0;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int n8 = 0; n8 < 4; ++n8)
            if (m_on[mt] && n_on[n8])
              mma_f64(acc[mt][n8], a[mt][0], a[mt][1], b[n8]);
      }
    }

    // this block's partial of the sub-block: c0, c1 at row gq, columns
    // 2 tq, 2 tq + 1 of the MMA tile; c2, c3 at row gq + 8
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = m_w + 16 * mt + gq + 8 * h;
        if (i >= pw) continue;
        double* row = out + (size_t)(p0 + i) * nao + q0;
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8) {
          const int j = n_w + 8 * n8 + 2 * tq;
          if (j < qw) row[j] = acc[mt][n8][2 * h];
          if (j + 1 < qw) row[j + 1] = acc[mt][n8][2 * h + 1];
        }
      }
  }
}

// v[e] = the sum over blocks of part[block][e] in a fixed order: warp w of
// a block of the fold adds the blocks of group w in block order, then the
// group sums are added in group order. Lane l takes element 32 x + l.
__global__ void __launch_bounds__(kFoldThreads)
ds_vxc_fold(const double* __restrict__ part, double* __restrict__ v, int nn,
            int n_part) {
  constexpr int kBatch = 8;   // loads in flight before they are added
  __shared__ double sums[kFoldGroups][32];
  // member blockIdx.y: its n_part partials and its V
  part += (size_t)blockIdx.y * n_part * nn;
  v += (size_t)blockIdx.y * nn;
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  const int per = (n_part + kFoldGroups - 1) / kFoldGroups;
  const int c_end = min(n_part, (grp + 1) * per);
  double s = 0.0;
  if (e < nn) {
    for (int c0 = grp * per; c0 < c_end; c0 += kBatch) {
      double x[kBatch];
#pragma unroll
      for (int c = 0; c < kBatch; ++c)
        x[c] = c0 + c < c_end ? __ldg(part + (size_t)(c0 + c) * nn + e) : 0.0;
#pragma unroll
      for (int c = 0; c < kBatch; ++c)
        if (c0 + c < c_end) s += x[c];
    }
  }
  sums[grp][lane] = s;
  __syncthreads();
  if (grp == 0 && e < nn) {
    double t = sums[0][lane];
#pragma unroll
    for (int g = 1; g < kFoldGroups; ++g) t += sums[g][lane];
    v[e] = t;
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
  e = cudaFuncSetAttribute(ds_vxc_gga_kernel<kStages, kBatched>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes);
  if (e == cudaSuccess) granted[dev] = smem_bytes;
  return e;
}

template <int kStages, bool kBatched>
int launch(const double* ao, const double* ag, const double* vrho,
           const double* vgrad, double* v, double* part, int ng, int nao,
           int panel, int smem_bytes, int blocks, int batch,
           long long ao_member, long long ag_member, long long pot_member,
           cudaStream_t stream) {
  cudaError_t e = opt_in<kStages, kBatched>(smem_bytes);
  if (e != cudaSuccess) return (int)e;
  ds_vxc_gga_kernel<kStages, kBatched>
      <<<dim3((unsigned)blocks, (unsigned)batch), kThreads, smem_bytes,
         stream>>>(ao, ag, vrho, vgrad, part, ng, nao, panel, ao_member,
                   ag_member, pot_member);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nn = nao * nao;
  ds_vxc_fold<<<dim3((unsigned)((nn + 31) / 32), (unsigned)batch),
                kFoldThreads, 0, stream>>>(part, v, nn, blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 or a cudaError_t: of the launch that was refused, or
// cudaErrorInvalidValue for a plan that does not match this kernel.
// For each of the `batch` members m: ao + m ao_member (ng, nao), ag + m
// ag_member (3, ng, nao), vrho + m pot_member (ng), vgrad + 3 m pot_member
// (3, ng) (strides in doubles; each member contiguous), v (batch, nao,
// nao), part (batch, blocks, nao, nao) scratch; all float64 on the device
// of `stream`. The plan (tile_points, panel, stages, smem_bytes, blocks per
// member) comes from hopper_xc.vxc_plan(ng, nao, sms, batch): the panel
// width of panel_width(nao), three stages where they fit and else two, at
// most one block per tile.
extern "C" int ds_vxc_gga_launch(const void* ao, const void* ag,
                                 const void* vrho, const void* vgrad, void* v,
                                 void* part, int ng, int nao, int batch,
                                 long long ao_member, long long ag_member,
                                 long long pot_member, int tile_points,
                                 int panel, int stages, int smem_bytes,
                                 int blocks, void* stream) {
  if (ng <= 0 || nao <= 0 || tile_points != kBK ||
      panel != panel_width(nao) || blocks <= 0 ||
      blocks > (ng + kBK - 1) / kBK || batch <= 0 || batch > 65535 ||
      ao_member < 0 || ag_member < 0 || pot_member < 0)
    return (int)cudaErrorInvalidValue;
  const int npanel = (nao + panel - 1) / panel;
  const int fit = smem_bytes_of(nao, panel, npanel, 3) <= kSmemLimit ? 3 : 2;
  if (stages != fit ||
      smem_bytes != smem_bytes_of(nao, panel, npanel, stages) ||
      smem_bytes > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const double* a = (const double*)ao;
  const double* g = (const double*)ag;
  const double* r = (const double*)vrho;
  const double* d = (const double*)vgrad;
  cudaStream_t st = (cudaStream_t)stream;
  double* vo = (double*)v;
  double* pa = (double*)part;
  if (batch == 1)
    return stages == 3
               ? launch<3, false>(a, g, r, d, vo, pa, ng, nao, panel,
                                  smem_bytes, blocks, 1, 0, 0, 0, st)
               : launch<2, false>(a, g, r, d, vo, pa, ng, nao, panel,
                                  smem_bytes, blocks, 1, 0, 0, 0, st);
  return stages == 3
             ? launch<3, true>(a, g, r, d, vo, pa, ng, nao, panel,
                               smem_bytes, blocks, batch, ao_member,
                               ag_member, pot_member, st)
             : launch<2, true>(a, g, r, d, vo, pa, ng, nao, panel,
                               smem_bytes, blocks, batch, ao_member,
                               ag_member, pot_member, st);
}
