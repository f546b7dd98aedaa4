// Scans across a row held in the registers of a power of two of threads,
// shared by the resident kernels of the natural cubic fit: K6/K7's
// resident_fit_kernel (masked_cubic.cu), K4's shared-band and per-row
// solves (tridiagonal.cu) and K5's resident_gappy_kernel
// (masked_tridiagonal.cu).
//
// A row of k <= RES_MAX positions belongs to threads_per_row (tpr)
// consecutive threads of a block of RT, tpr the least power of two with
// tpr * RP >= k, each thread holding RP consecutive positions in registers;
// RT / tpr rows share a block.  A sequential recurrence along the row
// becomes a chunk-local pass joined by an exclusive scan of the chunks'
// composed operators across the row's threads (row_scan): warp shuffles,
// then, for rows of more than one warp, one pass over the warps' totals in
// shared memory, in order.  Every scan runs in a fixed order without
// atomics, so two launches give the same bits.  A block stages its rows
// through shared memory with coalesced accesses, a float of padding after
// every RP (staged), so that a warp's reads of its chunks fall in distinct
// banks.
//
// A row of RES_MAX < k <= CLUSTER_MAX * RES_MAX positions spans a thread
// block cluster of cs = ceil(k / RES_MAX) blocks (cluster_shape): block
// rank r of the cluster holds the segment [r seg, (r + 1) seg) of the row,
// seg = ceil(k / cs) rounded up to RP, in all its RT threads as a resident
// block holds a row of RES_MAX.  The scans gain a third level
// (cluster_scan): each block publishes its segment's total operator in a
// slot of its shared memory, a cluster barrier, and every block composes
// the totals of the segments before its own (after it, for a suffix scan)
// in rank order, read through distributed shared memory.  Each exchange
// has its own slot, so one barrier serves it; a last barrier keeps every
// block resident until the others' reads of its slots are done.  The order
// is fixed and there are no atomics here either.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int RP = 16;                      // positions a thread holds
constexpr int RT = 256;                     // threads per block
constexpr int RES_MAX = RP * RT;            // longest resident row
constexpr int RES_BUF = RES_MAX / RP * (RP + 1);  // staging floats: a pad after every RP
constexpr int SCAN_SLOT = 8;                // floats per warp total in the scan scratch
constexpr int CLUSTER_MAX = 8;              // blocks a row spans at most (the portable cluster)
constexpr int CLUSTER_SLOTS = 8;            // exchanges a cluster kernel makes at most

// Staging index of element i of the block's range: a pad after every RP.
__device__ __forceinline__ int staged(int i) { return i + i / RP; }

template <int N>
struct Vec {
  float v[N];
};

template <int N>
__device__ __forceinline__ Vec<N> shfl_up(const Vec<N>& a, int d, int width) {
  Vec<N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = __shfl_up_sync(0xffffffffu, a.v[i], d, width);
  return r;
}

template <int N>
__device__ __forceinline__ Vec<N> shfl_down(const Vec<N>& a, int d, int width) {
  Vec<N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = __shfl_down_sync(0xffffffffu, a.v[i], d, width);
  return r;
}

// The scans' operators: compose(first, second) is first, then second in
// the scan's direction; identity() composes to no change.

// x -> v[0] x + v[1].
struct AffineOp {
  static __device__ __forceinline__ Vec<2> identity() { return {{1.f, 0.f}}; }
  static __device__ __forceinline__ Vec<2> compose(const Vec<2>& f, const Vec<2>& s) {
    return {{s.v[0] * f.v[0], s.v[0] * f.v[1] + s.v[1]}};
  }
};

// The Moebius map d -> (v[0] d + v[1]) / (v[2] d + v[3]) as a 2 x 2 matrix,
// products divided by the power of two at or below their largest entry (an
// exact scaling, by the exponent bits: the largest entry lands in [1, 2)).
struct MoebiusOp {
  static __device__ __forceinline__ Vec<4> identity() { return {{1.f, 0.f, 0.f, 1.f}}; }
  static __device__ __forceinline__ Vec<4> compose(const Vec<4>& f, const Vec<4>& s) {
    Vec<4> m = {{s.v[0] * f.v[0] + s.v[1] * f.v[2], s.v[0] * f.v[1] + s.v[1] * f.v[3],
                 s.v[2] * f.v[0] + s.v[3] * f.v[2], s.v[2] * f.v[1] + s.v[3] * f.v[3]}};
    const float big = fmaxf(fmaxf(fabsf(m.v[0]), fabsf(m.v[1])),
                            fmaxf(fabsf(m.v[2]), fabsf(m.v[3])));
    const int e = (__float_as_int(big) >> 23) & 0xff;  // biased exponent
    if (e > 0 && e < 254) {  // normal and finite: scale by 2^(127 - e)
      const float scale = __int_as_float((254 - e) << 23);
#pragma unroll
      for (int i = 0; i < 4; ++i) m.v[i] *= scale;
    }
    return m;
  }
};

// The composition of the row's chunks before this thread's in the scan's
// direction (after it when REV), this thread's chunk element being mine:
// an exclusive scan over the row's tpr threads, by shuffles within a warp
// and, for rows of several warps, over the warps' totals in order.  Every
// thread of the block calls it (tpr is the same for all).
template <class Op, bool REV, int N>
__device__ __forceinline__ Vec<N> row_scan(const Vec<N>& mine, int tpr, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int width = tpr < 32 ? tpr : 32;
  const int li = lane & (width - 1);
  Vec<N> incl = mine;
  for (int d = 1; d < width; d <<= 1) {
    const Vec<N> o = REV ? shfl_down(incl, d, width) : shfl_up(incl, d, width);
    if (REV ? li + d < width : li >= d) incl = Op::compose(o, incl);
  }
  const Vec<N> prev = REV ? shfl_down(incl, 1, width) : shfl_up(incl, 1, width);
  Vec<N> excl = (REV ? li + 1 < width : li >= 1) ? prev : Op::identity();
  if (tpr > 32) {
    if (lane == (REV ? 0 : 31)) {
#pragma unroll
      for (int i = 0; i < N; ++i) scratch[warp * SCAN_SLOT + i] = incl.v[i];
    }
    __syncthreads();
    const int wpr = tpr >> 5, wr = warp & (wpr - 1), first = warp - wr;
    Vec<N> carry = Op::identity();
    for (int i = 0; i < wpr; ++i) {
      const int w = REV ? wpr - 1 - i : i;
      if (REV ? w <= wr : w >= wr) break;
      Vec<N> total;
#pragma unroll
      for (int e = 0; e < N; ++e) total.v[e] = scratch[(first + w) * SCAN_SLOT + e];
      carry = Op::compose(carry, total);
    }
    excl = Op::compose(carry, excl);
    __syncthreads();
  }
  return excl;
}

// The part of the rows that a block holds: RT / tpr whole rows (the
// resident kernels), or one segment of one row (a cluster's block; tpr =
// RT).  Block b of a cluster launch is rank b % cs of row b / cs's cluster.
struct RowPart {
  long long row0;  // the block's first row
  int rows;        // rows it holds
  int rb;          // the thread's row among them
  bool live;       // that row exists
  int seg0;        // the position where the block's part of a row starts
  int len;         // positions of a row the block holds
  int j0;          // the thread's first position in its part
};

template <bool CLUSTER>
__device__ __forceinline__ RowPart row_part(long long n, int k, int tpr, int seg) {
  RowPart p;
  const int tid = threadIdx.x;
  if (CLUSTER) {
    const int cs = (k + seg - 1) / seg;
    p.row0 = blockIdx.x / cs;
    p.rows = 1;
    p.rb = 0;
    p.live = true;
    p.seg0 = (int)(blockIdx.x % cs) * seg;
    p.len = min(seg, k - p.seg0);
    p.j0 = tid * RP;
  } else {
    const int rpb = RT / tpr;
    p.row0 = (long long)blockIdx.x * rpb;
    p.rows = (int)(n - p.row0 < rpb ? n - p.row0 : rpb);
    p.rb = tid / tpr;
    p.live = p.rb < p.rows;
    p.seg0 = 0;
    p.len = k;
    p.j0 = (tid % tpr) * RP;
  }
  return p;
}

// Waits until every block of the cluster is done reading the others'
// slots: the last step of a cluster kernel.
__device__ __forceinline__ void cluster_done() { cooperative_groups::this_cluster().sync(); }

// The segment of a row that each block of its cluster holds: cs blocks
// (1 <= cs <= CLUSTER_MAX) and seg positions each, the wrapper's plan; the
// kernels check it.
__host__ __device__ inline bool cluster_shape_ok(int k, int cs, int seg) {
  return cs >= 2 && cs <= CLUSTER_MAX && seg % RP == 0 && seg <= RES_MAX &&
         (long long)cs * seg >= k && (long long)(cs - 1) * seg < k;
}

// The composition of the cluster's segments before this block's (after it
// when REV) with excl, this thread's exclusive scan within its block
// (row_scan over all RT threads, tpr = RT), and mine, its chunk's operator:
// the thread's exclusive scan over the whole row.  slot: SCAN_SLOT floats of
// this block's shared memory, for this exchange only.  Every thread of the
// cluster calls it.
template <class Op, bool REV, int N>
__device__ __forceinline__ Vec<N> cluster_scan(const Vec<N>& excl, const Vec<N>& mine,
                                               float* slot) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == (REV ? 0 : RT - 1)) {  // the block's total, in the scan's direction
    const Vec<N> total = Op::compose(excl, mine);
#pragma unroll
    for (int e = 0; e < N; ++e) slot[e] = total.v[e];
  }
  cluster.sync();
  const int rank = (int)cluster.block_rank(), size = (int)cluster.dim_blocks().x;
  Vec<N> carry = Op::identity();
  for (int i = 0; i < size; ++i) {
    const int q = REV ? size - 1 - i : i;
    if (REV ? q <= rank : q >= rank) break;
    const float* remote = cluster.map_shared_rank(slot, q);
    Vec<N> total;
#pragma unroll
    for (int e = 0; e < N; ++e) total.v[e] = remote[e];
    carry = Op::compose(carry, total);
  }
  return Op::compose(carry, excl);
}

// The exclusive scan across a row: within its block (row_scan), then, for a
// row spanning a cluster, across the cluster's blocks (cluster_scan, with
// this exchange's slot).
template <class Op, bool REV, bool CLUSTER, int N>
__device__ __forceinline__ Vec<N> full_scan(const Vec<N>& mine, int tpr, float* scratch,
                                            float* slot) {
  const Vec<N> excl = row_scan<Op, REV>(mine, tpr, scratch);
  if constexpr (CLUSTER) {
    return cluster_scan<Op, REV>(excl, mine, slot);
  } else {
    return excl;
  }
}

// Launches a kernel of RT-thread blocks in clusters of cs blocks.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), long long blocks, int cs, size_t smem,
                            cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)blocks, 1, 1);
  config.blockDim = dim3(RT, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = (unsigned)cs;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

}  // namespace
