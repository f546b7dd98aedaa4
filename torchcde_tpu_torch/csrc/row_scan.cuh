// Scans across a row held in the registers of a power of two of threads,
// shared by the resident kernels of the natural cubic fit: K6/K7's
// resident_fit_kernel (masked_cubic.cu), K4's shared-band and per-row
// solves (tridiagonal.cu) and K5's gappy_kernel (masked_tridiagonal.cu).
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
//
// A row of k > CLUSTER_MAX * RES_MAX positions is segmented: S =
// ceil(k / RES_MAX) segments of seg positions (the same split), one block
// each as over a cluster, but a cluster cannot grow past CLUSTER_MAX
// portable blocks, so the segments' totals cross through device memory
// between launches.  K4's and K5's solves are a Moebius scan (the pivots)
// and two affine scans (the elimination, the substitution in reverse), in
// three launches (the kernels' RowMode):
//  - SEG_PIVOTS: each block publishes its segment's Moebius total;
//  - SEG_TOTALS: each block takes its pivots' carry-in from the totals
//    before its segment (seg_moebius_carry), then publishes its
//    elimination total and its substitution total as a ParamAffineOp: the
//    eliminated right-hand side is affine in the segment's unknown carry-in
//    p, so the substitution's maps are affine in x with a constant term
//    linear in p, and need not wait for a launch of their own;
//  - SEG_SOLVE: each block takes all three carry-ins (seg_affine_carries:
//    the elimination's value at each segment's start, the substitution's
//    totals after its segment with those values as their parameters) and
//    runs its segment as a cluster's block runs one.
// K6/K7's segmented fit runs the same three launches after one of its own
// (masked_cubic.cu).  Every launch reads the operands again and recomputes
// what the last one computed: a written and reread scratch of the
// eliminated diagonal and right-hand side would move more bytes than the
// operands it saves.  One
// warp walks the totals of a row in rank order (each lane loads one
// segment's, the walk reads them by shuffles), so the order is fixed and
// there are no atomics: two launches give the same bits.
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

// How a launch holds its rows: whole rows, RT / tpr a block (RESIDENT_ROWS);
// one segment of a row a block, over a cluster (CLUSTERED) or in one of a
// segmented row's three launches (SEG_*).
enum RowMode { RESIDENT_ROWS, CLUSTERED, SEG_PIVOTS, SEG_TOTALS, SEG_SOLVE };
__host__ __device__ constexpr bool segmented(int mode) { return mode >= SEG_PIVOTS; }

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

// x -> v[0] x + v[1] + v[2] p, p a parameter that no scan changes: a
// segmented row's substitution maps before the elimination's carry-in p of
// their segment is known.
struct ParamAffineOp {
  static __device__ __forceinline__ Vec<3> identity() { return {{1.f, 0.f, 0.f}}; }
  static __device__ __forceinline__ Vec<3> compose(const Vec<3>& f, const Vec<3>& s) {
    return {{s.v[0] * f.v[0], s.v[0] * f.v[1] + s.v[1], s.v[0] * f.v[2] + s.v[2]}};
  }
};

// A segmented row's split: S segments (CLUSTER_MAX < S) of seg positions
// each, the wrapper's plan; the launches check it.
__host__ __device__ inline bool segment_shape_ok(int k, int S, int seg) {
  return S > CLUSTER_MAX && seg % RP == 0 && seg <= RES_MAX && (long long)S * seg >= k &&
         (long long)(S - 1) * seg < k;
}

// The map that sends everything to v: a carry-in value as the map that
// full_scan's carry would be, so that compose(carry, excl) applies the
// block's exclusive scan to it.
__device__ __forceinline__ Vec<4> moebius_to(float v) { return {{0.f, v, 0.f, 1.f}}; }
__device__ __forceinline__ Vec<2> affine_to(float v) { return {{0.f, v}}; }

// A block's total in its scan's direction, written to dst by the thread
// that holds it (excl: its exclusive scan within the block, mine: its
// chunk's map).
template <class Op, bool REV, int N>
__device__ __forceinline__ void publish_total(const Vec<N>& excl, const Vec<N>& mine,
                                              float* dst) {
  if (threadIdx.x == (REV ? 0 : RT - 1)) {
    const Vec<N> total = Op::compose(excl, mine);
#pragma unroll
    for (int e = 0; e < N; ++e) dst[e] = total.v[e];
  }
}

// The value the eliminated diagonal reaches at the start of segment me of
// its row: 1 (the row's start, as the resident kernels apply their carry
// to 1) with the row's Moebius totals tm (4 floats a segment) of the
// segments before me applied in rank order.  Every lane of the calling
// warp returns it.
__device__ __forceinline__ float seg_moebius_carry(const float* tm, int me) {
  const int lane = threadIdx.x & 31;
  float v = 1.f;
  for (int q0 = 0; q0 < me; q0 += 32) {
    Vec<4> t = MoebiusOp::identity();
    if (q0 + lane < me) {
#pragma unroll
      for (int e = 0; e < 4; ++e) t.v[e] = tm[4 * (q0 + lane) + e];
    }
    const int count = min(32, me - q0);
    for (int i = 0; i < count; ++i) {
      const float a = __shfl_sync(0xffffffffu, t.v[0], i), b = __shfl_sync(0xffffffffu, t.v[1], i);
      const float c = __shfl_sync(0xffffffffu, t.v[2], i), d = __shfl_sync(0xffffffffu, t.v[3], i);
      v = (a * v + b) / (c * v + d);
    }
  }
  return v;
}

// The elimination's value at the start of segment me (0 at the row's
// start, then the row's elimination totals te, 2 floats a segment, in rank
// order) and the substitution's after its end: the substitution totals ts
// (3 floats a segment, ParamAffineOp) of the later segments, each with the
// elimination's value at its own start as its parameter, applied from x = 0
// past the row's end; composed in rank order, each later total before the
// composition so far.  Every lane of the calling warp returns them.
__device__ __forceinline__ float2 seg_affine_carries(const float* te, const float* ts, int S,
                                                     int me) {
  const int lane = threadIdx.x & 31;
  float nb = 0.f, nb_me = 0.f;
  Vec<2> after = AffineOp::identity();
  for (int q0 = 0; q0 < S; q0 += 32) {
    Vec<2> e = AffineOp::identity();
    Vec<3> s = ParamAffineOp::identity();
    if (q0 + lane < S) {
      e.v[0] = te[2 * (q0 + lane)], e.v[1] = te[2 * (q0 + lane) + 1];
#pragma unroll
      for (int i = 0; i < 3; ++i) s.v[i] = ts[3 * (q0 + lane) + i];
    }
    const int count = min(32, S - q0);
    for (int i = 0; i < count; ++i) {
      const int q = q0 + i;
      const float e0 = __shfl_sync(0xffffffffu, e.v[0], i);
      const float e1 = __shfl_sync(0xffffffffu, e.v[1], i);
      const float s0 = __shfl_sync(0xffffffffu, s.v[0], i);
      const float s1 = __shfl_sync(0xffffffffu, s.v[1], i);
      const float s2 = __shfl_sync(0xffffffffu, s.v[2], i);
      if (q == me) nb_me = nb;
      if (q > me) after = AffineOp::compose({{s0, s1 + s2 * nb}}, after);
      nb = e0 * nb + e1;
    }
  }
  return make_float2(nb_me, after.v[1]);
}

// Where a segmented launch's block finds its row's totals in the one
// buffer that holds, S segments each, the Moebius totals (4 floats a
// segment) of every row, or of the one band where the pivots are shared,
// then the elimination totals (2) and the substitution totals (3) of all n
// rows; and its segment me.
struct SegTotals {
  float* tm;
  float* te;
  float* ts;
  int S, me;
};

__device__ __forceinline__ SegTotals seg_totals(float* totals, long long n, bool shared_pivots,
                                                int k, int seg, const RowPart& p) {
  SegTotals t;
  t.S = (k + seg - 1) / seg;
  t.me = p.seg0 / seg;
  const size_t S = t.S, row = p.row0, pivot_rows = shared_pivots ? 1 : n;
  t.tm = totals + (shared_pivots ? 0 : row) * S * 4;
  t.te = totals + pivot_rows * S * 4 + row * S * 2;
  t.ts = totals + (pivot_rows * 4 + (size_t)n * 2) * S + row * S * 3;
  return t;
}

// A segmented launch's carry-ins, as far as MODE needs them, into slot[0]
// (the eliminated diagonal's, where the row has its own pivots), slot[1]
// (the elimination's) and slot[2] (the substitution's): warp 0 computes
// them while the other warps stage; a barrier must pass before they are
// read.
template <int MODE>
__device__ __forceinline__ void seg_carry_ins(const SegTotals& t, bool own_pivots, float* slot) {
  if (MODE == SEG_PIVOTS || threadIdx.x >= 32) return;
  const float nd = own_pivots ? seg_moebius_carry(t.tm, t.me) : 1.f;
  const float2 c =
      MODE == SEG_SOLVE ? seg_affine_carries(t.te, t.ts, t.S, t.me) : make_float2(0.f, 0.f);
  if (threadIdx.x == 0) slot[0] = nd, slot[1] = c.x, slot[2] = c.y;
}

// The end of a SEG_TOTALS launch, for K4's and K5's kernels alike: the
// segment's elimination total (aff: the thread's chunk's elimination map),
// then its substitution total, the substitution's maps with nb as
// nb0 + sens p, p the segment's carry-in, composed in ascending order, each
// before the ones after it (as the reverse scan composes them).  ready()
// runs once the elimination total is out, before the first term: where a
// kernel takes in the substitution's operands (K4's shared bands load r
// and c, K5 waits for hr), so that they are not live across the scan;
// term(s, w, b, r, c)
// gives position s of the thread's chunk, false where it holds none: the
// elimination nb_s = b - w nb_{s-1} and the substitution
// x_s = r nb_s - c x_{s+1}.
template <class Ready, class Term>
__device__ __forceinline__ void publish_segment_totals(const Vec<2>& aff, int tpr, float* scratch,
                                                       const SegTotals& tot, Ready ready,
                                                       Term term) {
  const Vec<2> excl = row_scan<AffineOp, false>(aff, tpr, scratch);
  publish_total<AffineOp, false>(excl, aff, tot.te + 2 * tot.me);
  ready();
  float nb0 = excl.v[1], sens = excl.v[0];
  Vec<3> sub = ParamAffineOp::identity();
#pragma unroll
  for (int s = 0; s < RP; ++s) {
    float w, b, r, c;
    if (term(s, w, b, r, c)) {
      nb0 = b - w * nb0;
      sens = -w * sens;
      sub = ParamAffineOp::compose({{-c, r * nb0, r * sens}}, sub);
    }
  }
  publish_total<ParamAffineOp, true>(row_scan<ParamAffineOp, true>(sub, tpr, scratch), sub,
                                     tot.ts + 3 * tot.me);
}

// The exclusive scan across a row in a launch of this mode: full_scan for
// whole rows and clusters (slot: this exchange's); in a segmented launch,
// the block's own scan after carry, the segment's carry-in (moebius_to,
// affine_to).
template <class Op, bool REV, int MODE, int N>
__device__ __forceinline__ Vec<N> mode_scan(const Vec<N>& mine, int tpr, float* scratch,
                                            float* slot, const Vec<N>& carry) {
  if constexpr (segmented(MODE)) {
    return Op::compose(carry, row_scan<Op, REV>(mine, tpr, scratch));
  } else {
    return full_scan<Op, REV, MODE == CLUSTERED>(mine, tpr, scratch, slot);
  }
}

// The blocks of a launch over n rows of k positions: tpr threads a row, a
// power of two with tpr * RP >= k, k <= RES_MAX (cs 1); or one block for
// each of a row's cs segments of seg positions, tpr = RT, over a cluster
// (cluster_shape_ok) or segmented (segment_shape_ok).  -1 for a shape no
// kernel takes.
inline long long row_blocks(long long n, int k, int tpr, int cs, int seg) {
  if (n <= 0 || k <= 0) return -1;
  long long blocks;
  if (cs == 1) {
    if (k > RES_MAX || tpr < 1 || tpr > RT || (tpr & (tpr - 1)) || (long long)tpr * RP < k)
      return -1;
    blocks = (n + RT / tpr - 1) / (RT / tpr);
  } else {
    if (!(cluster_shape_ok(k, cs, seg) || segment_shape_ok(k, cs, seg)) || tpr != RT) return -1;
    blocks = n * cs;
  }
  return blocks > 0x7fffffffLL ? -1 : blocks;
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

// One launch of a kernel of RT-thread blocks that holds its rows as MODE
// says (in clusters of cs blocks where CLUSTERED), smem bytes of dynamic
// shared memory each.
template <int MODE, typename... Params, typename... Args>
cudaError_t launch_rows_as(void (*kernel)(Params...), long long blocks, int cs, size_t smem,
                           cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if constexpr (MODE == CLUSTERED) {
    err = launch_clusters(kernel, blocks, cs, smem, stream, args...);
    if (err != cudaSuccess) return err;
  } else {
    kernel<<<(unsigned)blocks, RT, smem, stream>>>(args...);
  }
  return cudaGetLastError();
}

}  // namespace
