// The whole NaN-masked natural cubic spline fit (K6 and K7), as CUDA
// kernels for Hopper (sm_90a).
//
// Replaces torchcde_tpu/ops/masked_cubic_pallas.py (the streaming kernels
// _prep_kernel / _prep_kernel_bm, _assemble_fwd_kernel, _subst_kernel,
// _rebase_kernel, entries masked_natural_cubic_full and
// masked_natural_cubic_pallas) and ops/masked_cubic_resident.py
// (_resident_kernel, entry masked_natural_cubic_resident).  The TPU split
// between the streaming and the resident kernel follows VMEM's size; here
// one kernel serves all three entries, holding its rows in one of the ways
// below.  From raw values x (n, k) with NaNs and the times t (k) it computes
// the coefficients (a, b, two_c, three_d), each (n, k - 1), of
// interpolation/cubic.py's masked pipeline applied to the
// endpoint-imputed values (version 0: a missing first or last entry takes
// the nearest observation; version 1: the values before the first and after
// the last observation do).  Rows without any observation come out as
// zeros; the caller masks them as the JAX package does.
//
// What bounds it.  The function reads x once and writes four coefficient
// arrays: at 8192 x 4096 float32, 671 MB, 0.20 ms at 3.35 TB/s; ~40 flops
// per position (1.3 GFLOP in all) are nothing.  The five phases are
// sequential recurrences along each row, two of them in reverse, and pass
// per-row intermediates between them (the reference recurrences,
// torchcde_tpu/interpolation/cubic.py:_masked_coeffs_xla after
// _impute_endpoints):
//  0. the first and last observed positions;
//  1. reverse: endpoint imputation, the next-observed (value, time) carry,
//     and the interval quantities hr = 1 / h, sph = 6 dx hr, pds = sph hr / 2
//     (zero where no later observation follows);
//  2. forward: the previous-observed (hr, pds) carry, the diagonal and
//     right-hand side, and the gappy Thomas forward elimination;
//  3. reverse: back substitution with the spline algebra, kd at the next
//     observed knot being the substitution's carry;
//  4. forward: the last-observed polynomial carry, re-based onto every grid
//     interval.
//
// One kernel, resident_fit_kernel, in the three ways of holding a row of
// row_scan.cuh's RowMode; the wrapper's fit_plan picks one from k.
//
// Rows of k <= RES_MAX (RESIDENT_ROWS): each row stays on chip from x to
// the outputs, so x is read once and the four outputs written once.  A row
// belongs to a power of two of threads (threads_per_row, as few as hold it
// at RP = 16 positions a thread; short rows share a block of RT = 256
// threads), and each thread holds RP consecutive positions in registers
// through all five phases.  Every phase becomes a chunk-local recurrence
// joined by a scan across the row's threads, as the TPU kernels run them
// (masked_cubic_pallas.py:16-27, :227-330): each thread composes its
// chunk's operator, the operators are scanned across the row (warp shuffles,
// then, for rows of more than one warp, one pass over the warps' totals in
// shared memory, in order), and each thread runs its chunk from its
// carry-in with the reference arithmetic:
//  0. a min/max reduction;
//  1. a select-carry suffix scan (the next observation's value and time);
//  2. a select-carry scan (the previous observation's hr, pds); the
//     diagonal by a scan of its Moebius maps d -> dg - hp^2 / d as 2 x 2
//     matrices, each product divided by the power of two at or below its
//     largest entry (the map is unchanged, and a float32 product over a long
//     observed run would overflow; _rescale2, masked_cubic_pallas.py:209);
//     the right-hand side by an affine scan; unobserved positions are the
//     identity;
//  3. an affine suffix scan of kd in kd at the next observed knot;
//  4. a select-carry scan of the last observed knot's polynomial.
// x is staged through shared memory with coalesced loads (rows start at
// row * k, outputs at row * (k - 1): not 16-byte aligned for most k): the
// block's rows are one contiguous range of x, staged as they lie, with a
// float of padding after every RP, so that a warp's reads of its chunks fall
// in distinct banks; each output leaves the same way, laid out as in its
// own array (rows k - 1 apart).  Every scan runs in a
// fixed order without atomics: two launches give the same bits.
//
// Rows of RES_MAX < k <= CLUSTER_MAX * RES_MAX (CLUSTERED): the same kernel
// over a thread block cluster a row (row_scan.cuh: cluster_shape_ok,
// cluster_scan).  Each of the cluster's cs = ceil(k / RES_MAX) blocks holds
// one segment of the row in its RT threads as a resident block holds a row,
// and each of the five phases' scans gains the cluster level: the blocks'
// totals composed in rank order through distributed shared memory, one
// exchange each (the span, the next observation, the previous observation,
// the diagonal, the right-hand side, the substitution, the polynomial), so
// the row stays on chip from x to the four outputs.  The values at the
// first and last observed positions come from x in device memory.
//
// Longer rows (segmented): the same segments, S = ceil(k / RES_MAX) of them
// (S > CLUSTER_MAX), one block each, in four launches whose totals cross
// through a small (n, S, 11) buffer in device memory (fit_spans, then
// row_scan.cuh's seg_totals).  Four of the seven exchanges (the span, the
// next and the previous observation, the polynomial) follow from where a
// row's observations lie: the first launch publishes each segment's first
// and last observed positions, and each later block walks them
// (seg_fit_walk).  The other three (the diagonal, the right-hand side, the
// substitution) are K5's segmented solve (masked_tridiagonal.cu), whose
// algebra phases 2 and 3 share:
//  - span_fit_kernel: each segment's first and last observed positions of
//    x, read from each end until a value is not NaN;
//  - SEG_PIVOTS: each block walks the spans (the row's first and last
//    observed positions, v_first and v_last from x in device memory, the
//    first observation after its segment and the last before it, with its
//    hr and pds), runs phases 0-2 up to the diagonal's Moebius total and
//    publishes it;
//  - SEG_TOTALS: the same, then, from the diagonal's carry-in
//    (seg_moebius_carry), the elimination's total and the substitution's,
//    affine in the elimination's carry-in (publish_segment_totals);
//  - SEG_SOLVE: the same with every carry-in (seg_affine_carries), then
//    phases 3 and 4 and the four outputs.  The polynomial's carry-in is that
//    of the last observed knot j' before the segment: nd(j') and nb(j') are
//    the diagonal's and the elimination's carry-ins, hr(j'), sph(j'), x(j')
//    and t(j') come from the walk, and kd at the next observed knot is the
//    one that the block's first thread reaches in phase 3.
// Every launch reads x again: 3 x 4 + 16 bytes a position against the
// function's 20.  The order is fixed and there are no atomics here either.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row_scan.cuh"

namespace {

constexpr int BAD_ARGUMENT = -2;
constexpr int NO_SPAN = 0x7fffffff;  // a segment's first observed position where it has none

constexpr size_t RES_SMEM = sizeof(float) * (2 * RES_BUF + RT / 32 * SCAN_SLOT);
constexpr size_t CLUSTER_SMEM = RES_SMEM + sizeof(float) * CLUSTER_SLOTS * SCAN_SLOT;
constexpr float NO_POSITION = 1e30f;        // phase 0's identity for the first position

// Select-carry: v[0] != 0 marks a present value; the later one wins.
template <int N>
struct SelectOp {
  static __device__ __forceinline__ Vec<N> identity() {
    Vec<N> r;
#pragma unroll
    for (int i = 0; i < N; ++i) r.v[i] = 0.f;
    return r;
  }
  static __device__ __forceinline__ Vec<N> compose(const Vec<N>& f, const Vec<N>& s) {
    return s.v[0] != 0.f ? s : f;
  }
};

// First and last observed positions (as floats, exact below 2^24).
struct SpanOp {
  static __device__ __forceinline__ Vec<2> identity() { return {{NO_POSITION, -1.f}}; }
  static __device__ __forceinline__ Vec<2> compose(const Vec<2>& f, const Vec<2>& s) {
    return {{fminf(f.v[0], s.v[0]), fmaxf(f.v[1], s.v[1])}};
  }
};

// The row's first and last observed positions in every thread of the row.
__device__ __forceinline__ Vec<2> row_span(Vec<2> v, int tpr, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int width = tpr < 32 ? tpr : 32;
  for (int m = 1; m < width; m <<= 1) {
    Vec<2> o;
    o.v[0] = __shfl_xor_sync(0xffffffffu, v.v[0], m, width);
    o.v[1] = __shfl_xor_sync(0xffffffffu, v.v[1], m, width);
    v = SpanOp::compose(v, o);
  }
  if (tpr > 32) {
    if (lane == 0) {
      scratch[warp * SCAN_SLOT] = v.v[0];
      scratch[warp * SCAN_SLOT + 1] = v.v[1];
    }
    __syncthreads();
    const int wpr = tpr >> 5, first = warp - (warp & (wpr - 1));
    v = SpanOp::identity();
    for (int w = 0; w < wpr; ++w)
      v = SpanOp::compose(v, {{scratch[(first + w) * SCAN_SLOT],
                               scratch[(first + w) * SCAN_SLOT + 1]}});
    __syncthreads();
  }
  return v;
}

// The span over the cluster's blocks, each holding its segment's in every
// thread (row_span), in rank order.
__device__ __forceinline__ Vec<2> cluster_span(Vec<2> v, float* slot) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) {
    slot[0] = v.v[0];
    slot[1] = v.v[1];
  }
  cluster.sync();
  v = SpanOp::identity();
  for (int q = 0; q < (int)cluster.dim_blocks().x; ++q) {
    const float* remote = cluster.map_shared_rank(slot, q);
    v = SpanOp::compose(v, {{remote[0], remote[1]}});
  }
  return v;
}

// ---------------------------------------------------------------------------
// What the segmented launches add.

// A segmented fit's spans, ahead of row_scan.cuh's totals in its buffer:
// each segment's first and last observed positions of x (NO_SPAN and -1
// where it has none), 2 ints a segment of every row.
__device__ __forceinline__ int* fit_spans(float* totals, long long row, int S) {
  return reinterpret_cast<int*>(totals) + (size_t)row * S * 2;
}

// The walk's results in a block's shared memory (floats, positions as int
// bits), written by seg_fit_walk before the block's first barrier.
enum Walk {
  W_FIRST, W_LAST, W_VFIRST, W_VLAST,  // the row's first and last observed positions and values
  W_NEXT, W_NEXT_X, W_NEXT_T,          // phase 1's carry-in: the next observation after the segment
  W_PREV, W_PREV_X, W_PREV_T,          // the last observed knot j' before it (W_PREV 1, else 0)
  W_PREV_HR, W_PREV_SPH, W_PREV_PDS,   // and its interval quantities
  WALK_FLOATS
};

// The first launch of a segmented fit: the first and last observed
// positions of x in each block's segment, read from each end, RT positions
// at a time, until a value is not NaN (a segment without one is read once).
__global__ void __launch_bounds__(RT)
    span_fit_kernel(const float* __restrict__ x, float* __restrict__ totals, long long n, int k,
                    int seg) {
  __shared__ int found[RT / 32];
  const RowPart p = row_part<true>(n, k, RT, seg);
  const float* xs = x + p.row0 * k + p.seg0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // The least thread of the block whose value is observed (RT for none).
  auto least = [&](bool o) {
    const unsigned w = __ballot_sync(0xffffffffu, o);
    if (lane == 0) found[warp] = w ? warp * 32 + __ffs(w) - 1 : RT;
    __syncthreads();
    int m = RT;
#pragma unroll
    for (int q = 0; q < RT / 32; ++q) m = min(m, found[q]);
    __syncthreads();
    return m;
  };
  int first = NO_SPAN, last = -1;
  for (int i0 = 0; i0 < p.len && first == NO_SPAN; i0 += RT) {
    const int m = least(i0 + tid < p.len && !isnan(xs[i0 + tid]));
    if (m < RT) first = p.seg0 + i0 + m;
  }
  for (int i0 = p.len - 1; first != NO_SPAN && last < 0; i0 -= RT) {
    const int m = least(i0 - tid >= 0 && !isnan(xs[i0 - tid]));
    if (m < RT) last = p.seg0 + i0 - m;
  }
  if (tid == 0) {
    int* span = fit_spans(totals, p.row0, (k + seg - 1) / seg) + 2 * (p.seg0 / seg);
    span[0] = first;
    span[1] = last;
  }
}

// The walk of a segmented launch's block over its row's spans (S segments,
// its own me, its positions [seg0, end)): every lane of warp 0 reduces them
// (min and max: the order does not matter), and lane 0 reads the few values
// of x and t it needs and writes the Walk into out.  Positions after
// imputation: version 1 observes every position before the row's first
// observation and after its last, version 0 positions 0 and k - 1, where
// the row has any observation.
__device__ __forceinline__ void seg_fit_walk(const float* __restrict__ x,
                                             const float* __restrict__ t, const int* spans,
                                             int S, int me, long long row, int k, int seg0,
                                             int end, int version, float* out) {
  const int lane = threadIdx.x & 31;
  int first = NO_SPAN, last = -1, first_after = NO_SPAN, first_from = NO_SPAN, last_before = -1;
  for (int q = lane; q < S; q += 32) {
    const int f = spans[2 * q], l = spans[2 * q + 1];
    first = min(first, f);
    last = max(last, l);
    if (q > me) first_after = min(first_after, f);
    if (q >= me) first_from = min(first_from, f);
    if (q < me) last_before = max(last_before, l);
  }
  first = __reduce_min_sync(0xffffffffu, first);
  last = __reduce_max_sync(0xffffffffu, last);
  first_after = __reduce_min_sync(0xffffffffu, first_after);
  first_from = __reduce_min_sync(0xffffffffu, first_from);
  last_before = __reduce_max_sync(0xffffffffu, last_before);
  if (lane != 0) return;
  const bool any = first != NO_SPAN;
  if (!any) first = 0, last = k - 1;  // argmax semantics: NaN values, which impute nothing
  const float* xr = x + row * k;
  const float v_first = xr[first], v_last = xr[last];
  auto value = [&](int j) {  // x at an observed position, after imputation
    const float v = xr[j];
    if (!isnan(v)) return v;
    if (version == 0) return j == 0 ? v_first : v_last;
    return j < first ? v_first : v_last;
  };
  // The first observed position at or after s (raw: the least raw one
  // there), and the last before s (raw: the greatest raw one); -1 for none.
  auto next_at = [&](int s, int raw) {
    if (!any || s >= k) return -1;
    if (version == 0) return s == 0 ? 0 : raw != NO_SPAN ? raw : k - 1;
    return s < first || s > last ? s : raw;
  };
  auto prev_before = [&](int s, int raw) {
    if (!any || s <= 0) return -1;
    if (version == 0) return raw >= 0 ? raw : 0;
    return s - 1 < first || s - 1 > last ? s - 1 : raw;
  };
  float w[WALK_FLOATS] = {};
  w[W_FIRST] = __int_as_float(first);
  w[W_LAST] = __int_as_float(last);
  w[W_VFIRST] = v_first;
  w[W_VLAST] = v_last;
  const int after = next_at(end, first_after);
  if (after >= 0) w[W_NEXT] = 1.f, w[W_NEXT_X] = value(after), w[W_NEXT_T] = t[after];
  const int jp = prev_before(seg0, last_before);
  if (jp >= 0) {
    const int jn = next_at(seg0, first_from);  // the next observation after j'
    const float xj = value(jp), tj = t[jp];
    w[W_PREV] = 1.f, w[W_PREV_X] = xj, w[W_PREV_T] = tj;
    if (jn >= 0) {  // as phase 1 computes them
      const float hr = 1.f / (t[jn] - tj);
      const float sph = 6.f * (value(jn) - xj) * hr;
      w[W_PREV_HR] = hr, w[W_PREV_SPH] = sph, w[W_PREV_PDS] = 0.5f * sph * hr;
    }
  }
#pragma unroll
  for (int i = 0; i < WALK_FLOATS; ++i) out[i] = w[i];
}

// ---------------------------------------------------------------------------
// The kernel: a row's RP-position chunks in the registers of
// threads_per_row (tpr) consecutive threads, the five phases joined by
// scans across them (row_scan.cuh).

// RT / tpr rows a block, or one segment of a row a block, over a cluster
// (CLUSTERED) or in one of a segmented row's launches (SEG_*; totals: its
// spans and totals): the thread's positions are g0 + u of its row, j0 + u of
// the block's part of it.  Three blocks an SM: the cap of 80 registers a
// thread costs ~400 bytes of spills to L1, and on an H100 at config 3 it
// ran 5 % faster than two blocks without spills (PERF.md).
template <int MODE>
__global__ void __launch_bounds__(RT, 3)
    resident_fit_kernel(const float* __restrict__ x, const float* __restrict__ t,
                        float* __restrict__ a, float* __restrict__ b,
                        float* __restrict__ c, float* __restrict__ d,
                        float* __restrict__ totals, long long n, int k, int tpr, int seg,
                        int version) {
  constexpr bool SPLIT = MODE != RESIDENT_ROWS;
  extern __shared__ float mc_smem[];
  float* buf = mc_smem;             // [RES_BUF] the block's rows of x, then of each output
  float* tb = buf + RES_BUF;        // [RES_BUF] t, shared by the rows
  float* scratch = tb + RES_BUF;    // [RT / 32][SCAN_SLOT] the scans' warp totals
  float* slots = scratch + RT / 32 * SCAN_SLOT;  // [7][SCAN_SLOT] a cluster's exchanges, or a
                                                 // segmented launch's carry-ins and walk
  const RowPart p = row_part<SPLIT>(n, k, tpr, seg);
  const long long row0 = p.row0;
  const int rows = p.rows, rb = p.rb, len = p.len;
  const int tid = threadIdx.x;
  const bool live = p.live;
  const int j0 = p.j0;              // the thread's first position in its part of the row
  const int g0 = p.seg0 + j0;       // and in the row
  const int to = j0 / RP * (RP + 1);  // its chunk in tb
  // The outputs' positions (k - 1 a row) in the block's part.
  const int len_out = SPLIT ? max(0, min(len, k - 1 - p.seg0)) : k - 1;
#define IN(u) (live && j0 + (u) < len)

  // A segmented launch's carry-ins (slots[0..2]) and walk, from warp 0
  // while the others stage.
  float* walk = slots + SCAN_SLOT;
  SegTotals tot = {};
  if constexpr (segmented(MODE)) {
    const int S = (k + seg - 1) / seg;
    tot = seg_totals(totals + 2 * (size_t)n * S, n, false, k, seg, p);
    if (tid < 32) {
      seg_fit_walk(x, t, fit_spans(totals, row0, S), S, tot.me, row0, k, p.seg0, p.seg0 + len,
                   version, walk);
      seg_carry_ins<MODE>(tot, true, slots);
    }
  }

  // Stage t and the block's rows of x (one contiguous range), coalesced.
  for (int i = tid; i < len; i += RT) tb[staged(i)] = t[p.seg0 + i];
  const float* xb = x + row0 * k + p.seg0;
  for (int i = tid; i < rows * len; i += RT) buf[staged(i)] = xb[i];
  __syncthreads();
  float xs[RP];
#pragma unroll
  for (int u = 0; u < RP; ++u)
    xs[u] = IN(u) ? buf[staged(rb * len + j0 + u)] : NAN;

  // Phase 0: first and last observed positions (argmax semantics for a row
  // with none: 0 and k - 1, whose values are NaN and impute nothing).
  int first = 0, last = k - 1;
  float v_first, v_last;
  if constexpr (segmented(MODE)) {
    first = __float_as_int(walk[W_FIRST]);
    last = __float_as_int(walk[W_LAST]);
    v_first = walk[W_VFIRST];
    v_last = walk[W_VLAST];
  } else {
    Vec<2> sp = SpanOp::identity();
#pragma unroll
    for (int u = RP - 1; u >= 0; --u) {
      if (!isnan(xs[u])) {
        sp.v[0] = (float)(g0 + u);
        if (sp.v[1] < 0.f) sp.v[1] = (float)(g0 + u);
      }
    }
    sp = row_span(sp, tpr, scratch);
    if constexpr (MODE == CLUSTERED) sp = cluster_span(sp, slots);
    if (sp.v[0] < NO_POSITION) {
      first = (int)sp.v[0];
      last = (int)sp.v[1];
    }
    if constexpr (MODE == CLUSTERED) {  // the row's own positions, perhaps in another block's segment
      v_first = x[row0 * k + first];
      v_last = x[row0 * k + last];
    } else {
      v_first = live ? buf[staged(rb * k + first)] : NAN;
      v_last = live ? buf[staged(rb * k + last)] : NAN;
    }
  }

  // Imputation: the observed positions (a bit each) and values (0 where missing).
  unsigned obs = 0u;
#pragma unroll
  for (int u = 0; u < RP; ++u) {
    const int j = g0 + u;
    float v = xs[u];
    if (isnan(v) && IN(u)) {
      if (version == 0) {
        if (j == 0) v = v_first;
        else if (j == k - 1) v = v_last;
      } else {
        if (j < first) v = v_first;
        else if (j > last) v = v_last;
      }
    }
    const bool o = !isnan(v);
    obs |= (unsigned)o << u;
    xs[u] = o ? v : 0.f;
  }
#define OBS(u) ((obs >> (u)) & 1u)

  // Phase 1 (reverse): the next observed (value, time) after the chunk, then
  // the interval quantities.
  Vec<3> e3 = SelectOp<3>::identity();
#pragma unroll
  for (int u = RP - 1; u >= 0; --u) {
    if (OBS(u)) e3 = {{1.f, xs[u], tb[to + u]}};
  }
  Vec<3> in3 = SelectOp<3>::identity();  // a segmented block's carry-in
  if constexpr (segmented(MODE)) in3 = {{walk[W_NEXT], walk[W_NEXT_X], walk[W_NEXT_T]}};
  e3 = mode_scan<SelectOp<3>, true, MODE>(e3, tpr, scratch, slots + SCAN_SLOT, in3);
  bool later = e3.v[0] != 0.f;
  float cx = e3.v[1], ct = e3.v[2];
  float hr[RP], sph[RP], pds[RP];
#pragma unroll
  for (int u = RP - 1; u >= 0; --u) {
    const float tj = tb[to + u];
    hr[u] = sph[u] = pds[u] = 0.f;
    if (OBS(u) && later) {
      hr[u] = 1.f / (ct - tj);
      sph[u] = 6.f * (cx - xs[u]) * hr[u];
      pds[u] = 0.5f * sph[u] * hr[u];
    }
    if (OBS(u)) {
      cx = xs[u];
      ct = tj;
      later = true;
    }
  }

  // Phase 2: the previous observed (hr, pds) before the chunk; the Thomas
  // diagonal's carry-in by the Moebius scan; the diagonal in the chunk and
  // the right-hand side's affine maps (nb holds each w until the carry-in
  // of the right-hand side is known); the right-hand side.
  e3 = SelectOp<3>::identity();
#pragma unroll
  for (int u = 0; u < RP; ++u) {
    if (OBS(u)) e3 = {{1.f, hr[u], pds[u]}};
  }
  if constexpr (segmented(MODE)) in3 = {{walk[W_PREV], walk[W_PREV_HR], walk[W_PREV_PDS]}};
  e3 = mode_scan<SelectOp<3>, false, MODE>(e3, tpr, scratch, slots + 2 * SCAN_SLOT, in3);
  const float hp0 = e3.v[1], pp0 = e3.v[2];  // 0 with none (the identity)
  Vec<4> mob = MoebiusOp::identity();
  float hp = hp0;
#pragma unroll
  for (int u = 0; u < RP; ++u) {
    if (OBS(u)) {
      float dg = 2.f * (hp + hr[u]);
      if (!(dg > 0.f)) dg = 1.f;
      mob = MoebiusOp::compose(mob, {{dg, -hp * hp, 1.f, 0.f}});
      hp = hr[u];
    }
  }
  if constexpr (MODE == SEG_PIVOTS) {
    publish_total<MoebiusOp, false>(row_scan<MoebiusOp, false>(mob, tpr, scratch), mob,
                                    tot.tm + 4 * tot.me);
    return;
  } else {
    mob = mode_scan<MoebiusOp, false, MODE>(mob, tpr, scratch, slots + 3 * SCAN_SLOT,
                                            moebius_to(slots[0]));
  }
  const float d_in = (mob.v[0] + mob.v[1]) / (mob.v[2] + mob.v[3]);  // applied to d = 1
  float nd[RP], nb[RP];
  Vec<2> aff = AffineOp::identity();
  float prev_d = d_in, pp = pp0;
  hp = hp0;
#pragma unroll
  for (int u = 0; u < RP; ++u) {
    nd[u] = 1.f;
    nb[u] = 0.f;
    if (OBS(u)) {
      float dg = 2.f * (hp + hr[u]);
      if (!(dg > 0.f)) dg = 1.f;
      const float r = pp + pds[u];
      const float w = hp / prev_d;
      prev_d = dg - w * hp;
      aff = AffineOp::compose(aff, {{-w, r}});
      nd[u] = prev_d;
      nb[u] = w;
      hp = hr[u];
      pp = pds[u];
    }
  }
  if constexpr (MODE == SEG_TOTALS) {
    // The elimination nb -> r - w nb and the substitution kd -> nb / nd -
    // (hr / nd) kd at the next knot, as phase 3 runs it.
    pp = pp0;
    publish_segment_totals(aff, tpr, scratch, tot, [] {},
                           [&](int u, float& w, float& rhs, float& r, float& cc) {
                             if (!OBS(u)) return false;
                             w = nb[u], rhs = pp + pds[u], r = 1.f / nd[u], cc = hr[u] * r;
                             pp = pds[u];
                             return true;
                           });
    return;
  } else {
    aff = mode_scan<AffineOp, false, MODE>(aff, tpr, scratch, slots + 4 * SCAN_SLOT,
                                           affine_to(slots[1]));
  }
  float prev_b = aff.v[1];  // applied to b = 0
  pp = pp0;
#pragma unroll
  for (int u = 0; u < RP; ++u) {
    if (OBS(u)) {
      const float r = pp + pds[u];
      prev_b = r - nb[u] * prev_b;
      nb[u] = prev_b;
      pp = pds[u];
    }
  }

  // Phase 3 (reverse): back substitution; kdn, the knot derivative at the
  // next observed knot, is the substitution's carry.  kd, two_c0 and
  // three_d0 take the places of nd, sph and nb.
  aff = AffineOp::identity();
#pragma unroll
  for (int u = RP - 1; u >= 0; --u) {
    if (OBS(u)) {
      const float inv = 1.f / nd[u];
      aff = AffineOp::compose(aff, {{-hr[u] * inv, nb[u] * inv}});
    }
  }
  aff = mode_scan<AffineOp, true, MODE>(aff, tpr, scratch, slots + 5 * SCAN_SLOT,
                                        affine_to(slots[2]));
  float kdn = aff.v[1];  // applied to kd = 0
#pragma unroll
  for (int u = RP - 1; u >= 0; --u) {
    const float h = hr[u], s6 = sph[u];
    float kd = 0.f;
    if (OBS(u)) kd = (nb[u] - h * kdn) / nd[u];
    nd[u] = kd;
    sph[u] = (s6 - 4.f * kd - 2.f * kdn) * h;
    nb[u] = (-s6 + 3.f * (kd + kdn)) * h * h;
    if (OBS(u)) kdn = kd;
  }
  const float(&kd)[RP] = nd;
  const float(&c0)[RP] = sph;
  const float(&d0)[RP] = nb;

  // Phase 4: the polynomial of the last observed knot at or before each
  // interval (position 0's before any), re-based onto it; each output
  // leaves through buf in turn.
  Vec<6> e6 = SelectOp<6>::identity();
#pragma unroll
  for (int u = 0; u < RP; ++u) {
    if (OBS(u) || g0 + u == 0) e6 = {{1.f, xs[u], kd[u], c0[u], d0[u], tb[to + u]}};
  }
  Vec<6> in6 = SelectOp<6>::identity();
  if constexpr (segmented(MODE)) {
    // The polynomial of j', the last observed knot before the segment, by
    // phase 3's formulas: its nd and nb are the carry-ins, kdn the kd that
    // thread 0 ended on (at the first observed knot from the segment on).
    float* poly = slots + 3 * SCAN_SLOT;
    if (tid == 0) {
      Vec<6> q = SelectOp<6>::identity();
      if (walk[W_PREV] != 0.f) {
        const float h = walk[W_PREV_HR], s6 = walk[W_PREV_SPH];
        const float kdj = (slots[1] - h * kdn) / slots[0];
        q = {{1.f, walk[W_PREV_X], kdj, (s6 - 4.f * kdj - 2.f * kdn) * h,
              (-s6 + 3.f * (kdj + kdn)) * h * h, walk[W_PREV_T]}};
      }
#pragma unroll
      for (int e = 0; e < 6; ++e) poly[e] = q.v[e];
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 6; ++e) in6.v[e] = poly[e];
  }
  e6 = mode_scan<SelectOp<6>, false, MODE>(e6, tpr, scratch, slots + 6 * SCAN_SLOT, in6);
  __syncthreads();  // every read of x in buf is done
  const long long out0 = row0 * (k - 1) + p.seg0;
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    float ca = e6.v[1], cb = e6.v[2], cc = e6.v[3], cd = e6.v[4], cto = e6.v[5];
#pragma unroll
    for (int u = 0; u < RP; ++u) {
      const float tj = tb[to + u];
      if (OBS(u) || g0 + u == 0) {
        ca = xs[u];
        cb = kd[u];
        cc = c0[u];
        cd = d0[u];
        cto = tj;
      }
      const float off = cto - tj;
      float v;
      if (o == 0) v = ca + ((0.5f * cc - cd * off / 3.f) * off - cb) * off;
      else if (o == 1) v = cb + (cd * off - cc) * off;
      else if (o == 2) v = cc - 2.f * cd * off;
      else v = cd;
      if (live && j0 + u < len_out) buf[staged(rb * len_out + j0 + u)] = v;
    }
    __syncthreads();
    float* dst = (o == 0 ? a : o == 1 ? b : o == 2 ? c : d) + out0;
    for (int i = tid; i < rows * len_out; i += RT) dst[i] = buf[staged(i)];
    __syncthreads();
  }
#undef OBS
#undef IN
  if constexpr (MODE == CLUSTERED) cluster_done();
}

}  // namespace

extern "C" {

const char* mc_error_string(int code) {
  if (code == BAD_ARGUMENT) return "invalid argument";
  return cudaGetErrorString((cudaError_t)code);
}

// The kernel's shape, into out[4]: positions a thread holds, threads per
// block, the longest row a block holds, and the most blocks a row's cluster
// spans.
void mc_resident_shape(int* out) {
  out[0] = RP;
  out[1] = RT;
  out[2] = RES_MAX;
  out[3] = CLUSTER_MAX;
}

// The fit: x (n, k) and t (k) float32 contiguous; a, b, c, d (n, k - 1).
// The launch shape as row_blocks checks it (the wrapper's fit_plan): tpr
// threads a row, k <= RES_MAX (cs 1); cs blocks a row of seg positions, over
// a cluster up to CLUSTER_MAX, segmented beyond, then in four launches with
// totals: (n, cs, 11) floats of scratch.
int mc_fit_resident(const float* x, const float* t, float* a, float* b, float* c, float* d,
                    float* totals, long long n, int k, int tpr, int cs, int seg, int version,
                    void* stream) {
  const long long blocks = row_blocks(n, k, tpr, cs, seg);
  if (blocks < 0 || k < 2 || (version != 0 && version != 1) || !x || !t || !a || !b || !c ||
      !d || (cs > CLUSTER_MAX && !totals))
    return BAD_ARGUMENT;
  cudaStream_t st = (cudaStream_t)stream;
  if (cs == 1) {
    resident_fit_kernel<RESIDENT_ROWS><<<(unsigned)blocks, RT, RES_SMEM, st>>>(
        x, t, a, b, c, d, totals, n, k, tpr, 0, version);
    return (int)cudaGetLastError();
  }
  if (cs <= CLUSTER_MAX) {
    cudaError_t err = launch_clusters(resident_fit_kernel<CLUSTERED>, blocks, cs, CLUSTER_SMEM, st,
                                      x, t, a, b, c, d, totals, n, k, (int)RT, seg, version);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  span_fit_kernel<<<(unsigned)blocks, RT, 0, st>>>(x, totals, n, k, seg);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_rows_as<SEG_PIVOTS>(resident_fit_kernel<SEG_PIVOTS>, blocks, cs, CLUSTER_SMEM, st,
                                     x, t, a, b, c, d, totals, n, k, (int)RT, seg, version);
  if (err == cudaSuccess)
    err = launch_rows_as<SEG_TOTALS>(resident_fit_kernel<SEG_TOTALS>, blocks, cs, CLUSTER_SMEM, st,
                                     x, t, a, b, c, d, totals, n, k, (int)RT, seg, version);
  if (err == cudaSuccess)
    err = launch_rows_as<SEG_SOLVE>(resident_fit_kernel<SEG_SOLVE>, blocks, cs, CLUSTER_SMEM, st,
                                    x, t, a, b, c, d, totals, n, k, (int)RT, seg, version);
  return (int)err;
}

}  // extern "C"
