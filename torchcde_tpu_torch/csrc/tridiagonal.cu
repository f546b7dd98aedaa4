// Batched tridiagonal solve (K4), as CUDA kernels for Hopper (sm_90a).
//
// Replaces torchcde_tpu/ops/tridiagonal_pallas.py::_pcr_thomas_kernel
// (reached through tridiagonal_solve_pallas; its custom VJP _tp_bwd is the
// same solve with the bands swapped, which the wrapper launches again).
// Solves A x = b for every row of b (n, k), A with diagonal d (k), upper u
// (k - 1) and lower l (k - 1).  Each band is read with a row stride of its
// own: 0 where one band serves every row (the natural cubic fit's bands
// depend on the times alone), so broadcast bands are never materialised.
//
// What bounds it.  The work is the Thomas recurrence, 8 flops per row and
// position.  At the dense fit's shape (8192 x 4096 float32, shared bands)
// the function reads b once and writes x once: 268 MB, 0.08 ms at
// 3.35 TB/s; the 0.27 GFLOP are nothing.  Bytes bound it, and a sequential
// recurrence with one thread per row is far from that: 8192 rows are 256
// warps, under two an SM, each waiting on its own chain of 2 k dependent
// steps.
//
// Two families of kernels, for shared and for per-row bands, each in three
// ways of holding a row (row_scan.cuh's RowMode); the wrapper
// (ops/tridiagonal_kernel.py, solve_plan) picks the route from k and the
// bands' strides.
//
// Shared bands, k <= RES_MAX (the fit's systems, forward and transposed):
// band_pivot_kernel, then shared_band_kernel.  With one band for every row
// the eliminated diagonal nd_i = d_i - l_{i-1} u_{i-1} / nd_{i-1} is the
// same for every row, so one block computes it once per launch: a scan of
// the Moebius maps nd -> (d_i nd - l_{i-1} u_{i-1}) / nd as 2 x 2 matrices,
// products rescaled by a power of two (row_scan.cuh's MoebiusOp: a float32
// product over thousands of positions overflows otherwise), into a (3, P)
// scratch of w_i = l_{i-1} / nd_{i-1}, r_i = 1 / nd_i and c_i = u_i / nd_i
// (P = threads_per_row * RP, zero past k; 48 KB at k 4096, which stays in
// L2).  Then each row stays resident in the registers of a power of two of
// threads, RP positions a thread, as K6/K7's rows do (row_scan.cuh): b is
// staged in through shared memory with coalesced loads, the elimination
// nb_i = b_i - w_i nb_{i-1} is an affine scan across the row, the
// substitution x_i = r_i nb_i - c_i x_{i+1} an affine suffix scan, and x
// leaves through shared memory as b came in.  So b is read once and x
// written once, and every row's recurrences run as RP-long chunks joined by
// log-depth scans.  A chunk's composed map multiplies the w (or c) of its
// positions: those products are entries of the triangular factors'
// inverses, which the Thomas recurrence forms too, so the scans overflow
// only where Thomas' own intermediates would.
//
// Per-row bands, k <= RES_MAX: per_row_kernel.  Each row resident as above,
// its four operands staged through shared memory (b, d in rows of k, u, l
// in rows of k - 1; a band of stride 0 serves every row), so each is read
// once and x written once.  The pivots are the row's own: its Moebius maps
// scanned across its threads give each chunk the eliminated diagonal before
// it, then the chunk's nd, the elimination's affine scan and the
// substitution's affine suffix scan, as above, with w, 1 / nd and u / nd
// formed where they are used.  Three buffers hold the four operands (b
// comes by cp.async into d's once the diagonal is done): 53 KB of shared
// memory a block, four blocks an SM.  The transpose solve of the gradient
// (the bands swapped) is the same launch.
//
// Rows of RES_MAX < k <= CLUSTER_MAX * RES_MAX: the same kernels over a
// thread block cluster a row (row_scan.cuh: cluster_shape, cluster_scan).
// Each of the cluster's cs blocks holds one segment of the row exactly as a
// resident block holds a row, and each scan gains the cluster level: the
// blocks' totals composed in rank order through distributed shared memory.
// Per-row bands take per_row_kernel<CLUSTERED>; shared bands compute the
// pivots once a launch with band_pivot_kernel<CLUSTERED> (one cluster over
// the band, into a (3, cs seg) scratch, 384 KB at 32 768 positions,
// resident in L2), then shared_band_kernel<CLUSTERED> reads only b and
// writes only x.  The launch
// goes through cudaLaunchKernelEx with the cluster dimension; a refused
// launch is an error, as any other.
//
// Longer rows: the same segments, one block each, segmented
// (row_scan.cuh: SEG_PIVOTS, SEG_TOTALS, SEG_SOLVE), the scans' totals
// crossing through a small buffer in device memory between launches.  Per-
// row bands take per_row_kernel in its three launches: the Moebius totals
// (d, u, l read), then the elimination's and the substitution's totals,
// then x (b, d, u, l read, x written), 12 arrays of (n, k) moved against
// the function's 5.  Shared bands take band_pivot_kernel twice over the one
// band (its Moebius totals, then the pivots from their carry-ins) and
// shared_band_kernel twice (the affine totals, then x): b read twice and x
// written once, against the function's 2 arrays.
//
// The TPU kernel's PCR levels, interleaved slabs and the pre-split of
// lengths over 1024 exist only to fill vector lanes and fit VMEM; they have
// no counterpart.  Every route runs in a fixed order without atomics: two
// launches give the same bits.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "row_scan.cuh"

namespace {

constexpr int BAD_ARGUMENT = -2;

// ---------------------------------------------------------------------------
// Shared bands: the pivots once, then each row resident (or, past RES_MAX,
// each row in segments, over a cluster or segmented).

constexpr size_t BAND_SMEM = sizeof(float) * (RES_BUF + RT / 32 * SCAN_SLOT);
constexpr size_t BAND_SPLIT_SMEM = BAND_SMEM + sizeof(float) * CLUSTER_SLOTS * SCAN_SLOT;

// piv (3, P): rows w, r, c as above, zero at positions past k; P = tpr * RP
// (one block of RT threads, the first tpr of them holding the band, RP
// positions each, the rest running the same scan on nothing), or, in
// segments, P = cs * seg (block r holds positions [r seg, (r + 1) seg) in
// all its threads: the one cluster over the band, or a segmented launch of
// cs blocks whose Moebius totals are totals' first cs * 4 floats).
template <int MODE>
__global__ void __launch_bounds__(RT)
    band_pivot_kernel(const float* __restrict__ u, const float* __restrict__ d,
                      const float* __restrict__ l, float* __restrict__ piv,
                      float* __restrict__ totals, int k, int tpr, int seg) {
  constexpr bool SPLIT = MODE != RESIDENT_ROWS;
  __shared__ float scratch[RT / 32 * SCAN_SLOT];
  __shared__ float slot[SCAN_SLOT];  // a cluster's exchange, or a segment's carry-in
  const int tid = threadIdx.x;
  const int cs = SPLIT ? (k + seg - 1) / seg : 1;
  const int P = SPLIT ? cs * seg : tpr * RP;
  const int j0 = (SPLIT ? (int)blockIdx.x * seg : 0) + (tid % tpr) * RP;
  const bool mine = SPLIT ? tid * RP < seg : tid < tpr;
  if constexpr (MODE == SEG_SOLVE) {
    if (tid < 32) {
      const float nd_in = seg_moebius_carry(totals, blockIdx.x);
      if (tid == 0) slot[0] = nd_in;
    }
    __syncthreads();
  }
  // The chunk's maps: position j's is [[d_j, -l_{j-1} u_{j-1}], [1, 0]]
  // (l_{-1} u_{-1} = 0), applied to 1 at the start of the row.
  Vec<4> mob = MoebiusOp::identity();
  float lu[RP], dv[RP];
#pragma unroll
  for (int s = 0; s < RP; ++s) {
    const int j = j0 + s;
    const bool in = mine && j < k;
    dv[s] = in ? d[j] : 1.f;
    lu[s] = in && j > 0 ? l[j - 1] * u[j - 1] : 0.f;
    if (in) mob = MoebiusOp::compose(mob, {{dv[s], -lu[s], 1.f, 0.f}});
  }
  if constexpr (MODE == SEG_PIVOTS) {
    publish_total<MoebiusOp, false>(row_scan<MoebiusOp, false>(mob, tpr, scratch), mob,
                                    totals + 4 * blockIdx.x);
    return;
  } else {
    mob = mode_scan<MoebiusOp, false, MODE>(mob, tpr, scratch, slot, moebius_to(slot[0]));
  }
  if (mine) {
    float prev = (mob.v[0] + mob.v[1]) / (mob.v[2] + mob.v[3]);  // nd_{j0 - 1}
#pragma unroll
    for (int s = 0; s < RP; ++s) {
      const int j = j0 + s;
      float w = 0.f, r = 0.f, c = 0.f;
      if (j < k) {
        w = j > 0 ? l[j - 1] / prev : 0.f;
        prev = dv[s] - lu[s] / prev;
        r = 1.f / prev;
        c = j + 1 < k ? u[j] / prev : 0.f;
      }
      piv[j] = w;
      piv[P + j] = r;
      piv[2 * P + j] = c;
    }
  }
  if constexpr (MODE == CLUSTERED) cluster_done();
}

// x (n, k) from b (n, k) and the pivots (3, P) of band_pivot_kernel: tpr
// threads a row, RT / tpr rows a block; or one segment of a row a block,
// over a cluster or in one of a segmented row's two launches here (totals:
// after the band's cs * 4 Moebius floats, the rows' (n, cs, 2) elimination
// and (n, cs, 3) substitution totals).  Five blocks an SM: the cap of 48
// registers a thread costs a few bytes of spills, and on an H100 at config
// 3 it ran faster than three or four blocks without them, or six
// (PERF.md).
template <int MODE>
__global__ void __launch_bounds__(RT, 5)
    shared_band_kernel(const float* __restrict__ b, const float* __restrict__ piv,
                       float* __restrict__ x, float* __restrict__ totals, long long n, int k,
                       int tpr, int seg) {
  constexpr bool SPLIT = MODE != RESIDENT_ROWS;
  extern __shared__ float band_smem[];
  float* buf = band_smem;            // [RES_BUF] the block's rows of b, then of x
  float* scratch = buf + RES_BUF;    // [RT / 32][SCAN_SLOT] the scans' warp totals
  float* slots = scratch + RT / 32 * SCAN_SLOT;  // [2][SCAN_SLOT] a cluster's exchanges, or a
                                                 // segmented launch's carry-ins
  const RowPart p = row_part<SPLIT>(n, k, tpr, seg);
  const int P = SPLIT ? (k + seg - 1) / seg * seg : tpr * RP;
  const int tid = threadIdx.x, rb = p.rb, j0 = p.j0, len = p.len;
  const bool live = p.live;
  SegTotals tot = {};
  if constexpr (segmented(MODE)) {
    tot = seg_totals(totals, n, true, k, seg, p);
    seg_carry_ins<MODE>(tot, false, slots);
  }

  // Stage the block's rows of b (one contiguous range), coalesced.
  const float* bb = b + p.row0 * k + p.seg0;
  for (int i = tid; i < p.rows * len; i += RT) buf[staged(i)] = bb[i];
  float v[RP], w[RP];
  const bool held = !SPLIT || j0 < seg;  // the thread's positions lie in the scratch
  const float4* p4 = reinterpret_cast<const float4*>(piv + p.seg0 + j0);
#pragma unroll
  for (int q = 0; q < RP / 4; ++q) {
    const float4 a = held ? p4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    w[4 * q] = a.x, w[4 * q + 1] = a.y, w[4 * q + 2] = a.z, w[4 * q + 3] = a.w;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < RP; ++s) v[s] = live && j0 + s < len ? buf[staged(rb * len + j0 + s)] : 0.f;

  // Elimination: nb_j = b_j - w_j nb_{j-1}, the map nb -> -w_j nb + b_j.
  Vec<2> aff = AffineOp::identity();
#pragma unroll
  for (int s = 0; s < RP; ++s)  // in segments, a block's threads past its segment hold none
    if (!SPLIT || j0 + s < len) aff = AffineOp::compose(aff, {{-w[s], v[s]}});
  // r and c come in after the elimination's scan: loaded before it, they
  // spill.
  float r[RP], c[RP];
  auto load_rc = [&] {
#pragma unroll
    for (int q = 0; q < RP / 4; ++q) {
      const float4 e = held ? p4[P / 4 + q] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 f = held ? p4[P / 2 + q] : make_float4(0.f, 0.f, 0.f, 0.f);
      r[4 * q] = e.x, r[4 * q + 1] = e.y, r[4 * q + 2] = e.z, r[4 * q + 3] = e.w;
      c[4 * q] = f.x, c[4 * q + 1] = f.y, c[4 * q + 2] = f.z, c[4 * q + 3] = f.w;
    }
  };
  if constexpr (MODE == SEG_TOTALS) {
    publish_segment_totals(aff, tpr, scratch, tot, load_rc,
                           [&](int s, float& ws, float& bs, float& rs, float& cs) {
                             ws = w[s], bs = v[s], rs = r[s], cs = c[s];
                             return j0 + s < len;
                           });
    return;
  } else {
    aff = mode_scan<AffineOp, false, MODE>(aff, tpr, scratch, slots, affine_to(slots[1]));
  }
  float carry = aff.v[1];  // applied to nb_{-1} = 0
#pragma unroll
  for (int s = 0; s < RP; ++s) {
    carry = v[s] - w[s] * carry;
    v[s] = carry;
  }
  load_rc();
  // Substitution: x_j = r_j nb_j - c_j x_{j+1}, in reverse (c_{k-1} = 0).
  aff = AffineOp::identity();
#pragma unroll
  for (int s = RP - 1; s >= 0; --s)
    if (!SPLIT || j0 + s < len) aff = AffineOp::compose(aff, {{-c[s], r[s] * v[s]}});
  aff = mode_scan<AffineOp, true, MODE>(aff, tpr, scratch, slots + SCAN_SLOT, affine_to(slots[2]));
  carry = aff.v[1];  // applied to x_k = 0
#pragma unroll
  for (int s = RP - 1; s >= 0; --s) {
    carry = r[s] * v[s] - c[s] * carry;
    v[s] = carry;
  }
  __syncthreads();  // every read of b in buf is done
#pragma unroll
  for (int s = 0; s < RP; ++s)
    if (live && j0 + s < len) buf[staged(rb * len + j0 + s)] = v[s];
  __syncthreads();
  float* xb = x + p.row0 * k + p.seg0;
  for (int i = tid; i < p.rows * len; i += RT) xb[i] = buf[staged(i)];
  if constexpr (MODE == CLUSTERED) cluster_done();
}

// ---------------------------------------------------------------------------
// Per-row bands: each row resident (or, past RES_MAX, in segments) with its
// own pivots.

constexpr int ROW_BUF = RES_BUF + 4;  // staged floats of an operand: RES_MAX + 1 positions
constexpr size_t ROWS_SMEM =
    sizeof(float) * (3 * ROW_BUF + RT / 32 * SCAN_SLOT + CLUSTER_SLOTS * SCAN_SLOT);

// Stages count elements of a band into dst[staged(at + i)]: src[row0 s +
// base + i], or, where a band of stride 0 (one for every row, rows of width
// positions) wraps past its end, src[(base + i) % width].
__device__ __forceinline__ void stage_band(float* dst, int at, const float* __restrict__ src,
                                           long long row0, long long s, int width, int base,
                                           int count) {
  if (s || base + count <= width) {
    const float* q = src + row0 * s + base;
    for (int i = threadIdx.x; i < count; i += RT) dst[staged(at + i)] = q[i];
  } else {
    for (int i = threadIdx.x; i < count; i += RT) dst[staged(at + i)] = src[(base + i) % width];
  }
}

// x (n, k) from b (n, k) and bands u, l (rows of k - 1) and d (rows of k)
// at row strides su, sl, sd (0: one band for every row): tpr threads a row,
// RT / tpr rows a block, or one segment of a row a block, over a cluster
// or in one of a segmented row's three launches (totals: the rows' (n, cs,
// 4) Moebius, (n, cs, 2) elimination and (n, cs, 3) substitution totals).
// Three buffers serve the four operands, so four blocks share an SM (64
// registers a thread): d, u and l are staged first; b, needed only from the
// elimination on, comes by cp.async into d's buffer once the diagonal is
// done, and x leaves through the same buffer.
template <int MODE>
__global__ void __launch_bounds__(RT, 4)
    per_row_kernel(const float* __restrict__ b, const float* __restrict__ u,
                   const float* __restrict__ d, const float* __restrict__ l,
                   float* __restrict__ x, float* __restrict__ totals, long long n, int k, int tpr,
                   int seg, long long su, long long sd, long long sl) {
  constexpr bool SPLIT = MODE != RESIDENT_ROWS;
  extern __shared__ float rows_smem[];
  float* sdg = rows_smem;            // [ROW_BUF] the block's rows of d, then b, then x
  float* sup = sdg + ROW_BUF;        // [ROW_BUF] u
  float* slo = sup + ROW_BUF;        // [ROW_BUF] l
  float* scratch = slo + ROW_BUF;    // [RT / 32][SCAN_SLOT] the scans' warp totals
  float* slots = scratch + RT / 32 * SCAN_SLOT;  // [3][SCAN_SLOT] a cluster's exchanges, or a
                                                 // segmented launch's carry-ins
  float* sb = sdg;
  const RowPart p = row_part<SPLIT>(n, k, tpr, seg);
  const int km1 = k - 1, j0 = p.j0, len = p.len;
  // Position g of the thread's row: b and d at staged(bi + g), u and l at
  // staged(ui + g).  A resident block holds its rows whole (b, d k apart; u,
  // l k - 1 apart); a block of a split row holds its segment, u and l from
  // the position before it on.
  const int bi = p.rb * len - p.seg0;
  const int ui = SPLIT ? 1 - p.seg0 : p.rb * km1;
  const int g0 = p.seg0 + j0;
  SegTotals tot = {};
  if constexpr (segmented(MODE)) {
    tot = seg_totals(totals, n, false, k, seg, p);
    seg_carry_ins<MODE>(tot, true, slots);
  }

  // The block's range of each operand: nbd elements of b and d, nul of u
  // and l from position lo on (a segment's block: from the one before its
  // segment).
  const int nbd = p.rows * len;
  const int lo = SPLIT ? max(p.seg0 - 1, 0) : 0;
  const int nul = SPLIT ? min(p.seg0 + len, km1) - lo : p.rows * km1;
  const int at = lo + (SPLIT ? ui : 0);
  stage_band(sdg, 0, d, p.row0, sd, k, p.seg0, nbd);
  stage_band(sup, at, u, p.row0, su, km1, lo, nul);
  stage_band(slo, at, l, p.row0, sl, km1, lo, nul);
  __syncthreads();
#define IN(s) (p.live && j0 + (s) < len)

  // The eliminated diagonal's carry-in: the Moebius maps
  // [[d_g, -l_{g-1} u_{g-1}], [1, 0]] of the positions before the chunk,
  // applied to 1.
  Vec<4> mob = MoebiusOp::identity();
#pragma unroll
  for (int s = 0; s < RP; ++s) {
    const int g = g0 + s;
    if (IN(s)) {
      const float lu = g > 0 ? slo[staged(ui + g - 1)] * sup[staged(ui + g - 1)] : 0.f;
      mob = MoebiusOp::compose(mob, {{sdg[staged(bi + g)], -lu, 1.f, 0.f}});
    }
  }
  if constexpr (MODE == SEG_PIVOTS) {
    publish_total<MoebiusOp, false>(row_scan<MoebiusOp, false>(mob, tpr, scratch), mob,
                                    tot.tm + 4 * tot.me);
    return;
  } else {
    mob = mode_scan<MoebiusOp, false, MODE>(mob, tpr, scratch, slots, moebius_to(slots[0]));
  }
  float prev_d = (mob.v[0] + mob.v[1]) / (mob.v[2] + mob.v[3]);

  // The diagonal in the chunk, nd_g = d_g - w_g u_{g-1} with w_g =
  // l_{g-1} / nd_{g-1} (nb holds each w until the carry-in is known).
  float nd[RP], nb[RP];
#pragma unroll
  for (int s = 0; s < RP; ++s) {
    const int g = g0 + s;
    nd[s] = 1.f;
    nb[s] = 0.f;
    if (IN(s)) {
      float w = 0.f, dg = sdg[staged(bi + g)];
      if (g > 0) {
        w = slo[staged(ui + g - 1)] / prev_d;
        dg -= w * sup[staged(ui + g - 1)];
      }
      prev_d = dg;
      nd[s] = dg;
      nb[s] = w;
    }
  }
  // d is read no more: b comes into its buffer.
  __syncthreads();
  const float* qb = b + p.row0 * k + p.seg0;
  for (int i = threadIdx.x; i < nbd; i += RT)
    __pipeline_memcpy_async(sb + staged(i), qb + i, sizeof(float));
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // The elimination's maps nb -> -w_g nb + b_g, then nb from its carry-in
  // (applied to nb_{-1} = 0).
  Vec<2> aff = AffineOp::identity();
#pragma unroll
  for (int s = 0; s < RP; ++s)
    if (IN(s)) aff = AffineOp::compose(aff, {{-nb[s], sb[staged(bi + g0 + s)]}});
  if constexpr (MODE == SEG_TOTALS) {
    publish_segment_totals(aff, tpr, scratch, tot, [] {},
                           [&](int s, float& w, float& bs, float& r, float& c) {
                             const int g = g0 + s;
                             if (!IN(s)) return false;
                             w = nb[s], bs = sb[staged(bi + g)], r = 1.f / nd[s];
                             c = g < km1 ? sup[staged(ui + g)] * r : 0.f;
                             return true;
                           });
    return;
  } else {
    aff = mode_scan<AffineOp, false, MODE>(aff, tpr, scratch, slots + SCAN_SLOT,
                                           affine_to(slots[1]));
  }
  float carry = aff.v[1];
#pragma unroll
  for (int s = 0; s < RP; ++s) {
    if (IN(s)) {
      carry = sb[staged(bi + g0 + s)] - nb[s] * carry;
      nb[s] = carry;
    }
  }

  // Substitution, in reverse: x_g = r_g nb_g - c_g x_{g+1}, r_g = 1 / nd_g,
  // c_g = u_g r_g (0 at g = k - 1), from the carry-in x after the chunk
  // (applied to x_k = 0); nd holds r from here; x goes over b in sb, each
  // thread at its own positions.
  aff = AffineOp::identity();
#pragma unroll
  for (int s = RP - 1; s >= 0; --s) {
    const int g = g0 + s;
    if (IN(s)) {
      nd[s] = 1.f / nd[s];
      const float c = g < km1 ? sup[staged(ui + g)] * nd[s] : 0.f;
      aff = AffineOp::compose(aff, {{-c, nd[s] * nb[s]}});
    }
  }
  aff = mode_scan<AffineOp, true, MODE>(aff, tpr, scratch, slots + 2 * SCAN_SLOT,
                                        affine_to(slots[2]));
  carry = aff.v[1];
#pragma unroll
  for (int s = RP - 1; s >= 0; --s) {
    const int g = g0 + s;
    if (IN(s)) {
      const float c = g < km1 ? sup[staged(ui + g)] * nd[s] : 0.f;
      carry = nd[s] * nb[s] - c * carry;
      sb[staged(bi + g)] = carry;
    }
  }
#undef IN
  __syncthreads();
  float* xb = x + p.row0 * k + p.seg0;
  for (int i = threadIdx.x; i < p.rows * len; i += RT) xb[i] = sb[staged(i)];
  if constexpr (MODE == CLUSTERED) cluster_done();
}

}  // namespace

extern "C" {

const char* td_error_string(int code) {
  if (code == BAD_ARGUMENT) return "invalid argument";
  return cudaGetErrorString((cudaError_t)code);
}

// The shared-band route: b (n, k) and x (n, k) contiguous, one band each
// (u, l of k - 1, d of k); piv: (3, P) scratch, 16-byte aligned, P = tpr *
// RP for a resident row (cs 1), cs * seg in segments; the launch shape as
// row_blocks checks it (the wrapper's solve_plan); past CLUSTER_MAX
// segments, totals: (cs * (4 + 5 n)) floats of scratch.
int td_solve_shared(const float* b, const float* u, const float* d, const float* l,
                    float* x, float* piv, float* totals, long long n, int k, int tpr, int cs,
                    int seg, void* stream) {
  const long long blocks = row_blocks(n, k, tpr, cs, seg);
  if (blocks < 0 || !b || !d || !x || !piv || (k > 1 && (!u || !l)) ||
      (reinterpret_cast<size_t>(piv) & 15) || (cs > CLUSTER_MAX && !totals))
    return BAD_ARGUMENT;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (cs == 1) {
    band_pivot_kernel<RESIDENT_ROWS><<<1, RT, 0, st>>>(u, d, l, piv, totals, k, tpr, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)launch_rows_as<RESIDENT_ROWS>(shared_band_kernel<RESIDENT_ROWS>, blocks, cs,
                                              BAND_SMEM, st, b, (const float*)piv, x, totals, n,
                                              k, tpr, seg);
  }
  if (cs <= CLUSTER_MAX) {
    err = launch_clusters(band_pivot_kernel<CLUSTERED>, cs, cs, 0, st, u, d, l, piv, totals, k,
                          (int)RT, seg);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_rows_as<CLUSTERED>(shared_band_kernel<CLUSTERED>, blocks, cs,
                                          BAND_SPLIT_SMEM, st, b, (const float*)piv, x, totals, n,
                                          k, tpr, seg);
  }
  band_pivot_kernel<SEG_PIVOTS><<<cs, RT, 0, st>>>(u, d, l, piv, totals, k, RT, seg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  band_pivot_kernel<SEG_SOLVE><<<cs, RT, 0, st>>>(u, d, l, piv, totals, k, RT, seg);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_rows_as<SEG_TOTALS>(shared_band_kernel<SEG_TOTALS>, blocks, cs, BAND_SPLIT_SMEM,
                                     st, b, (const float*)piv, x, totals, n, k, tpr, seg);
  if (err == cudaSuccess)
    err = launch_rows_as<SEG_SOLVE>(shared_band_kernel<SEG_SOLVE>, blocks, cs, BAND_SPLIT_SMEM, st,
                                    b, (const float*)piv, x, totals, n, k, tpr, seg);
  return (int)err;
}

// The per-row route: b (n, k) and x (n, k) contiguous; u, l rows of k - 1
// and d rows of k at row strides su, sl, sd (0: one band for every row);
// the launch shape as row_blocks checks it (the wrapper's solve_plan); past
// CLUSTER_MAX segments, totals: (n, cs, 9) floats of scratch.
int td_solve_rows(const float* b, const float* u, const float* d, const float* l, float* x,
                  float* totals, long long n, int k, int tpr, int cs, int seg, long long su,
                  long long sd, long long sl, void* stream) {
  const long long blocks = row_blocks(n, k, tpr, cs, seg);
  if (blocks < 0 || !b || !d || !x || (k > 1 && (!u || !l)) || su < 0 || sd < 0 || sl < 0 ||
      (cs > CLUSTER_MAX && !totals))
    return BAD_ARGUMENT;
  cudaStream_t st = (cudaStream_t)stream;
  if (cs == 1)
    return (int)launch_rows_as<RESIDENT_ROWS>(per_row_kernel<RESIDENT_ROWS>, blocks, cs, ROWS_SMEM,
                                              st, b, u, d, l, x, totals, n, k, tpr, seg, su, sd,
                                              sl);
  if (cs <= CLUSTER_MAX)
    return (int)launch_rows_as<CLUSTERED>(per_row_kernel<CLUSTERED>, blocks, cs, ROWS_SMEM, st, b,
                                          u, d, l, x, totals, n, k, tpr, seg, su, sd, sl);
  cudaError_t err = launch_rows_as<SEG_PIVOTS>(per_row_kernel<SEG_PIVOTS>, blocks, cs, ROWS_SMEM,
                                               st, b, u, d, l, x, totals, n, k, tpr, seg, su, sd,
                                               sl);
  if (err == cudaSuccess)
    err = launch_rows_as<SEG_TOTALS>(per_row_kernel<SEG_TOTALS>, blocks, cs, ROWS_SMEM, st, b, u,
                                     d, l, x, totals, n, k, tpr, seg, su, sd, sl);
  if (err == cudaSuccess)
    err = launch_rows_as<SEG_SOLVE>(per_row_kernel<SEG_SOLVE>, blocks, cs, ROWS_SMEM, st, b, u, d,
                                    l, x, totals, n, k, tpr, seg, su, sd, sl);
  return (int)err;
}

}  // extern "C"
