// Gappy ("masked") Thomas solve over the observed knots (K5), as CUDA
// kernels for Hopper (sm_90a).
//
// Replaces torchcde_tpu/ops/masked_tridiagonal_pallas.py::_fwd_kernel and
// ::_bwd_kernel (reached through masked_thomas_pallas).  The NaN-masked
// natural cubic fit solves a tridiagonal system that couples consecutive
// OBSERVED positions of each row: diagonal diag, right-hand side rhs, the
// coupling hr at the earlier knot and hr_prev carried from the previous
// observed position.  Missing positions pass the elimination carry through
// and receive x = 0.  In the fit it runs inside the gradient only: once in
// the recomputed forward and once as the (symmetric) transpose solve.
//
// What bounds it.  The function reads four (n, k) float32 arrays and the
// mask and writes x: at 8192 x 4096, 705 MB, 0.21 ms at 3.35 TB/s; its
// ~10 flops per position are nothing.  A sequential recurrence with one
// thread per row is far from that: 8192 rows are 256 warps, under two an
// SM, each waiting on its own chain of 2 k dependent steps.
//
// One kernel, gappy_kernel, in three ways of holding a row (row_scan.cuh's
// RowMode); the wrapper (ops/masked_tridiagonal_kernel.py, solve_plan)
// picks one from k.
//
// Rows of k <= RES_MAX (RESIDENT_ROWS).  Each row stays on chip from its
// operands to x, laid out as K6/K7's and K4's resident rows (row_scan.cuh):
// a row belongs to a power of two of threads, RP positions a thread, short
// rows sharing a block of RT threads.  The block's rows are one contiguous
// range of each operand, staged into shared memory with coalesced loads
// (staged()'s padding), the mask packed into one bit a position by warp
// ballots, so each operand is read once and x written once, out through
// shared memory in the same way.  The reference recurrences
// (torchcde_tpu/interpolation/cubic.py::_masked_thomas_observed), with
// missing positions the identity in each, become chunk-local passes joined
// by scans across the row:
//  - the eliminated diagonal nd_i = diag_i - hp_i^2 / nd_{i-1} by a scan of
//    its Moebius maps [[diag_i, -hp_i^2], [1, 0]] (MoebiusOp: products
//    rescaled by powers of two), the carry-in applied to nd = 1 as the
//    reference starts;
//  - the right-hand side nb_i = rhs_i - (hp_i / nd_{i-1}) nb_{i-1} from 0
//    by an affine scan;
//  - the substitution x_i = nb_i / nd_i - (hr_i / nd_i) x_next from 0 by an
//    affine suffix scan.
// Each thread then runs its chunk from its carry-in with the reference
// arithmetic, except that the substitution multiplies by 1 / nd_i, which
// its scan needs anyway, where the reference divides.  The operands stay in
// shared memory and are read again by each pass; the registers hold nd and
// nb.  Three buffers serve the four operands: hr, needed only by the
// substitution, is copied (cp.async) into diag's buffer once the diagonal
// pass is done, while the right-hand side's scan runs.  So a block holds 53
// KB and an SM four blocks: on an H100 at config 3 that ran well ahead of
// all four operands staged at once, three blocks an SM (PERF.md).
//
// Rows of RES_MAX < k <= CLUSTER_MAX * RES_MAX (CLUSTERED): a thread block
// cluster of cs = ceil(k / RES_MAX) blocks a row (cluster_shape), each
// holding one segment exactly as a resident block holds a row, its mask
// packed per segment; each of the three scans gains the cluster level
// (cluster_scan: the blocks' totals composed in rank order through
// distributed shared memory), each exchange in a slot of its own.
//
// Longer rows (SEG_PIVOTS, SEG_TOTALS, SEG_SOLVE): the same segments, one
// block each, in three launches whose totals cross through a small (n, S,
// 9) buffer in device memory (row_scan.cuh: the Moebius totals, then the
// elimination's and the substitution's, the latter affine in the
// elimination's carry-in).  The first launch reads diag, hr_prev and the
// mask; the other two all five operands, the last writing x: 47 bytes a
// position against the function's 21.
//
// Like the reference, no route guards a division: the TPU kernels' 1e-30
// floors exist for their rescaling only.  Every route runs in a fixed order
// without atomics: two launches give the same bits.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_scan.cuh"

namespace {

constexpr int BAD_ARGUMENT = -2;
constexpr int MASK_WORDS = RES_MAX / 32 + 1;  // the block's mask bits, and a word past them
constexpr size_t GAPPY_SMEM = sizeof(float) * (3 * RES_BUF + RT / 32 * SCAN_SLOT + 3 * SCAN_SLOT) +
                              sizeof(unsigned) * MASK_WORDS;

// x (n, k) from the operands (n, k): tpr threads a row, RT / tpr rows a
// block (RESIDENT_ROWS); or one segment of seg positions of a row a block, RT
// threads, over a cluster or in one launch of a segmented row (totals: its
// (n, S, 4) Moebius, (n, S, 2) elimination and (n, S, 3) substitution
// totals, one after another).  Four blocks an SM (64 registers a thread).
template <int MODE>
__global__ void __launch_bounds__(RT, 4)
    gappy_kernel(const float* __restrict__ diag, const float* __restrict__ rhs,
                 const float* __restrict__ hr, const float* __restrict__ hr_prev,
                 const uint8_t* __restrict__ obs, float* __restrict__ x,
                 float* __restrict__ totals, long long n, int k, int tpr, int seg) {
  constexpr bool SPLIT = MODE != RESIDENT_ROWS;
  extern __shared__ float gappy_smem[];
  float* sd = gappy_smem;           // [RES_BUF] the block's rows of diag, then hr, then x
  float* sr = sd + RES_BUF;         // [RES_BUF] rhs
  float* sp = sr + RES_BUF;         // [RES_BUF] hr_prev
  float* scratch = sp + RES_BUF;    // [RT / 32][SCAN_SLOT] the scans' warp totals
  float* slots = scratch + RT / 32 * SCAN_SLOT;  // [3][SCAN_SLOT] a cluster's exchanges, or
                                                 // a segmented launch's carry-ins
  unsigned* bits = reinterpret_cast<unsigned*>(slots + 3 * SCAN_SLOT);  // [MASK_WORDS]
  const RowPart p = row_part<SPLIT>(n, k, tpr, seg);
  const int tid = threadIdx.x, j0 = p.j0, len = p.len;
  const int total = p.rows * len;
  const size_t base = (size_t)p.row0 * (size_t)k + p.seg0;

  SegTotals tot = {};
  if constexpr (segmented(MODE)) {
    tot = seg_totals(totals, n, false, k, seg, p);
    seg_carry_ins<MODE>(tot, true, slots);
  }

  // Stage the block's rows (or segment) of diag, rhs and hr_prev (one
  // contiguous range of each), coalesced; bit i of the mask words is
  // element i's (a warp's ballot covers 32 consecutive elements, starting
  // at a multiple of 32).  The first segmented launch needs no rhs.
#pragma unroll 4
  for (int i0 = 0; i0 < total; i0 += RT) {
    const int i = i0 + tid;
    bool o = false;
    if (i < total) {
      const int s = staged(i);
      sd[s] = diag[base + i];
      if (MODE != SEG_PIVOTS) sr[s] = rhs[base + i];
      sp[s] = hr_prev[base + i];
      o = obs[base + i] != 0;
    }
    const unsigned word = __ballot_sync(0xffffffffu, o);
    if ((tid & 31) == 0) bits[i >> 5] = word;
  }
  __syncthreads();

  // The thread's positions' mask bits (none for a thread past the rows or
  // the row's, or segment's, end: it holds identity maps); element u of its
  // chunk is at staged(p0 + u).
  const int p0 = p.rb * len + j0;
  unsigned ob = 0u;
  if (p.live && j0 < len) {
    const int w = p0 >> 5, off = p0 & 31;
    unsigned long long window = bits[w];
    if (off > 32 - RP) window |= (unsigned long long)bits[w + 1] << 32;
    ob = (unsigned)(window >> off) & ((1u << RP) - 1u);
    if (len - j0 < RP) ob &= (1u << (len - j0)) - 1u;
  }
#define OBS(u) ((ob >> (u)) & 1u)

  // The eliminated diagonal's carry-in: the Moebius maps of the positions
  // before the chunk, applied to nd = 1.
  Vec<4> mob = MoebiusOp::identity();
#pragma unroll
  for (int u = 0; u < RP; ++u) {
    if (OBS(u)) {
      const int s = staged(p0 + u);
      const float hp = sp[s];
      mob = MoebiusOp::compose(mob, {{sd[s], -hp * hp, 1.f, 0.f}});
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

  // The diagonal in the chunk, and the right-hand side's affine maps
  // nb -> -w nb + rhs (nb holds each w until the carry-in is known); then
  // the right-hand side from its carry-in (applied to nb = 0).
  float nd[RP], nb[RP];
  Vec<2> aff = AffineOp::identity();
#pragma unroll
  for (int u = 0; u < RP; ++u) {
    nd[u] = 1.f;
    nb[u] = 0.f;
    if (OBS(u)) {
      const int s = staged(p0 + u);
      const float hp = sp[s];
      const float w = hp / prev_d;
      prev_d = sd[s] - w * hp;
      aff = AffineOp::compose(aff, {{-w, sr[s]}});
      nd[u] = prev_d;
      nb[u] = w;
    }
  }
  // diag is read no more: hr comes into its buffer while the scan runs.
  __syncthreads();
  for (int i = tid; i < total; i += RT)
    __pipeline_memcpy_async(sd + staged(i), hr + base + i, sizeof(float));
  __pipeline_commit();
  if constexpr (MODE == SEG_TOTALS) {
    // hr (in sd) is read once it has come.
    publish_segment_totals(aff, tpr, scratch, tot,
                           [] {
                             __pipeline_wait_prior(0);
                             __syncthreads();
                           },
                           [&](int u, float& w, float& b, float& r, float& c) {
                             if (!OBS(u)) return false;
                             const int s = staged(p0 + u);
                             w = nb[u], b = sr[s], r = 1.f / nd[u], c = sd[s] * r;
                             return true;
                           });
    return;
  } else {
    aff = mode_scan<AffineOp, false, MODE>(aff, tpr, scratch, slots + SCAN_SLOT,
                                           affine_to(slots[1]));
  }
  float prev_b = aff.v[1];
#pragma unroll
  for (int u = 0; u < RP; ++u) {
    if (OBS(u)) {
      prev_b = sr[staged(p0 + u)] - nb[u] * prev_b;
      nb[u] = prev_b;
    }
  }

  // Back substitution, in reverse: the carry-in is x at the next observed
  // position after the chunk (0 past the last); nd holds 1 / nd from here;
  // x goes to the thread's own positions of sd, over their hr.
  __pipeline_wait_prior(0);
  __syncthreads();
  aff = AffineOp::identity();
#pragma unroll
  for (int u = RP - 1; u >= 0; --u) {
    if (OBS(u)) {
      nd[u] = 1.f / nd[u];
      aff = AffineOp::compose(aff, {{-sd[staged(p0 + u)] * nd[u], nb[u] * nd[u]}});
    }
  }
  aff = mode_scan<AffineOp, true, MODE>(aff, tpr, scratch, slots + 2 * SCAN_SLOT,
                                        affine_to(slots[2]));
  float x_next = aff.v[1];
#pragma unroll
  for (int u = RP - 1; u >= 0; --u) {
    const int s = staged(p0 + u);
    float xi = 0.f;
    if (OBS(u)) {
      xi = (nb[u] - sd[s] * x_next) * nd[u];
      x_next = xi;
    }
    if (p.live && j0 + u < len) sd[s] = xi;
  }
#undef OBS
  __syncthreads();
  float* xb = x + base;
  for (int i = tid; i < total; i += RT) xb[i] = sd[staged(i)];
  if constexpr (MODE == CLUSTERED) cluster_done();
}

}  // namespace

extern "C" {

const char* mt_error_string(int code) {
  if (code == BAD_ARGUMENT) return "invalid argument";
  return cudaGetErrorString((cudaError_t)code);
}

// diag, rhs, hr, hr_prev, x: (n, k) float32 contiguous; obs: (n, k) bytes,
// nonzero where observed.  The launch shape as row_blocks checks it (the
// wrapper's solve_plan): tpr threads a row, k <= RES_MAX (cs 1); cs blocks
// a row of seg positions, over a cluster up to CLUSTER_MAX, segmented
// beyond, then with totals: (n, cs, 9) floats of scratch.
int mt_solve(const float* diag, const float* rhs, const float* hr, const float* hr_prev,
             const uint8_t* obs, float* x, float* totals, long long n, int k, int tpr, int cs,
             int seg, void* stream) {
  const long long blocks = row_blocks(n, k, tpr, cs, seg);
  if (blocks < 0 || !diag || !rhs || !hr || !hr_prev || !obs || !x ||
      (cs > CLUSTER_MAX && !totals))
    return BAD_ARGUMENT;
  cudaStream_t st = (cudaStream_t)stream;
  if (cs == 1)
    return (int)launch_rows_as<RESIDENT_ROWS>(gappy_kernel<RESIDENT_ROWS>, blocks, cs, GAPPY_SMEM,
                                              st, diag, rhs, hr, hr_prev, obs, x, totals, n, k,
                                              tpr, seg);
  if (cs <= CLUSTER_MAX)
    return (int)launch_rows_as<CLUSTERED>(gappy_kernel<CLUSTERED>, blocks, cs, GAPPY_SMEM, st,
                                          diag, rhs, hr, hr_prev, obs, x, totals, n, k, tpr, seg);
  cudaError_t err = launch_rows_as<SEG_PIVOTS>(gappy_kernel<SEG_PIVOTS>, blocks, cs, GAPPY_SMEM,
                                               st, diag, rhs, hr, hr_prev, obs, x, totals, n, k,
                                               tpr, seg);
  if (err == cudaSuccess)
    err = launch_rows_as<SEG_TOTALS>(gappy_kernel<SEG_TOTALS>, blocks, cs, GAPPY_SMEM, st, diag,
                                     rhs, hr, hr_prev, obs, x, totals, n, k, tpr, seg);
  if (err == cudaSuccess)
    err = launch_rows_as<SEG_SOLVE>(gappy_kernel<SEG_SOLVE>, blocks, cs, GAPPY_SMEM, st, diag,
                                    rhs, hr, hr_prev, obs, x, totals, n, k, tpr, seg);
  return (int)err;
}

}  // extern "C"
