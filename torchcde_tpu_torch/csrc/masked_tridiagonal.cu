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
// Two routes; the wrapper (ops/masked_tridiagonal_kernel.py, solve_plan)
// picks one from k.
//
// Rows of k <= RES_MAX: resident_gappy_kernel.  Each row stays on chip
// from its operands to x, laid out as K6/K7's and K4's resident rows
// (row_scan.cuh): a row belongs to a power of two of threads, RP positions
// a thread, short rows sharing a block of RT threads.  The block's rows are
// one contiguous range of each operand, staged into shared memory with
// coalesced loads (staged()'s padding), the mask packed into one bit a
// position by warp ballots, so each operand is read once and x written
// once, out through shared memory in the same way.  The reference
// recurrences (torchcde_tpu/interpolation/cubic.py::
// _masked_thomas_observed), with missing positions the identity in each,
// become chunk-local passes joined by scans across the row:
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
// Like the reference, the route guards no division: the TPU kernels' 1e-30
// floors exist for their rescaling only.
//
// Rows longer than RES_MAX: masked_thomas_kernel, one thread per row
// running the reference recurrence as written: a forward elimination and a
// back substitution, both in one launch.  The eliminated right-hand side is
// kept in x (the thread's own row); the eliminated diagonal goes to a
// length-major (k, n) scratch from PyTorch's allocator, so a warp's
// accesses to it are coalesced.  Each sweep loads the operands of STEP
// positions before it computes them, so STEP loads are in flight at once.
// Blocks are one warp, so the rows spread over every SM.
//
// Every route runs in a fixed order without atomics: two launches give the
// same bits.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_scan.cuh"

namespace {

constexpr int THREADS = 32;  // one warp per block: the rows spread over every SM
constexpr int STEP = 16;  // positions whose operands are loaded together
constexpr int BAD_ARGUMENT = -2;

__global__ void __launch_bounds__(THREADS)
    masked_thomas_kernel(const float* __restrict__ diag,
                         const float* __restrict__ rhs,
                         const float* __restrict__ hr,
                         const float* __restrict__ hr_prev,
                         const uint8_t* __restrict__ obs,
                         float* __restrict__ x, float* __restrict__ nd,
                         long long n, int k) {
  const long long row = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (row >= n) return;
  const size_t base = (size_t)row * (size_t)k;
  const float* dr = diag + base;
  const float* rr = rhs + base;
  const float* hrr = hr + base;
  const float* hpr = hr_prev + base;
  const uint8_t* o = obs + base;
  float* xr = x + base;
  // Forward elimination over observed rows; missing rows store (1, 0) and
  // leave the carry as it was.
  float prev_d = 1.f, prev_b = 0.f;
  for (int i0 = 0; i0 < k; i0 += STEP) {
    float dv[STEP], rv[STEP], hv[STEP];
    bool ov[STEP];
#pragma unroll
    for (int s = 0; s < STEP; ++s) {
      const int i = i0 + s;
      if (i < k) {
        ov[s] = o[i] != 0;
        dv[s] = dr[i];
        rv[s] = rr[i];
        hv[s] = hpr[i];
      }
    }
#pragma unroll
    for (int s = 0; s < STEP; ++s) {
      const int i = i0 + s;
      if (i < k) {
        float out_d = 1.f, out_b = 0.f;
        if (ov[s]) {
          const float w = hv[s] / prev_d;
          prev_d = dv[s] - w * hv[s];
          prev_b = rv[s] - w * prev_b;
          out_d = prev_d;
          out_b = prev_b;
        }
        nd[(long long)i * n + row] = out_d;
        xr[i] = out_b;
      }
    }
  }
  // Back substitution: x_i = (nb_i - hr_i x_next) / nd_i at observed rows,
  // x_next the solution at the next observed row (0 past the last).
  float x_next = 0.f;
  for (int i0 = k - 1; i0 >= 0; i0 -= STEP) {
    float bv[STEP], hv[STEP], dv[STEP];
    bool ov[STEP];
#pragma unroll
    for (int s = 0; s < STEP; ++s) {
      const int i = i0 - s;
      if (i >= 0) {
        ov[s] = o[i] != 0;
        bv[s] = xr[i];
        hv[s] = hrr[i];
        dv[s] = nd[(long long)i * n + row];
      }
    }
#pragma unroll
    for (int s = 0; s < STEP; ++s) {
      const int i = i0 - s;
      if (i >= 0) {
        float xi = 0.f;
        if (ov[s]) {
          xi = (bv[s] - hv[s] * x_next) / dv[s];
          x_next = xi;
        }
        xr[i] = xi;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Resident route: a row's RP-position chunks in the registers of
// threads_per_row (tpr) consecutive threads, its three recurrences joined by
// scans across them (row_scan.cuh).

constexpr int MASK_WORDS = RES_MAX / 32 + 1;  // the block's mask bits, and a word past them
constexpr size_t GAPPY_SMEM =
    sizeof(float) * (3 * RES_BUF + RT / 32 * SCAN_SLOT) + sizeof(unsigned) * MASK_WORDS;

// x (n, k) from the operands (n, k): tpr threads a row, RT / tpr rows a
// block, four blocks an SM (64 registers a thread, no spills on an H100).
__global__ void __launch_bounds__(RT, 4)
    resident_gappy_kernel(const float* __restrict__ diag, const float* __restrict__ rhs,
                          const float* __restrict__ hr, const float* __restrict__ hr_prev,
                          const uint8_t* __restrict__ obs, float* __restrict__ x,
                          long long n, int k, int tpr) {
  extern __shared__ float gappy_smem[];
  float* sd = gappy_smem;           // [RES_BUF] the block's rows of diag, then hr, then x
  float* sr = sd + RES_BUF;         // [RES_BUF] rhs
  float* sp = sr + RES_BUF;         // [RES_BUF] hr_prev
  float* scratch = sp + RES_BUF;    // [RT / 32][SCAN_SLOT] the scans' warp totals
  unsigned* bits = reinterpret_cast<unsigned*>(scratch + RT / 32 * SCAN_SLOT);  // [MASK_WORDS]
  const int rpb = RT / tpr;         // rows per block
  const long long row0 = (long long)blockIdx.x * rpb;
  const int rows = (int)(n - row0 < rpb ? n - row0 : rpb);
  const int tid = threadIdx.x, rb = tid / tpr, j0 = (tid % tpr) * RP;
  const bool live = rb < rows;
  const int total = rows * k;
  const size_t base = (size_t)row0 * (size_t)k;

  // Stage the block's rows of diag, rhs and hr_prev (one contiguous range
  // of each), coalesced; bit i of the mask words is element i's (a warp's
  // ballot covers 32 consecutive elements, starting at a multiple of 32).
#pragma unroll 4
  for (int i0 = 0; i0 < total; i0 += RT) {
    const int i = i0 + tid;
    bool o = false;
    if (i < total) {
      const int s = staged(i);
      sd[s] = diag[base + i];
      sr[s] = rhs[base + i];
      sp[s] = hr_prev[base + i];
      o = obs[base + i] != 0;
    }
    const unsigned word = __ballot_sync(0xffffffffu, o);
    if ((tid & 31) == 0) bits[i >> 5] = word;
  }
  __syncthreads();

  // The thread's positions' mask bits (none for a thread past the rows or
  // the row's end); element u of its chunk is at staged(p0 + u).
  const int p0 = rb * k + j0;
  unsigned ob = 0u;
  if (live && j0 < k) {
    const int w = p0 >> 5, off = p0 & 31;
    unsigned long long window = bits[w];
    if (off > 32 - RP) window |= (unsigned long long)bits[w + 1] << 32;
    ob = (unsigned)(window >> off) & ((1u << RP) - 1u);
    if (k - j0 < RP) ob &= (1u << (k - j0)) - 1u;
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
  mob = row_scan<MoebiusOp, false>(mob, tpr, scratch);
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
  aff = row_scan<AffineOp, false>(aff, tpr, scratch);
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
  aff = row_scan<AffineOp, true>(aff, tpr, scratch);
  float x_next = aff.v[1];
#pragma unroll
  for (int u = RP - 1; u >= 0; --u) {
    const int s = staged(p0 + u);
    float xi = 0.f;
    if (OBS(u)) {
      xi = (nb[u] - sd[s] * x_next) * nd[u];
      x_next = xi;
    }
    if (live && j0 + u < k) sd[s] = xi;
  }
#undef OBS
  __syncthreads();
  float* xb = x + base;
  for (int i = tid; i < total; i += RT) xb[i] = sd[staged(i)];
}

}  // namespace

extern "C" {

const char* mt_error_string(int code) {
  if (code == BAD_ARGUMENT) return "invalid argument";
  return cudaGetErrorString((cudaError_t)code);
}

// The long-row route: diag, rhs, hr, hr_prev, x: (n, k) float32
// contiguous; obs: (n, k) bytes, nonzero where observed; nd: (k, n) scratch.
int mt_solve(const float* diag, const float* rhs, const float* hr,
             const float* hr_prev, const uint8_t* obs, float* x, float* nd,
             long long n, int k, void* stream) {
  if (n <= 0 || k <= 0 || !diag || !rhs || !hr || !hr_prev || !obs || !x ||
      !nd || (n + THREADS - 1) / THREADS > 0x7fffffffLL)
    return BAD_ARGUMENT;
  const long long blocks = (n + THREADS - 1) / THREADS;
  masked_thomas_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      diag, rhs, hr, hr_prev, obs, x, nd, n, k);
  return (int)cudaGetLastError();
}

// The resident route: the operands and x as for mt_solve, k <= RES_MAX;
// tpr threads a row, a power of two with tpr * RP >= k (the wrapper's
// solve_plan), RT / tpr rows a block.
int mt_solve_resident(const float* diag, const float* rhs, const float* hr,
                      const float* hr_prev, const uint8_t* obs, float* x, long long n,
                      int k, int tpr, void* stream) {
  if (n <= 0 || k <= 0 || k > RES_MAX || !diag || !rhs || !hr || !hr_prev || !obs || !x ||
      tpr < 1 || tpr > RT || (tpr & (tpr - 1)) || (long long)tpr * RP < k)
    return BAD_ARGUMENT;
  const long long rpb = RT / tpr, blocks = (n + rpb - 1) / rpb;
  if (blocks > 0x7fffffffLL) return BAD_ARGUMENT;
  cudaError_t err = cudaFuncSetAttribute(resident_gappy_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)GAPPY_SMEM);
  if (err != cudaSuccess) return (int)err;
  resident_gappy_kernel<<<(unsigned)blocks, RT, GAPPY_SMEM, (cudaStream_t)stream>>>(
      diag, rhs, hr, hr_prev, obs, x, n, k, tpr);
  return (int)cudaGetLastError();
}

}  // extern "C"
