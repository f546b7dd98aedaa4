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
// Two routes; the wrapper (ops/tridiagonal_kernel.py, solve_plan) picks one.
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
// Per-row bands, or rows longer than RES_MAX: thomas_kernel, one thread
// per row running the Thomas algorithm exactly as the JAX package's
// tridiagonal_solve_thomas orders it (forward elimination, then back
// substitution), so against that function it differs only by rounding (and
// by fused multiply-adds).  The eliminated right-hand side is kept in x
// itself (the thread's own row); the eliminated diagonal goes to a
// length-major (k, n) scratch from PyTorch's allocator, so a warp's
// accesses to it are coalesced.  Each sweep loads the operands of STEP
// positions before it computes them: the loads do not depend on the
// recurrence, so STEP of them are in flight at once instead of one memory
// latency per position.  Blocks are one warp, so the rows spread over every
// SM.
//
// The TPU kernel's PCR levels, interleaved slabs and the pre-split of
// lengths over 1024 exist only to fill vector lanes and fit VMEM; they have
// no counterpart.  Every route runs in a fixed order without atomics: two
// launches give the same bits.

#include <cuda_runtime.h>

#include "row_scan.cuh"

namespace {

constexpr int THREADS = 32;  // one warp per block: the rows spread over every SM
constexpr int STEP = 16;  // positions whose operands are loaded together
constexpr int BAD_ARGUMENT = -2;

__global__ void __launch_bounds__(THREADS)
    thomas_kernel(const float* __restrict__ b, const float* __restrict__ u,
                  const float* __restrict__ d, const float* __restrict__ l,
                  float* __restrict__ x, float* __restrict__ nd, long long n,
                  int k, long long sb, long long su, long long sd,
                  long long sl) {
  const long long row = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (row >= n) return;
  const float* br = b + row * sb;
  const float* ur = u + row * su;
  const float* dr = d + row * sd;
  const float* lr = l + row * sl;
  float* xr = x + row * (long long)k;
  // Forward elimination: nd_i = d_i - (l_{i-1} / nd_{i-1}) u_{i-1};
  // nb_i likewise; nb is stored in x, nd in the length-major scratch.
  float prev_d = dr[0], prev_b = br[0];
  nd[row] = prev_d;
  xr[0] = prev_b;
  for (int i0 = 1; i0 < k; i0 += STEP) {
    float lv[STEP], uv[STEP], dv[STEP], bv[STEP];
#pragma unroll
    for (int s = 0; s < STEP; ++s) {
      const int i = i0 + s;
      if (i < k) {
        lv[s] = lr[i - 1];
        uv[s] = ur[i - 1];
        dv[s] = dr[i];
        bv[s] = br[i];
      }
    }
#pragma unroll
    for (int s = 0; s < STEP; ++s) {
      const int i = i0 + s;
      if (i < k) {
        const float w = lv[s] / prev_d;
        prev_d = dv[s] - w * uv[s];
        prev_b = bv[s] - w * prev_b;
        nd[(long long)i * n + row] = prev_d;
        xr[i] = prev_b;
      }
    }
  }
  // Back substitution: x_i = (nb_i - u_i x_{i+1}) / nd_i.
  float x_next = prev_b / prev_d;
  xr[k - 1] = x_next;
  for (int i0 = k - 2; i0 >= 0; i0 -= STEP) {
    float bv[STEP], uv[STEP], dv[STEP];
#pragma unroll
    for (int s = 0; s < STEP; ++s) {
      const int i = i0 - s;
      if (i >= 0) {
        bv[s] = xr[i];
        uv[s] = ur[i];
        dv[s] = nd[(long long)i * n + row];
      }
    }
#pragma unroll
    for (int s = 0; s < STEP; ++s) {
      const int i = i0 - s;
      if (i >= 0) {
        x_next = (bv[s] - uv[s] * x_next) / dv[s];
        xr[i] = x_next;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Shared bands: the pivots once, then each row resident.

constexpr size_t BAND_SMEM = sizeof(float) * (RES_BUF + RT / 32 * SCAN_SLOT);

// piv (3, P), P = tpr * RP: rows w, r, c as above, zero at positions past k.
// One block of RT threads; the first tpr of them hold the band (RP
// positions each) and write, the rest run the same scan on nothing.
__global__ void __launch_bounds__(RT)
    band_pivot_kernel(const float* __restrict__ u, const float* __restrict__ d,
                      const float* __restrict__ l, float* __restrict__ piv, int k, int tpr) {
  __shared__ float scratch[RT / 32 * SCAN_SLOT];
  const int tid = threadIdx.x, j0 = (tid % tpr) * RP, P = tpr * RP;
  const bool mine = tid < tpr;
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
  mob = row_scan<MoebiusOp, false>(mob, tpr, scratch);
  if (!mine) return;
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

// x (n, k) from b (n, k) and the pivots of band_pivot_kernel: tpr threads a
// row, RT / tpr rows a block.  Five blocks an SM: the cap of 48 registers a
// thread costs a few bytes of spills, and on an H100 at config 3 it ran
// faster than three or four blocks without them, or six (PERF.md).
__global__ void __launch_bounds__(RT, 5)
    shared_band_kernel(const float* __restrict__ b, const float* __restrict__ piv,
                       float* __restrict__ x, long long n, int k, int tpr) {
  extern __shared__ float band_smem[];
  float* buf = band_smem;            // [RES_BUF] the block's rows of b, then of x
  float* scratch = buf + RES_BUF;    // [RT / 32][SCAN_SLOT] the scans' warp totals
  const int rpb = RT / tpr, P = tpr * RP;
  const long long row0 = (long long)blockIdx.x * rpb;
  const int rows = (int)(n - row0 < rpb ? n - row0 : rpb);
  const int tid = threadIdx.x, rb = tid / tpr, j0 = (tid % tpr) * RP;
  const bool live = rb < rows;

  // Stage the block's rows of b (one contiguous range), coalesced.
  const float* bb = b + row0 * k;
  for (int i = tid; i < rows * k; i += RT) buf[staged(i)] = bb[i];
  float v[RP], w[RP];
  const float4* p4 = reinterpret_cast<const float4*>(piv + j0);
#pragma unroll
  for (int q = 0; q < RP / 4; ++q) {
    const float4 a = p4[q];
    w[4 * q] = a.x, w[4 * q + 1] = a.y, w[4 * q + 2] = a.z, w[4 * q + 3] = a.w;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < RP; ++s) v[s] = live && j0 + s < k ? buf[staged(rb * k + j0 + s)] : 0.f;

  // Elimination: nb_j = b_j - w_j nb_{j-1}, the map nb -> -w_j nb + b_j.
  Vec<2> aff = AffineOp::identity();
#pragma unroll
  for (int s = 0; s < RP; ++s) aff = AffineOp::compose(aff, {{-w[s], v[s]}});
  aff = row_scan<AffineOp, false>(aff, tpr, scratch);
  float carry = aff.v[1];  // applied to nb_{-1} = 0
#pragma unroll
  for (int s = 0; s < RP; ++s) {
    carry = v[s] - w[s] * carry;
    v[s] = carry;
  }
  float r[RP], c[RP];
#pragma unroll
  for (int q = 0; q < RP / 4; ++q) {
    const float4 e = p4[P / 4 + q], f = p4[P / 2 + q];
    r[4 * q] = e.x, r[4 * q + 1] = e.y, r[4 * q + 2] = e.z, r[4 * q + 3] = e.w;
    c[4 * q] = f.x, c[4 * q + 1] = f.y, c[4 * q + 2] = f.z, c[4 * q + 3] = f.w;
  }
  // Substitution: x_j = r_j nb_j - c_j x_{j+1}, in reverse (c_{k-1} = 0).
  aff = AffineOp::identity();
#pragma unroll
  for (int s = RP - 1; s >= 0; --s) aff = AffineOp::compose(aff, {{-c[s], r[s] * v[s]}});
  aff = row_scan<AffineOp, true>(aff, tpr, scratch);
  carry = aff.v[1];  // applied to x_k = 0
#pragma unroll
  for (int s = RP - 1; s >= 0; --s) {
    carry = r[s] * v[s] - c[s] * carry;
    v[s] = carry;
  }
  __syncthreads();  // every read of b in buf is done
#pragma unroll
  for (int s = 0; s < RP; ++s)
    if (live && j0 + s < k) buf[staged(rb * k + j0 + s)] = v[s];
  __syncthreads();
  float* xb = x + row0 * k;
  for (int i = tid; i < rows * k; i += RT) xb[i] = buf[staged(i)];
}

}  // namespace

extern "C" {

const char* td_error_string(int code) {
  if (code == BAD_ARGUMENT) return "invalid argument";
  return cudaGetErrorString((cudaError_t)code);
}

// b (n, k) and x (n, k) contiguous; u, l rows of k - 1 and d rows of k at
// row strides su, sl, sd (0: one band for every row); nd: (k, n) scratch.
// The thomas_kernel route.
int td_solve(const float* b, const float* u, const float* d, const float* l,
             float* x, float* nd, long long n, int k, long long sb,
             long long su, long long sd, long long sl, void* stream) {
  if (n <= 0 || k <= 0 || !b || !d || !x || !nd ||
      (k > 1 && (!u || !l)) || (n + THREADS - 1) / THREADS > 0x7fffffffLL)
    return BAD_ARGUMENT;
  const long long blocks = (n + THREADS - 1) / THREADS;
  thomas_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      b, u, d, l, x, nd, n, k, sb, su, sd, sl);
  return (int)cudaGetLastError();
}

// The shared-band route: b (n, k) and x (n, k) contiguous, one band each
// (u, l of k - 1, d of k); piv: (3, tpr * RP) scratch, 16-byte aligned;
// tpr threads a row, a power of two with tpr * RP >= k (the wrapper's
// solve_plan).
int td_solve_shared(const float* b, const float* u, const float* d, const float* l,
                    float* x, float* piv, long long n, int k, int tpr, void* stream) {
  if (n <= 0 || k <= 0 || k > RES_MAX || !b || !d || !x || !piv || (k > 1 && (!u || !l)) ||
      tpr < 1 || tpr > RT || (tpr & (tpr - 1)) || (long long)tpr * RP < k ||
      (reinterpret_cast<size_t>(piv) & 15))
    return BAD_ARGUMENT;
  const long long rpb = RT / tpr, blocks = (n + rpb - 1) / rpb;
  if (blocks > 0x7fffffffLL) return BAD_ARGUMENT;
  cudaStream_t st = (cudaStream_t)stream;
  band_pivot_kernel<<<1, RT, 0, st>>>(u, d, l, piv, k, tpr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  shared_band_kernel<<<(unsigned)blocks, RT, BAND_SMEM, st>>>(b, piv, x, n, k, tpr);
  return (int)cudaGetLastError();
}

}  // extern "C"
