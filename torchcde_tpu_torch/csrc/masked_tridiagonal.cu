// Gappy ("masked") Thomas solve over the observed knots (K5), as a CUDA
// kernel for Hopper (sm_90a).
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
// ~10 flops per position are nothing.  As for K3 and K4, one thread per row
// leaves the card with few warps, so latency rather than bandwidth binds.
//
// Design.  One thread per row runs the reference recurrence
// (torchcde_tpu/interpolation/cubic.py::_masked_thomas_observed): a forward
// elimination and a back substitution, both in one launch.  The TPU
// kernels' Moebius 2x2 and affine prefix scans, with their rescaling, exist
// only to make the sequential recurrence full-lane vector work; here the
// recurrence runs as written.  The eliminated right-hand side is kept in x
// (the thread's own row); the eliminated diagonal goes to a length-major
// (k, n) scratch from PyTorch's allocator, so a warp's accesses to it are
// coalesced.  Each sweep loads the operands of STEP positions before it
// computes them, so STEP loads are in flight at once.  Blocks are one warp,
// so the rows spread over every SM.

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

extern "C" {

const char* mt_error_string(int code) {
  if (code == BAD_ARGUMENT) return "invalid argument";
  return cudaGetErrorString((cudaError_t)code);
}

// diag, rhs, hr, hr_prev, x: (n, k) float32 contiguous; obs: (n, k) bytes,
// nonzero where observed; nd: (k, n) scratch.
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

}  // extern "C"
