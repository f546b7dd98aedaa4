// Batched tridiagonal solve (K4), as a CUDA kernel for Hopper (sm_90a).
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
// 3.35 TB/s; the 0.27 GFLOP are nothing.  Bytes bound it, but a sequential
// recurrence with one thread per row leaves the card with few warps (8192
// rows are 256 warps), so in practice latency does.
//
// Design.  One thread per row runs the Thomas algorithm exactly as the JAX
// package's tridiagonal_solve_thomas orders it (forward elimination, then
// back substitution), so against that function the kernel differs only by
// rounding (and by fused multiply-adds).  The TPU kernel's PCR levels,
// interleaved slabs and the pre-split of lengths over 1024 exist only to
// fill vector lanes and fit VMEM; they have no counterpart.  The eliminated
// right-hand side is kept in x itself (the thread's own row); the
// eliminated diagonal goes to a length-major (k, n) scratch from PyTorch's
// allocator, so a warp's accesses to it are coalesced.  Each sweep loads
// the operands of STEP positions before it computes them: the loads do not
// depend on the recurrence, so STEP of them are in flight at once instead
// of one memory latency per position.  Blocks are one warp, so the rows
// spread over every SM (128-thread blocks left half of them idle at 8192
// rows).

#include <cuda_runtime.h>

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

}  // namespace

extern "C" {

const char* td_error_string(int code) {
  if (code == BAD_ARGUMENT) return "invalid argument";
  return cudaGetErrorString((cudaError_t)code);
}

// b (n, k) and x (n, k) contiguous; u, l rows of k - 1 and d rows of k at
// row strides su, sl, sd (0: one band for every row); nd: (k, n) scratch.
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

}  // extern "C"
