// Stage math shared by the fused Neural CDE kernels (fused_fixed.cu,
// fused_reversible.cu, with C known at compile time): the control's rows and
// dX/dt, the contraction k = g . dX/dt of the canonical vector field's output
// g = tanh(W2 relu(W1 y + b1) + b2), the bfloat16 rounding of K1's
// mixed-precision mode, and the launch helpers both use.
//
// Replaces the stage math of the TPU kernels,
// torchcde_tpu/solvers/fused_pallas.py::_stage_forward.
//
// Layouts (float32): w1t (W, H), b1 (W), w2t (C*H, W), b2 (C*H); the rows of
// w2t and b2 are in the kernel order q = i*H + h.
//
// Mixed precision (the MX flag, fused_fixed.cu's bfloat16 mode only): the
// operands of each stage product are rounded to bfloat16 where the TPU
// kernels feed bfloat16 to their matrix unit (_dot, _dg), and every sum stays
// float32.  The flag defaults off, and then every rounding is the identity.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory a block may use
constexpr int BAD_ARGUMENT = -2;

// x rounded to the nearest bfloat16 when MX, else x.
template <bool MX>
__device__ __forceinline__ float mx_round(float x) {
  return MX ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Slab storage: float32, or bfloat16 (upcast on load, stored rounded).
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// dX/dt at fraction fr of the interval: b + (2c + 3d fr) fr.
template <int C>
__device__ __forceinline__ void control_derivative(const float (&sb)[C],
                                                   const float (&sc)[C],
                                                   const float (&sd)[C],
                                                   float fr, float (&dx)[C]) {
#pragma unroll
  for (int i = 0; i < C; ++i) dx[i] = sb[i] + (sc[i] + sd[i] * fr) * fr;
}

// The rows b, 2c, 3d of interval j for one lane, from ct (n, 3, C, B) of
// float or bfloat16; zero for a lane past the batch.
template <int H, int C, typename T = float>
__device__ __forceinline__ void load_slab(const T* __restrict__ ct, int j,
                                          int B, int lane, bool live,
                                          float (&sb)[C], float (&sc)[C],
                                          float (&sd)[C]) {
  const T* row = ct + (size_t)j * 3 * C * B + lane;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    sb[i] = live ? to_float(row[(size_t)i * B]) : 0.f;
    sc[i] = live ? to_float(row[(size_t)(C + i) * B]) : 0.f;
    sd[i] = live ? to_float(row[(size_t)(2 * C + i) * B]) : 0.f;
  }
}

// k_h = sum_i g[i*H + h] dx_i
template <int H, int C>
__device__ __forceinline__ void contract(const float (&g)[C * H],
                                         const float (&dx)[C], float (&k)[H]) {
#pragma unroll
  for (int h = 0; h < H; ++h) {
    float acc = g[h] * dx[0];
#pragma unroll
    for (int i = 1; i < C; ++i) acc += g[i * H + h] * dx[i];
    k[h] = acc;
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Blocks of `kernel` an SM holds at once with these threads and shared
// bytes, into n; 0 or an error code.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, size_t bytes, int& n) {
  cudaError_t err = set_smem(kernel, bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, bytes);
  return (int)err;
}

}  // namespace
