// Stage math shared by the fused Neural CDE kernels' specialised variants
// (fused_fixed.cu, fused_reversible.cu, with H and C known at compile
// time): the control's rows and dX/dt, and one evaluation of the canonical
// vector field k = tanh(W2 relu(W1 y + b1) + b2) . dX/dt for one batch lane
// per thread, as the forwards run it.
//
// Replaces the stage math of the TPU kernels,
// torchcde_tpu/solvers/fused_pallas.py::_stage_forward.
//
// Weights sit in shared memory and are read as warp-wide broadcasts; the
// hidden layer streams over W, so h1 never sits in registers whole.
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

namespace {

constexpr int LANES = 32;  // threads per block of the forwards, one batch lane each

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

template <int H, int C>
struct Smem {
  static constexpr int CH = C * H;
  float* w1;  // [W][H]
  float* w2;  // [W][CH]
  float* b1;  // [W]
  float* b2;  // [CH]
  __device__ explicit Smem(float* base, int W)
      : w1(base), w2(base + W * H), b1(base + W * H + W * CH),
        b2(base + W * H + W * CH + W) {}
  static constexpr size_t floats(int W) { return (size_t)W * H + (size_t)W * CH + W + CH; }
};

template <int H, int C>
__device__ void load_field(const Smem<H, C>& s, const float* __restrict__ w1t,
                           const float* __restrict__ b1,
                           const float* __restrict__ w2t,
                           const float* __restrict__ b2, int W) {
  constexpr int CH = C * H;
  for (int i = threadIdx.x; i < W * H; i += blockDim.x) s.w1[i] = w1t[i];
  for (int i = threadIdx.x; i < W * CH; i += blockDim.x) {
    const int w = i / CH, q = i - w * CH;
    s.w2[i] = w2t[q * W + w];
  }
  for (int i = threadIdx.x; i < W; i += blockDim.x) s.b1[i] = b1[i];
  for (int i = threadIdx.x; i < CH; i += blockDim.x) s.b2[i] = b2[i];
}

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

// g = tanh(W2 relu(W1 y + b1) + b2), streaming the hidden layer over W.
// With MX, y is rounded once before the W1 products and each h1_w before
// it is folded into the W2 products.
template <int H, int C, bool MX = false>
__device__ __forceinline__ void mlp_forward(const Smem<H, C>& s, int W,
                                            const float (&y)[H],
                                            float (&g)[C * H]) {
  constexpr int CH = C * H;
  float pre2[CH], yr[H];
#pragma unroll
  for (int q = 0; q < CH; ++q) pre2[q] = 0.f;
#pragma unroll
  for (int h = 0; h < H; ++h) yr[h] = mx_round<MX>(y[h]);
  for (int w = 0; w < W; ++w) {
    const float* r1 = s.w1 + w * H;
    float a = 0.f;
#pragma unroll
    for (int h = 0; h < H; ++h) a = fmaf(r1[h], yr[h], a);
    a += s.b1[w];
    a = (a < 0.f) ? 0.f : a;
    const float ar = mx_round<MX>(a);
    const float* r2 = s.w2 + w * CH;
#pragma unroll
    for (int q = 0; q < CH; ++q) pre2[q] = fmaf(r2[q], ar, pre2[q]);
  }
#pragma unroll
  for (int q = 0; q < CH; ++q) g[q] = tanhf(pre2[q] + s.b2[q]);
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

}  // namespace
