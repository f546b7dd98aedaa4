// Stage math shared by the fused Neural CDE kernels (fused_fixed.cu,
// fused_dopri.cu, fused_reversible.cu): one evaluation of the canonical
// vector field k = tanh(W2 relu(W1 y + b1) + b2) . dX/dt for one batch lane
// per thread, with H and C known at compile time, and its vector-Jacobian
// product.
//
// Replaces the stage math of the TPU kernels,
// torchcde_tpu/solvers/fused_pallas.py::_stage_forward and ::_stage_backward.
//
// Weights sit in shared memory and are read as warp-wide broadcasts; the
// hidden layer streams over W, so h1 never sits in registers whole.  The VJP
// reduces the weight gradients over the block's lanes in shared memory, one
// owning thread per element, so the sums are deterministic.
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

constexpr int LANES = 32;       // threads per block, one batch lane each
constexpr int PAD = LANES + 1;  // row stride of the per-lane staging buffers

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
  __device__ float* end() const { return b2 + CH; }
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
// With STAGE_H1, each h1_w is also stored in column threadIdx.x of h1buf.
// With MX, y is rounded once before the W1 products and each h1_w before
// it is folded into the W2 products (the staged h1_w is the unrounded one).
template <int H, int C, bool STAGE_H1, bool MX = false>
__device__ __forceinline__ void mlp_forward(const Smem<H, C>& s, int W,
                                            const float (&y)[H],
                                            float (&g)[C * H], float* h1buf) {
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
    if (STAGE_H1) h1buf[w * PAD + threadIdx.x] = a;
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

template <int H, int C>
struct BwdSmem {
  static constexpr int CH = C * H;
  Smem<H, C> field;
  float* h1;      // [W][PAD]   h1 of the stage, column = lane
  float* dpre1;   // [W][PAD]
  float* dpre2;   // [LANES][CH]
  float* y;       // [LANES][H]
  float* acc_w1;  // [W][H]
  float* acc_w2;  // [W][CH]
  float* acc_b1;  // [W]
  float* acc_b2;  // [CH]
  __device__ BwdSmem(float* base, int W) : field(base, W) {
    h1 = field.end();
    dpre1 = h1 + W * PAD;
    dpre2 = dpre1 + W * PAD;
    y = dpre2 + LANES * CH;
    acc_w1 = y + LANES * H;
    acc_w2 = acc_w1 + W * H;
    acc_b1 = acc_w2 + W * CH;
    acc_b2 = acc_b1 + W;
  }
  __device__ float* end() const { return acc_b2 + CH; }
  static constexpr size_t floats(int W) {
    return 2 * Smem<H, C>::floats(W) + 2 * (size_t)W * PAD + (size_t)LANES * CH +
           (size_t)LANES * H;
  }
  // Zero the weight-gradient accumulators (the caller synchronises).
  __device__ void zero_acc(int W) const {
    for (int i = threadIdx.x; i < W * H; i += blockDim.x) acc_w1[i] = 0.f;
    for (int i = threadIdx.x; i < W * CH; i += blockDim.x) acc_w2[i] = 0.f;
    for (int i = threadIdx.x; i < W; i += blockDim.x) acc_b1[i] = 0.f;
    for (int i = threadIdx.x; i < CH; i += blockDim.x) acc_b2[i] = 0.f;
  }
  // Write this block's accumulators to its slice of the partials.
  __device__ void store_acc(int W, float* dw1p, float* db1p, float* dw2p,
                            float* db2p) const {
    const size_t blk = blockIdx.x;
    for (int i = threadIdx.x; i < W * H; i += blockDim.x) dw1p[blk * W * H + i] = acc_w1[i];
    for (int i = threadIdx.x; i < W * CH; i += blockDim.x) dw2p[blk * W * CH + i] = acc_w2[i];
    for (int i = threadIdx.x; i < W; i += blockDim.x) db1p[blk * W + i] = acc_b1[i];
    for (int i = threadIdx.x; i < CH; i += blockDim.x) db2p[blk * CH + i] = acc_b2[i];
  }
};

// VJP of one vector-field evaluation k = contract(mlp(y), dx) for cotangent
// u of k: returns dy and ddx, and adds this stage's weight gradients, summed
// over the block's lanes, to the shared accumulators.  With k, the
// evaluation itself is returned too.  Every thread of the block calls it
// (lanes past the batch with zero state and cotangent).
//
// With MX, the backward products take rounded operands as the TPU kernel's
// _stage_backward does (dpre2 in dW2 and dh1, h1 in dW2, dpre1 in dW1 and
// dy, y in dW1), while db1 and db2 sum the unrounded dpre1 and dpre2: dpre2
// and y are staged rounded, h1 and dpre1 unrounded and rounded where dW2 and
// dW1 read them, and db2 is summed across the warp (the block) by shuffles.
// The matrix-free contraction (H % 8 == 0) has no rounding.
template <int H, int C, bool MX = false>
__device__ void stage_vjp(const BwdSmem<H, C>& sm, int W, const float (&u)[H],
                          const float (&y)[H], const float (&dx)[C],
                          float (&dy)[H], float (&ddx)[C],
                          float (*k)[H] = nullptr) {
  static_assert(!MX || H % 8 == 0, "the padded layout's rounding is the generic variant's");
  constexpr int CH = C * H;
  const int tid = threadIdx.x;
  float g[CH];
  mlp_forward<H, C, true, MX>(sm.field, W, y, g, sm.h1);
  if (k) contract<H, C>(g, dx, *k);

  float dp2[CH];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int q = i * H + h;
      acc += u[h] * g[q];
      dp2[q] = (u[h] * dx[i]) * (1.f - g[q] * g[q]);
    }
    ddx[i] = acc;
  }
  if (MX) {
    // db2 from the unrounded dpre2, summed over the block's 32 lanes.
    static_assert(LANES == 32, "one warp per block");
#pragma unroll
    for (int q = 0; q < CH; ++q) {
      float v = dp2[q];
#pragma unroll
      for (int off = LANES / 2; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (tid == 0) sm.acc_b2[q] += v;
      dp2[q] = mx_round<MX>(dp2[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < CH; ++q) sm.dpre2[tid * CH + q] = dp2[q];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    sm.y[tid * H + h] = mx_round<MX>(y[h]);
    dy[h] = 0.f;
  }
  for (int w = 0; w < W; ++w) {
    const float* r2 = sm.field.w2 + w * CH;
    float dh = 0.f;
#pragma unroll
    for (int q = 0; q < CH; ++q) dh = fmaf(r2[q], dp2[q], dh);
    const float dp1 = sm.h1[w * PAD + tid] > 0.f ? dh : 0.f;
    sm.dpre1[w * PAD + tid] = dp1;
    const float dp1r = mx_round<MX>(dp1);
    const float* r1 = sm.field.w1 + w * H;
#pragma unroll
    for (int h = 0; h < H; ++h) dy[h] = fmaf(r1[h], dp1r, dy[h]);
  }
  __syncthreads();

  // Thread tid owns weight columns w = tid, tid + LANES, ...
  for (int w = tid; w < W; w += LANES) {
    float a2[CH], a1[H], ab1 = 0.f;
#pragma unroll
    for (int q = 0; q < CH; ++q) a2[q] = 0.f;
#pragma unroll
    for (int h = 0; h < H; ++h) a1[h] = 0.f;
    for (int l = 0; l < LANES; ++l) {
      const float hv = mx_round<MX>(sm.h1[w * PAD + l]);
      const float pv = sm.dpre1[w * PAD + l];
      const float pvr = mx_round<MX>(pv);
      const float* p2 = sm.dpre2 + l * CH;
      const float* yl = sm.y + l * H;
#pragma unroll
      for (int q = 0; q < CH; ++q) a2[q] = fmaf(p2[q], hv, a2[q]);
#pragma unroll
      for (int h = 0; h < H; ++h) a1[h] = fmaf(pvr, yl[h], a1[h]);
      ab1 += pv;
    }
#pragma unroll
    for (int q = 0; q < CH; ++q) sm.acc_w2[w * CH + q] += a2[q];
#pragma unroll
    for (int h = 0; h < H; ++h) sm.acc_w1[w * H + h] += a1[h];
    sm.acc_b1[w] += ab1;
  }
  if (!MX) {
    for (int q = tid; q < CH; q += LANES) {
      float acc = 0.f;
      for (int l = 0; l < LANES; ++l) acc += sm.dpre2[l * CH + q];
      sm.acc_b2[q] += acc;
    }
  }
  __syncthreads();
}

}  // namespace
