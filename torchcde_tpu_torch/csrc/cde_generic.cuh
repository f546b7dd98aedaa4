// The generic variant of the fixed-step kernels (fused_fixed.cu, K1): H, C
// and W known only at run time, one block of GEN_THREADS threads per batch
// lane, the lane's vectors in shared memory, and the weights read from
// device memory through L1.
//
// Replaces the stage math of the TPU kernels,
// torchcde_tpu/solvers/fused_pallas.py::_stage_forward and ::_stage_backward,
// for the shapes K1's specialised variant (cde_stage.cuh) does not take.
//
// Layouts (float32): w1t (W, H), b1 (W), w2t (C*H, W), b2 (C*H); the rows of
// w2t and b2 are in the kernel order q = i*H + h.  Weight-gradient partials
// of one block: w1 [W][H], b1 [W], w2 [W][C*H], b2 [C*H].
//
// MX (fused_fixed.cu's bfloat16 mode only; off by default): the stage
// products take operands rounded to bfloat16 where they are read, as in
// cde_stage.cuh, and with SEL (H % 8 != 0, the TPU kernel's padded layout)
// so do its selection products.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "cde_stage.cuh"

namespace {

constexpr int GEN_THREADS = 128; // threads per block of the generic variant
constexpr size_t MAX_PARTIALS = size_t(1) << 26;  // floats of generic partials
constexpr int BAD_VARIANT = -3;
constexpr int SPECIALISED = 0;
constexpr int GENERIC = 1;

struct GenField {
  const float* w1t;  // (W, H)
  const float* b1;   // (W)
  const float* w2t;  // (C*H, W)
  const float* b2;   // (C*H)
  int H, C, W;
};

// One block's weight-gradient sums, in the layout of the partials.
struct Grads {
  float* w1;  // [W][H]
  float* b1;  // [W]
  float* w2;  // [W][CH]
  float* b2;  // [CH]
};

// The shared-memory vectors one vector-field evaluation and its VJP use.
struct GenStage {
  float* h1;   // [W]  relu(W1 y + b1)
  float* g;    // [CH] tanh(W2 h1 + b2)
  float* dx;   // [C]  dX/dt, set by the caller
  float* u;    // [H]  the cotangent of the evaluation, set by the caller
  float* dp1;  // [W]
  float* dp2;  // [CH]
};

__host__ __device__ inline size_t partial_floats(int H, int C, int W) {
  return (size_t)W * H + W + (size_t)W * C * H + (size_t)C * H;
}

__host__ __device__ inline size_t take(size_t& top, size_t count) {
  const size_t at = top;
  top += count;
  return at;
}

// h1 = relu(W1 y + b1), then g = tanh(W2 h1 + b2), each output row to one
// thread (with MX, y and h1 rounded as operands; h1 is kept unrounded).
// Starts after, and ends with, a barrier.
template <bool MX = false>
__device__ void gen_mlp(const GenField& f, const float* y, float* h1,
                        float* g) {
  const int H = f.H, W = f.W, CH = f.C * f.H;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const float* r1 = f.w1t + (size_t)w * H;
    float a = 0.f;
    for (int h = 0; h < H; ++h) a = fmaf(r1[h], mx_round<MX>(y[h]), a);
    a += f.b1[w];
    h1[w] = (a < 0.f) ? 0.f : a;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < CH; q += blockDim.x) {
    const float* r2 = f.w2t + (size_t)q * W;
    float a = 0.f;
    for (int w = 0; w < W; ++w) a = fmaf(r2[w], mx_round<MX>(h1[w]), a);
    g[q] = tanhf(a + f.b2[q]);
  }
  __syncthreads();
}

// VJP of one vector-field evaluation k = contract(mlp(y), dx) for the
// cotangent s.u of k, with dx in s.dx: writes dy and adds the stage's weight
// gradients to gr.  Returns ddx_i to thread i < C; s.g keeps the
// evaluation's g.  Starts after, and ends with, a barrier.  With MX, the
// products' operands are rounded as the TPU kernel's _stage_backward rounds
// them, and with sel also u and dx in dg and u g in ddx (the padded
// layout's selection products); db1 and db2 sum the unrounded dpre1, dpre2.
template <bool MX = false>
__device__ float gen_stage_vjp(const GenField& f, const GenStage& s,
                               const float* y, float* dy, const Grads& gr,
                               bool sel = false) {
  const int H = f.H, C = f.C, W = f.W, CH = C * H;
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool rsel = MX && sel;
  gen_mlp<MX>(f, y, s.h1, s.g);
  for (int q = tid; q < CH; q += nt) {
    const int i = q / H, h = q - i * H;
    const float gq = s.g[q];
    const float uh = rsel ? mx_round<true>(s.u[h]) : s.u[h];
    const float dxi = rsel ? mx_round<true>(s.dx[i]) : s.dx[i];
    s.dp2[q] = (uh * dxi) * (1.f - gq * gq);
  }
  float ddx = 0.f;
  if (tid < C) {
    for (int h = 0; h < H; ++h) {
      if (rsel)
        ddx += mx_round<true>(mx_round<true>(s.u[h]) * s.g[tid * H + h]);
      else
        ddx += s.u[h] * s.g[tid * H + h];
    }
  }
  __syncthreads();
  for (int w = tid; w < W; w += nt) {
    float dh = 0.f;
    for (int q = 0; q < CH; ++q)
      dh = fmaf(f.w2t[(size_t)q * W + w], mx_round<MX>(s.dp2[q]), dh);
    s.dp1[w] = s.h1[w] > 0.f ? dh : 0.f;
  }
  __syncthreads();
  for (int h = tid; h < H; h += nt) {
    float acc = 0.f;
    for (int w = 0; w < W; ++w)
      acc = fmaf(f.w1t[(size_t)w * H + h], mx_round<MX>(s.dp1[w]), acc);
    dy[h] = acc;
  }
  for (int e = tid; e < W * H; e += nt) {
    const int w = e / H;
    gr.w1[e] += mx_round<MX>(s.dp1[w]) * mx_round<MX>(y[e - w * H]);
  }
  for (int e = tid; e < W * CH; e += nt) {
    const int w = e / CH;
    gr.w2[e] += mx_round<MX>(s.h1[w]) * mx_round<MX>(s.dp2[e - w * CH]);
  }
  for (int w = tid; w < W; w += nt) gr.b1[w] += s.dp1[w];
  for (int q = tid; q < CH; q += nt) gr.b2[q] += s.dp2[q];
  __syncthreads();
  return ddx;
}

// Blocks of a generic backward launch: one per lane, capped so the
// partials stay under MAX_PARTIALS floats (blocks then stride over lanes).
int gen_backward_blocks(int B, int H, int C, int W) {
  const size_t cap = MAX_PARTIALS / partial_floats(H, C, W);
  return (int)(cap < 1 ? 1 : (cap < (size_t)B ? cap : (size_t)B));
}

}  // namespace
