// The adaptive dopri5 step math shared by the two adaptive Neural CDE kernel
// pairs: the whole-group solve (fused_dopri.cu, K2) and the per-lane solve
// (fused_dopri_persample.cu, K9).  One thread per batch lane, blocks of one
// warp (LANES): the dopri5 tableau, the control's dX/dt at a stage time on a
// uniform knot grid (cubic or, left-continuous at knots, linear), the two
// forms of the vector field (specialised, H 8 and C 3 with the weights in
// shared memory; generic, H, C and W at run time with the vectors in a
// per-lane global scratch), an attempted step's stages, error and controller,
// the quartic dense output, and the backward of one accepted step.
//
// Every step function is forced inline: the kernels that call them are
// then the code they were before the step math was shared, and their
// registers hold the lane's values across it.
//
// Replaces the step math of torchcde_tpu/solvers/fused_dopri_pallas.py
// (_dopri_fwd_kernel, _dopri_bwd_kernel) and of
// torchcde_tpu/solvers/fused_dopri_persample.py (_psd_fwd_kernel,
// _psd_bwd_kernel).

#pragma once

#include <stddef.h>
#include <stdint.h>

#include "cde_stage.cuh"

namespace {

constexpr int NS = 7;            // dopri5 stages
constexpr int MAX_ROWS = 16;     // table rows per interval: 3 * C cubic, C linear
constexpr int MAX_OUT = 64;      // output times per chunk (per lane in K9)
constexpr size_t MAX_SMEM = 232448;
constexpr int BAD_ARGUMENT = -2;
constexpr int BAD_VARIANT = -3;
constexpr int SPECIALISED = 0;
constexpr int GENERIC = 1;
// Vectors of a lane.  Forward: the state, the stages, a stage input.
constexpr int Z = 0, K0 = 1, Y = 8, NV_FWD = 9;
// Backward: stage inputs, stages (then their cotangents), lambda and the
// dense output's cotangent terms.
constexpr int YS = 0, KV = 7, LAM = 14, LZ = 15, LZ1 = 16, UMID = 17, E0 = 18,
              E6 = 19, U = 20, NV_BWD = 21;

// The dopri5 tableau, rounded to float32 as the JAX kernels round their
// Python constants.
__constant__ float kAlpha[6] = {
    (float)(1.0 / 5), (float)(3.0 / 10), (float)(4.0 / 5), (float)(8.0 / 9), 1.f, 1.f};
__constant__ float kBeta[6][6] = {
    {(float)(1.0 / 5)},
    {(float)(3.0 / 40), (float)(9.0 / 40)},
    {(float)(44.0 / 45), (float)(-56.0 / 15), (float)(32.0 / 9)},
    {(float)(19372.0 / 6561), (float)(-25360.0 / 2187), (float)(64448.0 / 6561),
     (float)(-212.0 / 729)},
    {(float)(9017.0 / 3168), (float)(-355.0 / 33), (float)(46732.0 / 5247),
     (float)(49.0 / 176), (float)(-5103.0 / 18656)},
    {(float)(35.0 / 384), 0.f, (float)(500.0 / 1113), (float)(125.0 / 192),
     (float)(-2187.0 / 6784), (float)(11.0 / 84)}};
__constant__ float kCsol[NS] = {(float)(35.0 / 384), 0.f, (float)(500.0 / 1113),
                                (float)(125.0 / 192), (float)(-2187.0 / 6784),
                                (float)(11.0 / 84), 0.f};
__constant__ float kCerr[NS] = {
    (float)(35.0 / 384 - 5179.0 / 57600), 0.f,
    (float)(500.0 / 1113 - 7571.0 / 16695), (float)(125.0 / 192 - 393.0 / 640),
    (float)(-2187.0 / 6784 - -92097.0 / 339200), (float)(11.0 / 84 - 187.0 / 2100),
    (float)(0.0 - 1.0 / 40)};

struct FieldArgs {
  const float *w1t, *b1, *w2t, *b2;
  int H, C, W;
};

struct Partials {
  float *dw1, *db1, *dw2, *db2;
};

// The chunk's table on a uniform grid: ct (n, 3, C, B) rows b, 2c, 3d of each
// interval, or (n, 1, C, B) a linear control's slopes; row 0 is the interval
// left of t0g with `lead`.
struct Table {
  const float* ct;
  int B, n, C;
  int linear, lead;
  float t0g, w;
};

// The dense output's constants: the midpoint weights (runge_kutta.py) and the
// quartic's inverse system (integrate.py).
struct Dense {
  float bmid[NS];
  float minv[9];
};

// A lane's vectors, lane-minor with the given stride: channel h < H of
// vector i at base[(i * ld + h) * stride].
struct Vecs {
  float* base;
  size_t stride;
  int H;   // hidden channels: what the step loops run over
  int ld;  // channels of the layout
  __device__ float& at(int i, int h) const { return base[((size_t)i * ld + h) * stride]; }
};

// dX/dt of the lane at time tval on the chunk's uniform grid, for MC >= C
// channels (unrolled, so that the caller's dx stays in registers).  Cubic:
// interval j = clamp(floor((tval - t0g) / w), 0, n - 1) and fraction fr.
// Linear: j = clamp(ceil((tval - t0g) / w) - (lead ? 0 : 1), 0, n - 1), the
// slope on the left of a knot; fr is unused (0).
template <int MC>
__device__ __forceinline__ void control_at(const Table& c, size_t lane, bool live,
                                           float tval, float (&dx)[MC], int& j, float& fr) {
  const int C = c.C;
  const float pos = (tval - c.t0g) / c.w;
  if (c.linear) {
    const float jf = ceilf(pos) - (c.lead ? 0.f : 1.f);
    j = (int)fminf(fmaxf(jf, 0.f), (float)(c.n - 1));
    fr = 0.f;
    const float* row = c.ct + (size_t)j * C * c.B + lane;
#pragma unroll
    for (int i = 0; i < MC; ++i)
      if (i < C) dx[i] = live ? row[(size_t)i * c.B] : 0.f;
    return;
  }
  j = (int)fminf(fmaxf(floorf(pos), 0.f), (float)(c.n - 1));
  fr = tval - (c.t0g + (float)j * c.w);
  const float* row = c.ct + (size_t)j * 3 * C * c.B + lane;
#pragma unroll
  for (int i = 0; i < MC; ++i) {
    if (i < C) {
      const float b = live ? row[(size_t)i * c.B] : 0.f;
      const float cc = live ? row[(size_t)(C + i) * c.B] : 0.f;
      const float d = live ? row[(size_t)(2 * C + i) * c.B] : 0.f;
      dx[i] = b + (cc + d * fr) * fr;
    }
  }
}

// t + alpha * dt with the product and the sum rounded apart, never fused
// into one FMA: as the plain versions compute a stage's time, so that a
// stage on a knot selects the same interval in both.
__device__ __forceinline__ float stage_time(float t, float alpha, float dt) {
  return __fadd_rn(t, __fmul_rn(alpha, dt));
}

__device__ __forceinline__ void dense_coeffs(const float* m, float theta,
                                             float& cA, float& cB, float& cC) {
  const float p2 = theta * theta, p3 = p2 * theta, p4 = p3 * theta;
  cA = p2 * m[6] + p3 * m[3] + p4 * m[0];
  cB = p2 * m[7] + p3 * m[4] + p4 * m[1];
  cC = p2 * m[8] + p3 * m[5] + p4 * m[2];
}

// ---------------------------------------------------------------------------
// Specialised field: H 8, C 3, the weights and the lanes' vectors in shared
// memory; the stage math of cde_stage.cuh.

struct SpecField {
  static constexpr int H = 8, C = 3, MC = 3;
  BwdSmem<8, 3> sm;  // the forward uses sm.field only
  int W;
  // The hidden size as the launch passes it bounds the step loops, which
  // then stay rolled (unrolled, K2 took 12.4 / 35.7 ms and not 9.9 / 28.4,
  // forward / backward at the default configuration on an H100).
  int Hv;
  float* vec;
  static size_t smem_floats(int W, bool bwd) {
    return bwd ? BwdSmem<8, 3>::floats(W) + (size_t)NV_BWD * H * LANES
               : Smem<8, 3>::floats(W) + (size_t)NV_FWD * H * LANES;
  }
  __device__ SpecField(float* smem, const FieldArgs& f, bool bwd)
      : sm(smem, f.W), W(f.W), Hv(f.H) {
    load_field<8, 3>(sm.field, f.w1t, f.b1, f.w2t, f.b2, W);
    if (bwd) sm.zero_acc(W);
    vec = bwd ? sm.end() : sm.field.end();
  }
  // `fixed` addresses the vectors with the constant 8, not the size as
  // passed: on an H100 K2's backward is faster so (28.4 ms against 32.7 at
  // the default configuration), K2's forward and K9's backward slower (12.7
  // against 9.9; 86.0 against 53.8 at the per-sample slice).
  __device__ Vecs vecs(size_t, bool fixed) const {
    return Vecs{vec + threadIdx.x, LANES, Hv, fixed ? H : Hv};
  }
  __device__ void eval(const Vecs& v, int iy, int ik, const float (&dx)[MC]) const {
    float y[H], g[C * H], k[H], d[C];
#pragma unroll
    for (int h = 0; h < H; ++h) y[h] = v.at(iy, h);
#pragma unroll
    for (int i = 0; i < C; ++i) d[i] = dx[i];
    mlp_forward<H, C, false>(sm.field, W, y, g, nullptr);
    contract<H, C>(g, d, k);
#pragma unroll
    for (int h = 0; h < H; ++h) v.at(ik, h) = k[h];
  }
  // Every thread of the block calls it.
  __device__ void vjp(const Vecs& v, int iu, int iy, int iv, const float (&dx)[MC],
                      float (&ddx)[MC]) const {
    float u[H], y[H], dy[H], d[C], dd[C];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      u[h] = v.at(iu, h);
      y[h] = v.at(iy, h);
    }
#pragma unroll
    for (int i = 0; i < C; ++i) d[i] = dx[i];
    stage_vjp<H, C>(sm, W, u, y, d, dy, dd);
#pragma unroll
    for (int h = 0; h < H; ++h) v.at(iv, h) = dy[h];
#pragma unroll
    for (int i = 0; i < C; ++i) ddx[i] = dd[i];
  }
  __device__ void finish(const Partials& p) const {
    __syncthreads();
    sm.store_acc(W, p.dw1, p.db1, p.dw2, p.db2);
  }
};

// ---------------------------------------------------------------------------
// Generic field: H, C, W at run time; the weights read through L1, the
// lanes' vectors and activations in a global scratch, lane-minor.

struct GenField {
  static constexpr int MC = MAX_ROWS;  // channels: C <= 16 in linear mode
  FieldArgs f;
  float* scr;     // row r of lane l at scr[r * stride + l]
  size_t stride;  // lanes of the launch (blocks * LANES)
  int nv;         // rows of vectors before the activations
  Partials p;     // this block's slice of the partials (backward)
  static size_t rows(int H, int C, int W, bool bwd) {
    return (size_t)(bwd ? NV_BWD : NV_FWD) * H + 2 * (size_t)W + 2 * (size_t)C * H;
  }
  __device__ GenField(float* scratch, const FieldArgs& fa, bool bwd, const Partials& all)
      : f(fa), scr(scratch), stride((size_t)gridDim.x * LANES),
        nv(bwd ? NV_BWD : NV_FWD) {
    const size_t blk = blockIdx.x, W = f.W, CH = (size_t)f.C * f.H;
    p = Partials{all.dw1 + blk * W * f.H, all.db1 + blk * W, all.dw2 + blk * W * CH,
                 all.db2 + blk * CH};
  }
  __device__ float& row(size_t r, size_t lane) const { return scr[r * stride + lane]; }
  __device__ size_t h1_row() const { return (size_t)nv * f.H; }
  __device__ size_t g_row() const { return h1_row() + f.W; }
  __device__ size_t dp2_row() const { return g_row() + (size_t)f.C * f.H; }
  __device__ size_t dp1_row() const { return dp2_row() + (size_t)f.C * f.H; }
  __device__ Vecs vecs(size_t lane, bool) const { return Vecs{scr + lane, stride, f.H, f.H}; }

  // h1 = relu(W1 y + b1) and g = tanh(W2 h1 + b2) of the lane, to the scratch.
  __device__ void mlp(const Vecs& v, int iy, size_t lane) const {
    const int H = f.H, W = f.W, CH = f.C * f.H;
    for (int w = 0; w < W; ++w) {
      const float* r1 = f.w1t + (size_t)w * H;
      float a = 0.f;
      for (int h = 0; h < H; ++h) a = fmaf(r1[h], v.at(iy, h), a);
      a += f.b1[w];
      row(h1_row() + w, lane) = (a < 0.f) ? 0.f : a;
    }
    for (int q = 0; q < CH; ++q) {
      const float* r2 = f.w2t + (size_t)q * W;
      float a = 0.f;
      for (int w = 0; w < W; ++w) a = fmaf(r2[w], row(h1_row() + w, lane), a);
      row(g_row() + q, lane) = tanhf(a + f.b2[q]);
    }
  }
  __device__ void eval(const Vecs& v, int iy, int ik, const float (&dx)[MC]) const {
    const size_t lane = (size_t)blockIdx.x * LANES + threadIdx.x;
    const int H = f.H;
    mlp(v, iy, lane);
    for (int h = 0; h < H; ++h) {
      float acc = row(g_row() + h, lane) * dx[0];
      for (int i = 1; i < f.C; ++i) acc += row(g_row() + i * H + h, lane) * dx[i];
      v.at(ik, h) = acc;
    }
  }
  // Every thread of the block calls it.
  __device__ void vjp(const Vecs& v, int iu, int iy, int iv, const float (&dx)[MC],
                      float (&ddx)[MC]) const {
    const int tid = threadIdx.x;
    const size_t lane = (size_t)blockIdx.x * LANES + tid;
    const int H = f.H, C = f.C, W = f.W, CH = C * H;
    mlp(v, iy, lane);
    for (int i = 0; i < C; ++i) {
      float acc = 0.f;
      for (int h = 0; h < H; ++h) {
        const int q = i * H + h;
        const float uh = v.at(iu, h), gq = row(g_row() + q, lane);
        acc += uh * gq;
        row(dp2_row() + q, lane) = (uh * dx[i]) * (1.f - gq * gq);
      }
      ddx[i] = acc;
    }
    for (int w = 0; w < W; ++w) {
      float dh = 0.f;
      for (int q = 0; q < CH; ++q) dh = fmaf(f.w2t[(size_t)q * W + w], row(dp2_row() + q, lane), dh);
      row(dp1_row() + w, lane) = row(h1_row() + w, lane) > 0.f ? dh : 0.f;
    }
    for (int h = 0; h < H; ++h) {
      float acc = 0.f;
      for (int w = 0; w < W; ++w) acc = fmaf(f.w1t[(size_t)w * H + h], row(dp1_row() + w, lane), acc);
      v.at(iv, h) = acc;
    }
    __syncthreads();
    // The block's weight gradients: thread tid owns elements tid, tid + 32,
    // ... and sums the block's lanes in order.
    const size_t l0 = (size_t)blockIdx.x * LANES;
    for (int e = tid; e < W * H; e += LANES) {
      const int w = e / H, h = e - w * H;
      float s = 0.f;
      for (int l = 0; l < LANES; ++l)
        s = fmaf(row(dp1_row() + w, l0 + l), row(((size_t)iy * H + h), l0 + l), s);
      p.dw1[e] += s;
    }
    for (int e = tid; e < W * CH; e += LANES) {
      const int w = e / CH, q = e - w * CH;
      float s = 0.f;
      for (int l = 0; l < LANES; ++l)
        s = fmaf(row(dp2_row() + q, l0 + l), row(h1_row() + w, l0 + l), s);
      p.dw2[e] += s;
    }
    for (int w = tid; w < W; w += LANES) {
      float s = 0.f;
      for (int l = 0; l < LANES; ++l) s += row(dp1_row() + w, l0 + l);
      p.db1[w] += s;
    }
    for (int q = tid; q < CH; q += LANES) {
      float s = 0.f;
      for (int l = 0; l < LANES; ++l) s += row(dp2_row() + q, l0 + l);
      p.db2[q] += s;
    }
    __syncthreads();
  }
  __device__ void finish(const Partials&) const {}
};

// The field of a launch: the specialised one in shared memory, the generic
// one in `scratch`.
template <class F>
__device__ __forceinline__ F make_field(float* smem, float* scratch, const FieldArgs& f, bool bwd,
                        const Partials& p);

template <>
__device__ __forceinline__ SpecField make_field<SpecField>(float* smem, float*,
                                                           const FieldArgs& f, bool bwd,
                                                           const Partials&) {
  return SpecField(smem, f, bwd);
}

template <>
__device__ __forceinline__ GenField make_field<GenField>(float*, float* scratch,
                                                         const FieldArgs& f, bool bwd,
                                                         const Partials& p) {
  return GenField(scratch, f, bwd, p);
}

// ---------------------------------------------------------------------------
// Forward: one attempted step of size dc from (t, Z) with first stage K0.

// Stages 2..7 into K0 + 1 .. K0 + 6, each stage input in Y.
template <class F>
__device__ __forceinline__ void attempt_stages(const F& field, const Vecs& v, const Table& tab,
                                               size_t lane, bool live, float t, float dc) {
  const int H = v.H;
  float dx[F::MC];
  int j;
  float fr;
  for (int s = 1; s < NS; ++s) {
    for (int h = 0; h < H; ++h) {
      float y = v.at(Z, h);
      for (int q = 0; q < s; ++q) {
        const float coef = kBeta[s - 1][q];
        if (coef != 0.f) y = y + (dc * coef) * v.at(K0 + q, h);
      }
      v.at(Y, h) = y;
    }
    control_at(tab, lane, live, stage_time(t, kAlpha[s - 1], dc), dx, j, fr);
    field.eval(v, Y, K0 + s, dx);
  }
}

// The step's solution z1 into Y; returns the lane's sum over its hidden
// channels of the squared scaled error.
__device__ __forceinline__ float step_error(const Vecs& v, float dc, float rtol, float atol) {
  float part = 0.f;
  for (int h = 0; h < v.H; ++h) {
    const float z = v.at(Z, h);
    float z1 = z, e = 0.f;
    for (int q = 0; q < NS; ++q) {
      const float kq = v.at(K0 + q, h);
      if (kCsol[q] != 0.f) z1 = z1 + (dc * kCsol[q]) * kq;
      if (kCerr[q] != 0.f) e = e + kCerr[q] * kq;
    }
    e = dc * e;
    const float scaled = e / (atol + rtol * fmaxf(fabsf(z), fabsf(z1)));
    part += scaled * scaled;
    v.at(Y, h) = z1;
  }
  return part;
}

// integrate.py's controller: clip(safety * ratio^(-1/5), dfactor, ifactor if
// accepted else 1); a clamped accepted step keeps the proposal.
__device__ __forceinline__ float next_step(float ratio, float dc, float dt, bool accept,
                                           float safety, float ifactor, float dfactor) {
  float factor = safety * expf((-1.0f / 5.0f) * logf(fmaxf(ratio, 1e-10f)));
  if (!isfinite(factor)) factor = dfactor;
  const float upper = accept ? ifactor : 1.f;
  float dt_new = dc * fminf(fmaxf(factor, dfactor), upper);
  if (accept && dc < dt) dt_new = fmaxf(dt, dt_new);
  return dt_new;
}

// The dense output of an accepted step (Z to z1 in Y) at theta, channel h.
__device__ __forceinline__ float dense_value(const Vecs& v, const Dense& d, int h, float dc,
                                             float theta, float cA, float cB, float cC) {
  const float z = v.at(Z, h), z1 = v.at(Y, h);
  const float k0 = v.at(K0, h), k6 = v.at(K0 + 6, h);
  float ymid = z;
  for (int q = 0; q < NS; ++q)
    if (d.bmid[q] != 0.f) ymid = ymid + (dc * d.bmid[q]) * v.at(K0 + q, h);
  const float rA = z1 - z - dc * k0;
  const float rB = dc * (k6 - k0);
  const float rC = ymid - z - (0.5f * dc) * k0;
  return z + (theta * dc) * k0 + cA * rA + cB * rB + cC * rC;
}

// theta of output time tk in the step (t, dc].
__device__ __forceinline__ float theta_of(float tk, float t, float dc) {
  return fminf(fmaxf((tk - t) / fmaxf(dc, 1e-30f), 0.f), 1.f);
}

// ---------------------------------------------------------------------------
// Backward of one accepted step (t, dt) from the stored state in YS.

// The step's stage inputs into YS .. YS + 6 and stages into KV .. KV + 6.
template <class F>
__device__ __forceinline__ void recompute_stages(const F& field, const Vecs& v, const Table& tab,
                                                 size_t lane, bool live, float t, float dt) {
  const int H = v.H;
  float dx[F::MC];
  int j;
  float fr;
  control_at(tab, lane, live, t, dx, j, fr);
  field.eval(v, YS, KV, dx);
  for (int st = 1; st < NS; ++st) {
    for (int h = 0; h < H; ++h) {
      float y = v.at(YS, h);
      for (int q = 0; q < st; ++q) {
        const float coef = kBeta[st - 1][q];
        if (coef != 0.f) y = y + (dt * coef) * v.at(KV + q, h);
      }
      v.at(YS + st, h) = y;
    }
    control_at(tab, lane, live, stage_time(t, kAlpha[st - 1], dt), dx, j, fr);
    field.eval(v, YS + st, KV + st, dx);
  }
}

// The dense output's cotangent terms before any output row: lambda flows
// into z1.
__device__ __forceinline__ void start_step_cotangents(const Vecs& v) {
  for (int h = 0; h < v.H; ++h) {
    v.at(LZ, h) = 0.f;
    v.at(LZ1, h) = v.at(LAM, h);
    v.at(E0, h) = v.at(E6, h) = v.at(UMID, h) = 0.f;
  }
}

// Adds the cotangent gk (gk[h * stride]) of the output row at theta.
__device__ __forceinline__ void add_row_cotangent(const Vecs& v, const Dense& d, float theta,
                                                  float dt, const float* gk, size_t stride,
                                                  bool live) {
  float cA, cB, cC;
  dense_coeffs(d.minv, theta, cA, cB, cC);
  for (int h = 0; h < v.H; ++h) {
    const float g = live ? gk[(size_t)h * stride] : 0.f;
    v.at(LZ, h) += (1.f - cA - cC) * g;
    v.at(LZ1, h) += cA * g;
    v.at(E0, h) += (dt * (theta - cA - cB - 0.5f * cC)) * g;
    v.at(E6, h) += (dt * cB) * g;
    v.at(UMID, h) += cC * g;
  }
}

// The stages' cotangents in reverse, each through the field's VJP, adding the
// control's cotangent to the lane's dct rows; then lambda before the step.
// Every thread of the block calls it; a lane with act false (no step at this
// iteration) comes with dt 0 and no output rows, so its cotangents are zero,
// and it keeps its lambda.
template <class F>
__device__ __forceinline__ void step_backward(const F& field, const Vecs& v, const Table& tab,
                                              const Dense& d, size_t lane, bool live, bool act,
                                              float t, float dt, float* dct) {
  const int H = v.H, C = tab.C;
  const size_t B = tab.B;
  float dx[F::MC], ddx[F::MC];
  int j;
  float fr;
  // y_mid = z + dt sum bmid_q k_q and z1 = z + dt sum csol_q k_q.
  for (int h = 0; h < H; ++h) v.at(LZ, h) = v.at(LZ, h) + v.at(UMID, h) + v.at(LZ1, h);
  for (int st = NS - 1; st >= 0; --st) {
    for (int h = 0; h < H; ++h) {
      float u = st == 0 ? v.at(E0, h) : (st == NS - 1 ? v.at(E6, h) : 0.f);
      u = u + (dt * d.bmid[st]) * v.at(UMID, h) + (dt * kCsol[st]) * v.at(LZ1, h);
      for (int s2 = st + 1; s2 < NS; ++s2) {
        const float coef = kBeta[s2 - 1][st];
        if (coef != 0.f) u = u + (dt * coef) * v.at(KV + s2, h);
      }
      v.at(U, h) = u;
    }
    control_at(tab, lane, live, st == 0 ? t : stage_time(t, kAlpha[st - 1], dt), dx, j, fr);
    field.vjp(v, U, YS + st, KV + st, dx, ddx);
    if (live && act && tab.linear) {  // the slope row only
      float* row = dct + (size_t)j * C * B + lane;
#pragma unroll
      for (int q = 0; q < F::MC; ++q)
        if (q < C) row[(size_t)q * B] += ddx[q];
    } else if (live && act) {
      float* row = dct + (size_t)j * 3 * C * B + lane;
#pragma unroll
      for (int q = 0; q < F::MC; ++q) {
        if (q < C) {
          row[(size_t)q * B] += ddx[q];
          row[(size_t)(C + q) * B] += fr * ddx[q];
          row[(size_t)(2 * C + q) * B] += (fr * fr) * ddx[q];
        }
      }
    }
  }
  if (!act) return;
  for (int h = 0; h < H; ++h) {
    float lz = v.at(LZ, h);
    for (int st = 0; st < NS; ++st) lz = lz + v.at(KV + st, h);
    v.at(LAM, h) = lz;
  }
}

bool specialised_fits(int H, int C, int W) {
  return H == 8 && C == 3 && sizeof(float) * SpecField::smem_floats(W, true) <= MAX_SMEM;
}

int blocks_of(int B) { return (B + LANES - 1) / LANES; }

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Fills the table, the field and the dense constants; 0 or an error code.
int make_table(Table& tab, FieldArgs& f, Dense& d, const float* ct, const float* w1t,
               const float* b1, const float* w2t, const float* b2, int B, int n, int H, int C,
               int W, int n_out, const float* dense, float t0g, float w, int linear, int lead,
               int variant) {
  const int rows = linear ? C : 3 * C;
  if (B < 1 || n < 1 || H < 1 || C < 1 || rows > MAX_ROWS || W < 1 || n_out < 0 ||
      n_out > MAX_OUT || !(w > 0.f) || (lead && !linear))
    return BAD_ARGUMENT;
  if (variant != GENERIC && !(variant == SPECIALISED && specialised_fits(H, C, W)))
    return BAD_VARIANT;
  tab = Table{ct, B, n, C, linear != 0, lead != 0, t0g, w};
  f = FieldArgs{w1t, b1, w2t, b2, H, C, W};
  for (int q = 0; q < NS; ++q) d.bmid[q] = dense[q];
  for (int q = 0; q < 9; ++q) d.minv[q] = dense[NS + q];
  return 0;
}

}  // namespace
