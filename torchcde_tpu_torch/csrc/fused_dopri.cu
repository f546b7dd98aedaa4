// Adaptive dopri5 Neural CDE solve of one chunk for one group of lanes,
// forward and backward, as two CUDA kernels for Hopper (sm_90a).
//
// Replaces torchcde_tpu/solvers/fused_dopri_pallas.py::_dopri_fwd_kernel and
// ::_dopri_bwd_kernel, for cubic controls and in their linear-control mode.
// The forward runs the whole PI-controlled solve of dz = MLP(z) . dX/dt over
// one chunk of a uniform knot grid: seven stages per attempted step (the
// first same as the last), one error norm over the group, the controller of
// integrate.py, the quartic dense output at the output times inside each
// accepted step, and a store of the accepted steps (t, dt, z).  The
// backward walks that store in reverse, recomputes each step's stages from
// the stored state, and propagates the cotangents of the dense output and the
// state back through them: the frozen-mesh gradients of direct
// backpropagation through the adaptive loop.
//
// What bounds it.  As in fused_fixed.cu, a serial chain of small
// matrix-vector products per lane (2 W H (1 + C) FLOP per stage; 6 stages per
// attempted step), latency- and compute-bound on the CUDA cores.  On top of
// that, every attempted step needs the error norm of the whole group: a
// reduction across every block, after which every block must take the same
// accept / step-size decision bit for bit.
//
// Design.
//  * One thread per batch lane, blocks of one warp (32 lanes), as K1.  A group
//    of up to 4096 lanes is one cooperative launch of up to 128 blocks, all
//    resident at once (cudaLaunchCooperativeKernel refuses a grid that could
//    not be), so they can wait for each other.
//  * The norm: each block sums its lanes' squares with warp shuffles and
//    writes one partial; a barrier on a global counter; then every thread of
//    every block sums the partials in block order.  The same float operations
//    in the same order give the same value everywhere, so every block takes
//    the same decision: no float atomics in the norm.  The partials are
//    double-buffered by step parity (a block can run at most one step ahead)
//    and read past L1 (__ldcg).
//  * t and dt are float32, as the JAX kernel carries them.  Each stage's
//    interval is floor((t - t0g) / w), read directly (CUDA can gather).
//  * Linear-control mode (the log-ODE / Neural RDE control): the table holds
//    one slope row per interval and dX/dt is that row.  The interval is
//    ceil((t - t0g) / w) - 1, computed in float32 in the JAX kernel's order,
//    so that a stage exactly on a knot (every step clamped to a chunk end
//    lands on one) reads the slope on its left, as
//    LinearInterpolation.derivative does.  With `lead`, row 0 is the
//    interval left of the chunk's first knot t0g and the rule drops the - 1.
//    The backward adds each stage's ddx to its slope row only.
//  * The lane's vectors (state, the seven stages, ...) live in shared memory
//    (specialised variant) or in a per-lane global scratch (generic variant),
//    lane-minor; the stage math is cde_stage.cuh's (specialised) or its
//    run-time-shape form below (generic).
//  * The backward needs no norm: the mesh is fixed, so it is an ordinary
//    launch.  Each lane owns its dct column (no atomics); weight gradients are
//    deterministic per-block partials, as in K1.
//
// Two variants compute the same function, in either mode; fd_variant picks
// one from the shapes.  Specialised: H 8, C 3 (the flagship), weights in
// shared memory, widths whose backward fits (W <= 391).  Generic: H, C, W at
// run time, weights read through L1, every other shape inside the JAX
// kernel's caps (W <= 512, C*H <= 512, 3*C <= 16 cubic, C <= 16 linear).
//
// Layouts (float32, lane minor; B = lanes of the group):
//   ct (n, 3, C, B) rows b, 2c, 3d of the chunk's intervals, or (n, 1, C, B)
//   the slopes in linear mode; z0t (H, B);
//   w1t (W, H), b1 (W), w2t (C*H, W), b2 (C*H) with rows q = i*H + h;
//   zout (n_out, H, B), zfin (H, B), dtfin (1), zst (cap, H, B), tst (cap),
//   dtst (cap), stats (2) int32: accepted and attempted steps.
// Backward: gzout (n_out, H, B), gzfin (H, B) -> dct (ct's shape), dz0 (H, B)
//   and per-block partials dw1p (blocks, W, H), db1p (blocks, W),
//   dw2p (blocks, W, C*H), db2p (blocks, C*H), blocks = fd_blocks(B).

#include <stddef.h>
#include <stdint.h>

#include "cde_stage.cuh"

namespace {

constexpr int NS = 7;            // dopri5 stages
constexpr int MAX_ROWS = 16;     // table rows per interval: 3 * C cubic, C linear
constexpr int MAX_OUT = 64;      // output times per chunk
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

// The dopri5 tableau, rounded to float32 as the JAX kernel rounds its Python
// constants.
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

struct Common {
  const float* ct;
  FieldArgs f;
  float* scratch;  // [2][blocks] norm partials, a barrier counter, vectors
  int B, n, n_out;
  int linear, lead;  // linear-control mode; row 0 is the interval left of t0g
  float t0g, w;
  float out_ts[MAX_OUT];
  float bmid[NS];  // weights of the 4th-order midpoint (runge_kutta.py)
  float minv[9];   // the quartic's inverse system (integrate.py)
};

struct FwdArgs {
  Common c;
  const float *z0t, *dt0;
  float *zout, *zfin, *dtfin, *zst, *tst, *dtst;
  int* stats;
  int cap;
  float t_start, t_end, rtol, atol, safety, ifactor, dfactor;
};

struct BwdArgs {
  Common c;
  const float *zst, *tst, *dtst, *gzout, *gzfin;
  const int* stats;
  float *dct, *dz0;
  Partials p;
};

__host__ __device__ inline size_t head_floats(int blocks) {
  return 2 * (size_t)blocks + 32;  // partials, then the counter (aligned)
}

// A lane's vectors, lane-minor with the given stride.
struct Vecs {
  float* base;
  size_t stride;
  int H;
  __device__ float& at(int i, int h) const { return base[((size_t)i * H + h) * stride]; }
};

// dX/dt of the lane at time tval on the chunk's uniform grid, for MC >= C
// channels (unrolled, so that the caller's dx stays in registers).  Cubic:
// interval j = clamp(floor((tval - t0g) / w), 0, n - 1) and fraction fr.
// Linear: j = clamp(ceil((tval - t0g) / w) - (lead ? 0 : 1), 0, n - 1), the
// slope on the left of a knot; fr is unused (0).
template <int MC>
__device__ void control_at(const Common& c, size_t lane, bool live, float tval,
                           float (&dx)[MC], int& j, float& fr) {
  const int C = c.f.C;
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
// into one FMA: as the plain version computes a stage's time, so that a
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
  float* vec;
  static size_t smem_floats(int W, bool bwd) {
    return bwd ? BwdSmem<8, 3>::floats(W) + (size_t)NV_BWD * H * LANES
               : Smem<8, 3>::floats(W) + (size_t)NV_FWD * H * LANES;
  }
  __device__ SpecField(float* smem, const Common& c, bool bwd)
      : sm(smem, c.f.W), W(c.f.W) {
    load_field<8, 3>(sm.field, c.f.w1t, c.f.b1, c.f.w2t, c.f.b2, W);
    if (bwd) sm.zero_acc(W);
    vec = bwd ? sm.end() : sm.field.end();
  }
  __device__ Vecs vecs(size_t) const { return Vecs{vec + threadIdx.x, LANES, H}; }
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
  __device__ GenField(float* scratch, const Common& c, bool bwd, const Partials& all)
      : f(c.f), scr(scratch), stride((size_t)gridDim.x * LANES),
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
  __device__ Vecs vecs(size_t lane) const { return Vecs{scr + lane, stride, f.H}; }

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

// ---------------------------------------------------------------------------
// The group-wide error norm.

__device__ void grid_barrier(unsigned* counter, unsigned goal) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (*(volatile unsigned*)counter < goal) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// The sum of `part` over every thread of the launch, the same bits in every
// thread.
__device__ float group_sum(float part, float* partials, unsigned* counter,
                           unsigned& generation) {
  for (int off = LANES / 2; off > 0; off >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, off);
  const unsigned nb = gridDim.x;
  float* slot = partials + (generation & 1u) * nb;
  if (threadIdx.x == 0) slot[blockIdx.x] = part;
  ++generation;
  grid_barrier(counter, generation * nb);
  float total = 0.f;
  for (unsigned b = 0; b < nb; ++b) total += __ldcg(slot + b);
  return total;
}

template <class F>
__device__ F make_field(float* smem, const Common& c, bool bwd, const Partials& p);

template <>
__device__ SpecField make_field<SpecField>(float* smem, const Common& c, bool bwd,
                                           const Partials&) {
  return SpecField(smem, c, bwd);
}

template <>
__device__ GenField make_field<GenField>(float*, const Common& c, bool bwd,
                                         const Partials& p) {
  return GenField(c.scratch + head_floats(gridDim.x), c, bwd, p);
}

template <class F>
__global__ void __launch_bounds__(LANES) dopri_fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  const Common& c = a.c;
  const F field = make_field<F>(smem, c, false, Partials{});
  __syncthreads();
  const size_t lane = (size_t)blockIdx.x * LANES + threadIdx.x;
  const bool live = lane < (size_t)c.B;
  const Vecs v = field.vecs(lane);
  const int H = c.f.H;
  const size_t B = c.B;
  float* partials = c.scratch;
  unsigned* counter = reinterpret_cast<unsigned*>(c.scratch + 2 * gridDim.x);

  for (int h = 0; h < H; ++h) {
    const float z = live ? a.z0t[h * B + lane] : 0.f;
    v.at(Z, h) = z;
    if (live)
      for (int k = 0; k < c.n_out; ++k) a.zout[((size_t)k * H + h) * B + lane] = z;
  }
  float dx[F::MC];
  int j;
  float fr;
  float t = a.t_start;
  const float t1 = a.t_end;
  float dt = *a.dt0;
  control_at(c, lane, live, t, dx, j, fr);
  field.eval(v, Z, K0, dx);
  int attempted = 0, cnt = 0;
  unsigned generation = 0;

  while (t < t1 && attempted < a.cap && cnt < a.cap) {
    dt = fmaxf(dt, 1e-14f);
    const float dc = fminf(dt, t1 - t);
    for (int s = 1; s < NS; ++s) {
      for (int h = 0; h < H; ++h) {
        float y = v.at(Z, h);
        for (int q = 0; q < s; ++q) {
          const float coef = kBeta[s - 1][q];
          if (coef != 0.f) y = y + (dc * coef) * v.at(K0 + q, h);
        }
        v.at(Y, h) = y;
      }
      control_at(c, lane, live, stage_time(t, kAlpha[s - 1], dc), dx, j, fr);
      field.eval(v, Y, K0 + s, dx);
    }
    float part = 0.f;
    for (int h = 0; h < H; ++h) {
      const float z = v.at(Z, h);
      float z1 = z, e = 0.f;
      for (int q = 0; q < NS; ++q) {
        const float kq = v.at(K0 + q, h);
        if (kCsol[q] != 0.f) z1 = z1 + (dc * kCsol[q]) * kq;
        if (kCerr[q] != 0.f) e = e + kCerr[q] * kq;
      }
      e = dc * e;
      const float scaled = e / (a.atol + a.rtol * fmaxf(fabsf(z), fabsf(z1)));
      if (live) part += scaled * scaled;
      v.at(Y, h) = z1;
    }
    const float ratio =
        sqrtf(group_sum(part, partials, counter, generation) / (float)(B * H));
    const bool accept = ratio <= 1.f;
    // integrate.py's controller: clip(safety * ratio^(-1/5), dfactor,
    // ifactor if accepted else 1); a clamped accepted step keeps the proposal.
    float factor = a.safety * expf((-1.0f / 5.0f) * logf(fmaxf(ratio, 1e-10f)));
    if (!isfinite(factor)) factor = a.dfactor;
    const float upper = accept ? a.ifactor : 1.f;
    float dt_new = dc * fminf(fmaxf(factor, a.dfactor), upper);
    if (accept && dc < dt) dt_new = fmaxf(dt, dt_new);
    if (accept) {
      if (blockIdx.x == 0 && threadIdx.x == 0) {
        a.tst[cnt] = t;
        a.dtst[cnt] = dc;
      }
      if (live)
        for (int h = 0; h < H; ++h) a.zst[((size_t)cnt * H + h) * B + lane] = v.at(Z, h);
      for (int k = 0; k < c.n_out; ++k) {
        const float tk = c.out_ts[k];
        if (!(tk > t && tk <= t + dc)) continue;
        const float theta = fminf(fmaxf((tk - t) / fmaxf(dc, 1e-30f), 0.f), 1.f);
        float cA, cB, cC;
        dense_coeffs(c.minv, theta, cA, cB, cC);
        for (int h = 0; h < H; ++h) {
          const float z = v.at(Z, h), z1 = v.at(Y, h);
          const float k0 = v.at(K0, h), k6 = v.at(K0 + 6, h);
          float ymid = z;
          for (int q = 0; q < NS; ++q)
            if (c.bmid[q] != 0.f) ymid = ymid + (dc * c.bmid[q]) * v.at(K0 + q, h);
          const float rA = z1 - z - dc * k0;
          const float rB = dc * (k6 - k0);
          const float rC = ymid - z - (0.5f * dc) * k0;
          const float val = z + (theta * dc) * k0 + cA * rA + cB * rB + cC * rC;
          if (live) a.zout[((size_t)k * H + h) * B + lane] = val;
        }
      }
      for (int h = 0; h < H; ++h) {
        v.at(Z, h) = v.at(Y, h);
        v.at(K0, h) = v.at(K0 + 6, h);
      }
      t = t + dc;
      ++cnt;
    }
    dt = dt_new;
    ++attempted;
  }
  if (live)
    for (int h = 0; h < H; ++h) a.zfin[h * B + lane] = v.at(Z, h);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.dtfin = dt;
    a.stats[0] = cnt;
    a.stats[1] = attempted;
  }
  // Loud exhaustion, as the JAX kernel: t < t1 means the budget ran out.
  if (t < t1 && live) {
    for (int h = 0; h < H; ++h) {
      a.zfin[h * B + lane] = NAN;
      for (int k = 0; k < c.n_out; ++k) a.zout[((size_t)k * H + h) * B + lane] = NAN;
    }
  }
}

template <class F>
__global__ void __launch_bounds__(LANES) dopri_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const Common& c = a.c;
  const F field = make_field<F>(smem, c, true, a.p);
  __syncthreads();
  const size_t lane = (size_t)blockIdx.x * LANES + threadIdx.x;
  const bool live = lane < (size_t)c.B;
  const Vecs v = field.vecs(lane);
  const int H = c.f.H, C = c.f.C;
  const size_t B = c.B;
  const int cnt = a.stats[0];

  for (int h = 0; h < H; ++h) v.at(LAM, h) = live ? a.gzfin[h * B + lane] : 0.f;
  uint64_t emitted = 0;
  float dx[F::MC], ddx[F::MC];
  int j;
  float fr;
  for (int i = 0; i < cnt; ++i) {
    const int s = cnt - 1 - i;
    const float t = a.tst[s], dt = a.dtst[s];
    // Recompute the step's stages from the stored state.
    for (int h = 0; h < H; ++h)
      v.at(YS, h) = live ? a.zst[((size_t)s * H + h) * B + lane] : 0.f;
    control_at(c, lane, live, t, dx, j, fr);
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
      control_at(c, lane, live, stage_time(t, kAlpha[st - 1], dt), dx, j, fr);
      field.eval(v, YS + st, KV + st, dx);
    }
    // Cotangents of the dense-output rows this step emitted.
    for (int h = 0; h < H; ++h) {
      v.at(LZ, h) = 0.f;
      v.at(LZ1, h) = v.at(LAM, h);
      v.at(E0, h) = v.at(E6, h) = v.at(UMID, h) = 0.f;
    }
    for (int k = 0; k < c.n_out; ++k) {
      const float tk = c.out_ts[k];
      if (!(tk > t && tk <= t + dt)) continue;
      emitted |= uint64_t(1) << k;
      const float theta = fminf(fmaxf((tk - t) / fmaxf(dt, 1e-30f), 0.f), 1.f);
      float cA, cB, cC;
      dense_coeffs(c.minv, theta, cA, cB, cC);
      for (int h = 0; h < H; ++h) {
        const float gk = live ? a.gzout[((size_t)k * H + h) * B + lane] : 0.f;
        v.at(LZ, h) += (1.f - cA - cC) * gk;
        v.at(LZ1, h) += cA * gk;
        v.at(E0, h) += (dt * (theta - cA - cB - 0.5f * cC)) * gk;
        v.at(E6, h) += (dt * cB) * gk;
        v.at(UMID, h) += cC * gk;
      }
    }
    // y_mid = z + dt sum bmid_q k_q and z1 = z + dt sum csol_q k_q.
    for (int h = 0; h < H; ++h) v.at(LZ, h) = v.at(LZ, h) + v.at(UMID, h) + v.at(LZ1, h);
    for (int st = NS - 1; st >= 0; --st) {
      for (int h = 0; h < H; ++h) {
        float u = st == 0 ? v.at(E0, h) : (st == NS - 1 ? v.at(E6, h) : 0.f);
        u = u + (dt * c.bmid[st]) * v.at(UMID, h) + (dt * kCsol[st]) * v.at(LZ1, h);
        for (int s2 = st + 1; s2 < NS; ++s2) {
          const float coef = kBeta[s2 - 1][st];
          if (coef != 0.f) u = u + (dt * coef) * v.at(KV + s2, h);
        }
        v.at(U, h) = u;
      }
      control_at(c, lane, live, st == 0 ? t : stage_time(t, kAlpha[st - 1], dt), dx, j, fr);
      field.vjp(v, U, YS + st, KV + st, dx, ddx);
      if (live && c.linear) {  // the slope row only
        float* row = a.dct + (size_t)j * C * B + lane;
#pragma unroll
        for (int q = 0; q < F::MC; ++q)
          if (q < C) row[(size_t)q * B] += ddx[q];
      } else if (live) {
        float* row = a.dct + (size_t)j * 3 * C * B + lane;
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
    for (int h = 0; h < H; ++h) {
      float lz = v.at(LZ, h);
      for (int st = 0; st < NS; ++st) lz = lz + v.at(KV + st, h);
      v.at(LAM, h) = lz;
    }
  }
  // dz0: lambda at the chunk start, plus the rows never emitted (they kept z0).
  if (live) {
    for (int h = 0; h < H; ++h) {
      float d = v.at(LAM, h);
      for (int k = 0; k < c.n_out; ++k)
        if (!((emitted >> k) & 1)) d = d + a.gzout[((size_t)k * H + h) * B + lane];
      a.dz0[h * B + lane] = d;
    }
  }
  field.finish(a.p);
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

template <class F>
int launch_fwd(FwdArgs a, size_t smem, cudaStream_t stream) {
  auto kernel = dopri_fwd_kernel<F>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  // Cooperative: every block of the group resident at once, or a refusal.
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks_of(a.c.B)),
                                    dim3(LANES), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class F>
int launch_bwd(const BwdArgs& a, size_t smem, cudaStream_t stream) {
  auto kernel = dopri_bwd_kernel<F>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks_of(a.c.B), LANES, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int make_common(Common& c, const float* ct, const float* w1t, const float* b1,
                const float* w2t, const float* b2, float* scratch, int B, int n, int H,
                int C, int W, int n_out, const float* out_ts, const float* dense,
                float t0g, float w, int linear, int lead, int variant) {
  const int rows = linear ? C : 3 * C;
  if (B < 1 || n < 1 || H < 1 || C < 1 || rows > MAX_ROWS || W < 1 || n_out < 0 ||
      n_out > MAX_OUT || !(w > 0.f) || (lead && !linear))
    return BAD_ARGUMENT;
  if (variant != GENERIC && !(variant == SPECIALISED && specialised_fits(H, C, W)))
    return BAD_VARIANT;
  c.ct = ct;
  c.f = FieldArgs{w1t, b1, w2t, b2, H, C, W};
  c.scratch = scratch;
  c.B = B;
  c.n = n;
  c.n_out = n_out;
  c.linear = linear != 0;
  c.lead = lead != 0;
  c.t0g = t0g;
  c.w = w;
  for (int k = 0; k < MAX_OUT; ++k) c.out_ts[k] = k < n_out ? out_ts[k] : 0.f;
  for (int q = 0; q < NS; ++q) c.bmid[q] = dense[q];
  for (int q = 0; q < 9; ++q) c.minv[q] = dense[NS + q];
  return 0;
}

}  // namespace

extern "C" {

const char* fd_error_string(int code) {
  if (code == BAD_ARGUMENT) return "invalid argument";
  if (code == BAD_VARIANT) return "no such kernel variant for these shapes";
  return cudaGetErrorString((cudaError_t)code);
}

// The variant that runs these shapes: 0 specialised, 1 generic.
int fd_variant(int H, int C, int W) {
  return specialised_fits(H, C, W) ? SPECIALISED : GENERIC;
}

// Blocks of a launch over B lanes: the leading size of the weight partials.
int fd_blocks(int B) { return blocks_of(B); }

// Floats of the zeroed scratch a launch needs.
long fd_scratch_floats(int B, int H, int C, int W, int variant, int bwd) {
  const int blocks = blocks_of(B);
  size_t floats = head_floats(blocks);
  if (variant == GENERIC)
    floats += GenField::rows(H, C, W, bwd != 0) * (size_t)blocks * LANES;
  return (long)floats;
}

// dense: the 7 midpoint weights, then the 3x3 quartic inverse row-major.
// linear: ct holds a linear control's slopes; lead: its row 0 is the
// interval left of t0g.
int fd_forward(const float* ct, const float* z0t, const float* w1t, const float* b1,
               const float* w2t, const float* b2, const float* dt0, float* zout,
               float* zfin, float* dtfin, float* zst, float* tst, float* dtst,
               int* stats, float* scratch, int B, int n, int H, int C, int W, int cap,
               int n_out, const float* out_ts, const float* dense, float t_start,
               float t_end, float t0g, float w, float rtol, float atol, float safety,
               float ifactor, float dfactor, int linear, int lead, int variant,
               void* stream) {
  FwdArgs a;
  int rc = make_common(a.c, ct, w1t, b1, w2t, b2, scratch, B, n, H, C, W, n_out,
                       out_ts, dense, t0g, w, linear, lead, variant);
  if (rc) return rc;
  if (cap < 1) return BAD_ARGUMENT;
  a.z0t = z0t;
  a.dt0 = dt0;
  a.zout = zout;
  a.zfin = zfin;
  a.dtfin = dtfin;
  a.zst = zst;
  a.tst = tst;
  a.dtst = dtst;
  a.stats = stats;
  a.cap = cap;
  a.t_start = t_start;
  a.t_end = t_end;
  a.rtol = rtol;
  a.atol = atol;
  a.safety = safety;
  a.ifactor = ifactor;
  a.dfactor = dfactor;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == SPECIALISED)
    return launch_fwd<SpecField>(a, sizeof(float) * SpecField::smem_floats(W, false), st);
  return launch_fwd<GenField>(a, 0, st);
}

int fd_backward(const float* ct, const float* zst, const float* tst, const float* dtst,
                const float* gzout, const float* gzfin, const float* w1t, const float* b1,
                const float* w2t, const float* b2, const int* stats, float* dct,
                float* dz0, float* dw1p, float* db1p, float* dw2p, float* db2p,
                float* scratch, int B, int n, int H, int C, int W, int n_out,
                const float* out_ts, const float* dense, float t0g, float w,
                int linear, int lead, int variant, void* stream) {
  BwdArgs a;
  int rc = make_common(a.c, ct, w1t, b1, w2t, b2, scratch, B, n, H, C, W, n_out,
                       out_ts, dense, t0g, w, linear, lead, variant);
  if (rc) return rc;
  a.zst = zst;
  a.tst = tst;
  a.dtst = dtst;
  a.gzout = gzout;
  a.gzfin = gzfin;
  a.stats = stats;
  a.dct = dct;
  a.dz0 = dz0;
  a.p = Partials{dw1p, db1p, dw2p, db2p};
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == SPECIALISED)
    return launch_bwd<SpecField>(a, sizeof(float) * SpecField::smem_floats(W, true), st);
  return launch_bwd<GenField>(a, 0, st);
}

}  // extern "C"
