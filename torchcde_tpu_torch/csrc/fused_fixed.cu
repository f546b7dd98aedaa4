// Fixed-step Neural CDE solve, forward and backward, as two CUDA kernels for
// Hopper (sm_90a).
//
// Replaces torchcde_tpu/solvers/fused_pallas.py::_fwd_kernel (stage math
// _stage_forward) and ::_bwd_kernel (stage math _stage_backward).  The whole
// euler / midpoint / heun / rk4 solve of dz = MLP(z) . dX/dt over uniform
// knots, with m substeps per interval, runs inside one launch, and its
// reverse walk inside a second one.
//
// What bounds it.  The work is a serial chain of small dependent
// matrix-vector products per batch lane: each stage evaluates
// h1 = relu(W1 y + b1) (W x H) and g = tanh(W2 h1 + b2) (CH x W) for one lane,
// 2 W H (1 + C) FLOP.  At the flagship shapes (B 4096, 99 intervals, rk4,
// H 8, W 128, C 3) that is 13.3 GFLOP forward.  The backward evaluates each
// stage twice (the replay and the VJP's recompute) and adds the VJP's products
// (dh1 and dy, 2 W H (1 + C); the weight gradients as many again): 53.2 GFLOP.
// Slab and residual traffic is
// ~65 MB: latency- and compute-bound on the CUDA cores, not memory-bound.
//
// Both variants drop the TPU padding (H to 8 sublanes, the batch to 128
// lanes, 16 slab rows per interval): operands are packed (feature, batch)
// without padding.  No --use_fast_math: tanhf stays the accurate version.
//
// Two modes, as the TPU kernels have (their mx and ct_dtype): float32, and
// bfloat16 for bfloat16 models (mode 1).  In the bfloat16 mode the slab
// table ct and its cotangent dct are bfloat16: slabs are upcast on load and
// dct is summed in float32 and stored rounded, which halves the slab bytes.
// The state, the weights and every sum stay float32, and the operands of the
// stage products are rounded to bfloat16 where the TPU kernel feeds its
// matrix unit bfloat16 operands (cde_stage.cuh, cde_generic.cuh; in the
// generic variant also the selection products of the TPU kernel's padded
// layout, used where H % 8 != 0).  Each rounding is two conversions; the
// products stay on the CUDA cores.  Both modes have the same bound.
//
// Two variants compute the same function; ff_variant picks one from the
// shapes, and every shape inside the JAX package's caps (W <= 512,
// C*H <= 512, 3*C <= 16, m <= 8) launches one of them.
//
// Specialised variant (H and C compile-time; instantiated for the flagship
// H 8, C 3 at widths whose backward fits in shared memory, W <= 432).  Its
// stage math (mlp_forward, stage_vjp) is in cde_stage.cuh, shared with the
// adaptive kernels of fused_dopri.cu and the reversible ones of
// fused_reversible.cu.
//  * One thread per batch lane loops over the intervals; this replaces the
//    TPU's sequential grid axis and its VMEM carry of z.  Blocks are one warp
//    (32 lanes), so a 4096 batch spreads over 128 SMs.
//  * The weights (W*H + C*H*W + W + C*H floats, ~17 KB at the flagship) sit
//    in shared memory and are read as warp-wide broadcasts.
//  * The hidden layer streams over W: each h1_w is computed and folded into
//    the C*H pre-activation accumulators at once, so h1 never sits in
//    registers whole.
//  * The backward recomputes each interval's substeps and stages from the
//    stored knot state, as the TPU kernel does.  Weight gradients are reduced
//    per block: each stage's per-lane h1, dpre1, dpre2 and y are staged in
//    shared memory, and each thread sums the 32 lanes for the weight columns
//    it owns.  The per-block partials are written out and summed after the
//    launch, as the JAX package sums its per-tile partials, so the result is
//    deterministic: no float atomics.
//
// Generic variant (H, C and W at run time; every other shape).  Its stage
// math (gen_mlp, gen_stage_vjp) is in cde_generic.cuh, shared with the
// reversible kernels.
//  * One block of GEN_THREADS threads per batch lane (blocks stride over the
//    lanes); the lane's state and activations sit in shared memory, and the
//    threads split each matrix-vector product over its output rows.
//  * The weights are read from device memory through L1: up to
//    512 x 512 floats, more than a block's shared memory.
//  * Weight gradients accumulate per block, in shared memory when they fit
//    and in the block's own slice of the partials otherwise; each element
//    has one owning thread, so the sums are deterministic.  The number of
//    blocks is capped so the partials stay under 256 MB.
//
// Layouts (all float32, batch minor):
//   ct   (n, 3, C, B)  rows b, 2c, 3d of the control's cubic per interval
//                      (float32, or bfloat16 in the bfloat16 mode, as dct)
//   z0t  (H, B)        w1t (W, H)  b1 (W)  w2t (C*H, W)  b2 (C*H)
//   w2t/b2 rows are in the kernel order q = i*H + h (the model's h*C + i,
//   permuted by the wrapper).
//   slot (n) int32     output slot of knot j + 1, or -1
//   out  (n_out, H, B) zres (n, H, B): the state after every interval
// Backward outputs: dct (n, 3, C, B), dz0 (H, B) and per-block partials
//   dw1p (blocks, W, H), db1p (blocks, W), dw2p (blocks, W, C*H),
//   db2p (blocks, C*H), with blocks = ff_backward_blocks(...).

#include <stddef.h>

#include "cde_generic.cuh"
#include "cde_stage.cuh"

namespace {

constexpr int MAX_STAGES = 4;
constexpr int MAX_SUBSTEPS = 8;

// An explicit RK tableau whose stage s reads only stage s - 1 (euler,
// midpoint, heun, rk4): y_s = z + a_dt[s] * k_{s-1}.
struct Tableau {
  int n_stages;
  double alpha_dt[MAX_STAGES];  // alpha_s * dt_sub, the stage's time offset
  float a_dt[MAX_STAGES];       // dt_sub * A[s][s-1]
  float c_dt[MAX_STAGES];       // dt_sub * b_s
};

__device__ __forceinline__ float stage_fraction(const Tableau& tab, int s,
                                                int st, double dt) {
  return (float)((double)s * dt + tab.alpha_dt[st]);
}

// One substep (all stages) from z, in place.  With ys != nullptr the stage
// inputs are kept for the backward.
template <int H, int C, bool MX>
__device__ void substep(const Smem<H, C>& sm, int W, const Tableau& tab,
                        int s, double dt, const float (&sb)[C],
                        const float (&sc)[C], const float (&sd)[C],
                        float (&z)[H], float (*ys)[H]) {
  constexpr int CH = C * H;
  float znew[H], k[H];
#pragma unroll
  for (int h = 0; h < H; ++h) { znew[h] = z[h]; k[h] = 0.f; }
  for (int st = 0; st < tab.n_stages; ++st) {
    float y[H];
#pragma unroll
    for (int h = 0; h < H; ++h) y[h] = st ? z[h] + tab.a_dt[st] * k[h] : z[h];
    if (ys) {
#pragma unroll
      for (int h = 0; h < H; ++h) ys[st][h] = y[h];
    }
    float dx[C], g[CH];
    control_derivative<C>(sb, sc, sd, stage_fraction(tab, s, st, dt), dx);
    mlp_forward<H, C, false, MX>(sm, W, y, g, nullptr);
    contract<H, C>(g, dx, k);
    if (tab.c_dt[st] != 0.f) {
#pragma unroll
      for (int h = 0; h < H; ++h) znew[h] += tab.c_dt[st] * k[h];
    }
  }
#pragma unroll
  for (int h = 0; h < H; ++h) z[h] = znew[h];
}

template <int H, int C, typename T, bool MX>
__global__ void __launch_bounds__(LANES)
    fwd_kernel(const T* __restrict__ ct, const float* __restrict__ z0t,
               const float* __restrict__ w1t, const float* __restrict__ b1,
               const float* __restrict__ w2t, const float* __restrict__ b2,
               const int* __restrict__ slot, float* __restrict__ out,
               float* __restrict__ zres, int B, int n, int W, int m,
               double dt, Tableau tab) {
  extern __shared__ float smem[];
  const Smem<H, C> sm(smem, W);
  load_field<H, C>(sm, w1t, b1, w2t, b2, W);
  __syncthreads();
  const int lane = blockIdx.x * LANES + threadIdx.x;
  if (lane >= B) return;

  float z[H];
#pragma unroll
  for (int h = 0; h < H; ++h) z[h] = z0t[(size_t)h * B + lane];
  for (int j = 0; j < n; ++j) {
    float sb[C], sc[C], sd[C];
    load_slab<H, C, T>(ct, j, B, lane, true, sb, sc, sd);
    for (int s = 0; s < m; ++s)
      substep<H, C, MX>(sm, W, tab, s, dt, sb, sc, sd, z, nullptr);
#pragma unroll
    for (int h = 0; h < H; ++h) zres[((size_t)j * H + h) * B + lane] = z[h];
    const int sl = slot[j];
    if (sl >= 0) {
#pragma unroll
      for (int h = 0; h < H; ++h) out[((size_t)sl * H + h) * B + lane] = z[h];
    }
  }
}

template <int H, int C, typename T, bool MX>
__global__ void __launch_bounds__(LANES)
    bwd_kernel(const T* __restrict__ ct, const float* __restrict__ zres,
               const float* __restrict__ z0t, const float* __restrict__ gz,
               const float* __restrict__ w1t, const float* __restrict__ b1,
               const float* __restrict__ w2t, const float* __restrict__ b2,
               const int* __restrict__ slot, T* __restrict__ dct,
               float* __restrict__ dz0, float* __restrict__ dw1p,
               float* __restrict__ db1p, float* __restrict__ dw2p,
               float* __restrict__ db2p, int B, int n, int W, int m,
               double dt, Tableau tab) {
  constexpr int CH = C * H;
  extern __shared__ float smem[];
  const BwdSmem<H, C> sm(smem, W);
  load_field<H, C>(sm.field, w1t, b1, w2t, b2, W);
  for (int i = threadIdx.x; i < W * H; i += LANES) sm.acc_w1[i] = 0.f;
  for (int i = threadIdx.x; i < W * CH; i += LANES) sm.acc_w2[i] = 0.f;
  for (int i = threadIdx.x; i < W; i += LANES) sm.acc_b1[i] = 0.f;
  for (int i = threadIdx.x; i < CH; i += LANES) sm.acc_b2[i] = 0.f;
  __syncthreads();

  const int lane = blockIdx.x * LANES + threadIdx.x;
  const bool live = lane < B;
  const int S = tab.n_stages;
  float lam[H];
#pragma unroll
  for (int h = 0; h < H; ++h) lam[h] = 0.f;
  float zs[MAX_SUBSTEPS][H];

  for (int jr = 0; jr < n; ++jr) {
    const int j = n - 1 - jr;
    // Fold in the cotangent of a requested knot at this interval's end.
    const int sl = slot[j];
    if (live && sl >= 0) {
#pragma unroll
      for (int h = 0; h < H; ++h) lam[h] += gz[((size_t)sl * H + h) * B + lane];
    }
    float sb[C], sc[C], sd[C];
    load_slab<H, C, T>(ct, j, B, lane, live, sb, sc, sd);
    // Interval j starts from knot j: z0 or the residual of interval j - 1.
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float v = 0.f;
      if (live)
        v = j == 0 ? z0t[(size_t)h * B + lane]
                   : zres[((size_t)(j - 1) * H + h) * B + lane];
      zs[0][h] = v;
    }
    // Recompute the substep chain z_0 .. z_{m-1}.
    for (int s = 0; s + 1 < m; ++s) {
      float z[H];
#pragma unroll
      for (int h = 0; h < H; ++h) z[h] = zs[s][h];
      substep<H, C, MX>(sm.field, W, tab, s, dt, sb, sc, sd, z, nullptr);
#pragma unroll
      for (int h = 0; h < H; ++h) zs[s + 1][h] = z[h];
    }

    float acc_b[C], acc_c[C], acc_d[C];
#pragma unroll
    for (int i = 0; i < C; ++i) acc_b[i] = acc_c[i] = acc_d[i] = 0.f;
    for (int s = m - 1; s >= 0; --s) {
      float ys[MAX_STAGES][H];
      {
        float z[H];
#pragma unroll
        for (int h = 0; h < H; ++h) z[h] = zs[s][h];
        substep<H, C, MX>(sm.field, W, tab, s, dt, sb, sc, sd, z, ys);
      }
      float v[MAX_STAGES][H];
      for (int st = S - 1; st >= 0; --st) {
        float u[H], y[H], dy[H], dx[C], ddx[C];
#pragma unroll
        for (int h = 0; h < H; ++h) {
          float uh = tab.c_dt[st] != 0.f ? tab.c_dt[st] * lam[h] : 0.f;
          if (st + 1 < S) uh += tab.a_dt[st + 1] * v[st + 1][h];
          u[h] = uh;
          y[h] = ys[st][h];
        }
        const float fr = stage_fraction(tab, s, st, dt);
        control_derivative<C>(sb, sc, sd, fr, dx);
        stage_vjp<H, C, MX>(sm, W, u, y, dx, dy, ddx);
#pragma unroll
        for (int i = 0; i < C; ++i) {
          acc_b[i] += ddx[i];
          acc_c[i] += fr * ddx[i];
          acc_d[i] += (fr * fr) * ddx[i];
        }
#pragma unroll
        for (int h = 0; h < H; ++h) v[st][h] = dy[h];
      }
      for (int st = 0; st < S; ++st) {
#pragma unroll
        for (int h = 0; h < H; ++h) lam[h] += v[st][h];
      }
    }
    if (live) {
      T* row = dct + (size_t)j * 3 * C * B + lane;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        store_as(row + (size_t)i * B, acc_b[i]);
        store_as(row + (size_t)(C + i) * B, acc_c[i]);
        store_as(row + (size_t)(2 * C + i) * B, acc_d[i]);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int h = 0; h < H; ++h) dz0[(size_t)h * B + lane] = lam[h];
  }
  __syncthreads();
  const size_t blk = blockIdx.x;
  for (int i = threadIdx.x; i < W * H; i += LANES) dw1p[blk * W * H + i] = sm.acc_w1[i];
  for (int i = threadIdx.x; i < W * CH; i += LANES) dw2p[blk * W * CH + i] = sm.acc_w2[i];
  for (int i = threadIdx.x; i < W; i += LANES) db1p[blk * W + i] = sm.acc_b1[i];
  for (int i = threadIdx.x; i < CH; i += LANES) db2p[blk * CH + i] = sm.acc_b2[i];
}

// ---------------------------------------------------------------------------
// Generic variant: H, C and W at run time (shared pieces: cde_generic.cuh).

// Offsets, in floats, of the generic kernels' shared-memory vectors.
struct GenLayout {
  size_t z, znew, k, y, h1, g, dx, slab;     // both kernels
  size_t lam, zs, ys, v, u, dp1, dp2, acc;   // backward only
  size_t total;
  __host__ __device__ GenLayout(int H, int C, int W, int m, int S, bool bwd,
                                bool acc_smem) {
    const int CH = C * H;
    size_t top = 0;
    z = take(top, H);
    znew = take(top, H);
    k = take(top, H);
    y = take(top, H);
    h1 = take(top, W);
    g = take(top, CH);
    dx = take(top, C);
    slab = take(top, 3 * C);
    lam = zs = ys = v = u = dp1 = dp2 = acc = top;
    if (bwd) {
      lam = take(top, H);
      zs = take(top, (size_t)m * H);
      ys = take(top, (size_t)S * H);
      v = take(top, (size_t)S * H);
      u = take(top, H);
      dp1 = take(top, W);
      dp2 = take(top, CH);
      if (acc_smem) acc = take(top, partial_floats(H, C, W));
    }
    total = top;
  }
};

struct GenVecs {
  float *z, *znew, *k, *y, *h1, *g, *dx, *slab;
  float *lam, *zs, *ys, *v, *u, *dp1, *dp2, *acc;
  __device__ GenVecs(float* base, const GenLayout& L)
      : z(base + L.z), znew(base + L.znew), k(base + L.k), y(base + L.y),
        h1(base + L.h1), g(base + L.g), dx(base + L.dx), slab(base + L.slab),
        lam(base + L.lam), zs(base + L.zs), ys(base + L.ys), v(base + L.v),
        u(base + L.u), dp1(base + L.dp1), dp2(base + L.dp2),
        acc(base + L.acc) {}
  __device__ GenStage stage() const { return GenStage{h1, g, dx, u, dp1, dp2}; }
};

// dX/dt at fraction fr of the interval for channel i (thread i < C).
__device__ __forceinline__ float gen_dx(const GenVecs& s, int C, int i,
                                        float fr) {
  return s.slab[i] + (s.slab[C + i] + s.slab[2 * C + i] * fr) * fr;
}

// One substep (all stages) from z in shared memory, in place; with ys the
// stage inputs are kept (ys[st * H + h]).  Each state entry h belongs to one
// thread throughout.  With MX and sel (H % 8 != 0), k sums the rounded
// g dx_rounded, as the TPU kernel's selection product sel (g (rep dx)) does.
// Starts after, and ends with, a barrier.
template <bool MX>
__device__ void gen_substep(const GenField& f, const GenVecs& s,
                            const Tableau& tab, int step, double dt, float* z,
                            float* ys, bool sel) {
  const int H = f.H, C = f.C, tid = threadIdx.x, nt = blockDim.x;
  for (int st = 0; st < tab.n_stages; ++st) {
    for (int h = tid; h < H; h += nt) {
      if (st == 0) s.znew[h] = z[h];
      const float yh = st ? z[h] + tab.a_dt[st] * s.k[h] : z[h];
      s.y[h] = yh;
      if (ys) ys[st * H + h] = yh;
    }
    if (tid < C) s.dx[tid] = gen_dx(s, C, tid, stage_fraction(tab, step, st, dt));
    __syncthreads();
    gen_mlp<MX>(f, s.y, s.h1, s.g);
    const bool rsel = MX && sel;
    for (int h = tid; h < H; h += nt) {
      float acc;
      if (rsel) {
        acc = 0.f;
        for (int i = 0; i < C; ++i)
          acc += mx_round<true>(s.g[i * H + h] * mx_round<true>(s.dx[i]));
      } else {
        acc = s.g[h] * s.dx[0];
        for (int i = 1; i < C; ++i) acc += s.g[i * H + h] * s.dx[i];
      }
      s.k[h] = acc;
      if (tab.c_dt[st] != 0.f) s.znew[h] += tab.c_dt[st] * acc;
    }
    __syncthreads();
  }
  for (int h = tid; h < H; h += nt) z[h] = s.znew[h];
  __syncthreads();
}

template <typename T, bool MX>
__global__ void __launch_bounds__(GEN_THREADS)
    gen_fwd_kernel(const T* __restrict__ ct, const float* __restrict__ z0t,
                   GenField f, const int* __restrict__ slot,
                   float* __restrict__ out, float* __restrict__ zres, int B,
                   int n, int m, double dt, Tableau tab) {
  extern __shared__ float smem[];
  const GenVecs s(smem, GenLayout(f.H, f.C, f.W, m, tab.n_stages, false, false));
  const int H = f.H, C3 = 3 * f.C, tid = threadIdx.x, nt = blockDim.x;
  const bool sel = H % 8 != 0;
  for (int lane = blockIdx.x; lane < B; lane += gridDim.x) {
    for (int h = tid; h < H; h += nt) s.z[h] = z0t[(size_t)h * B + lane];
    for (int j = 0; j < n; ++j) {
      for (int r = tid; r < C3; r += nt) s.slab[r] = to_float(ct[((size_t)j * C3 + r) * B + lane]);
      __syncthreads();
      for (int step = 0; step < m; ++step)
        gen_substep<MX>(f, s, tab, step, dt, s.z, nullptr, sel);
      const int sl = slot[j];
      for (int h = tid; h < H; h += nt) {
        zres[((size_t)j * H + h) * B + lane] = s.z[h];
        if (sl >= 0) out[((size_t)sl * H + h) * B + lane] = s.z[h];
      }
    }
  }
}

template <typename T, bool MX>
__global__ void __launch_bounds__(GEN_THREADS)
    gen_bwd_kernel(const T* __restrict__ ct, const float* __restrict__ zres,
                   const float* __restrict__ z0t, const float* __restrict__ gz,
                   GenField f, const int* __restrict__ slot,
                   T* __restrict__ dct, float* __restrict__ dz0,
                   float* __restrict__ dw1p, float* __restrict__ db1p,
                   float* __restrict__ dw2p, float* __restrict__ db2p, int B,
                   int n, int m, double dt, Tableau tab, bool acc_smem) {
  extern __shared__ float smem[];
  const int H = f.H, C = f.C, W = f.W, CH = C * H, S = tab.n_stages;
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool sel = H % 8 != 0;
  const GenLayout L(H, C, W, m, S, true, acc_smem);
  const GenVecs s(smem, L);
  const size_t blk = blockIdx.x;
  const Grads mine{dw1p + blk * W * H, db1p + blk * W, dw2p + blk * W * CH,
                   db2p + blk * CH};
  const Grads gr = acc_smem ? Grads{s.acc, s.acc + W * H, s.acc + W * H + W,
                                    s.acc + W * H + W + W * CH}
                            : mine;
  // Each element of gr is zeroed, summed into and copied out by one thread.
  for (int e = tid; e < W * H; e += nt) gr.w1[e] = 0.f;
  for (int e = tid; e < W * CH; e += nt) gr.w2[e] = 0.f;
  for (int w = tid; w < W; w += nt) gr.b1[w] = 0.f;
  for (int q = tid; q < CH; q += nt) gr.b2[q] = 0.f;

  for (int lane = blockIdx.x; lane < B; lane += gridDim.x) {
    for (int h = tid; h < H; h += nt) s.lam[h] = 0.f;
    for (int jr = 0; jr < n; ++jr) {
      const int j = n - 1 - jr;
      // Fold in the cotangent of a requested knot at this interval's end;
      // interval j starts from knot j: z0 or the residual of interval j - 1.
      const int sl = slot[j];
      for (int h = tid; h < H; h += nt) {
        if (sl >= 0) s.lam[h] += gz[((size_t)sl * H + h) * B + lane];
        s.zs[h] = j == 0 ? z0t[(size_t)h * B + lane]
                         : zres[((size_t)(j - 1) * H + h) * B + lane];
      }
      for (int r = tid; r < 3 * C; r += nt) s.slab[r] = to_float(ct[((size_t)j * 3 * C + r) * B + lane]);
      __syncthreads();
      // Recompute the substep chain z_0 .. z_{m-1}.
      for (int step = 0; step + 1 < m; ++step) {
        float* next = s.zs + (size_t)(step + 1) * H;
        for (int h = tid; h < H; h += nt) next[h] = s.zs[(size_t)step * H + h];
        gen_substep<MX>(f, s, tab, step, dt, next, nullptr, sel);
      }
      float acc_b = 0.f, acc_c = 0.f, acc_d = 0.f;  // channel tid < C
      for (int step = m - 1; step >= 0; --step) {
        for (int h = tid; h < H; h += nt) s.z[h] = s.zs[(size_t)step * H + h];
        gen_substep<MX>(f, s, tab, step, dt, s.z, s.ys, sel);
        for (int st = S - 1; st >= 0; --st) {
          for (int h = tid; h < H; h += nt) {
            float uh = tab.c_dt[st] != 0.f ? tab.c_dt[st] * s.lam[h] : 0.f;
            if (st + 1 < S) uh += tab.a_dt[st + 1] * s.v[(st + 1) * H + h];
            s.u[h] = uh;
          }
          const float fr = stage_fraction(tab, step, st, dt);
          if (tid < C) s.dx[tid] = gen_dx(s, C, tid, fr);
          __syncthreads();
          const float ddx =
              gen_stage_vjp<MX>(f, s.stage(), s.ys + st * H, s.v + st * H, gr, sel);
          acc_b += ddx;
          acc_c += fr * ddx;
          acc_d += (fr * fr) * ddx;
        }
        for (int h = tid; h < H; h += nt) {
          for (int st = 0; st < S; ++st) s.lam[h] += s.v[st * H + h];
        }
      }
      if (tid < C) {
        T* row = dct + (size_t)j * 3 * C * B + lane;
        store_as(row + (size_t)tid * B, acc_b);
        store_as(row + (size_t)(C + tid) * B, acc_c);
        store_as(row + (size_t)(2 * C + tid) * B, acc_d);
      }
    }
    for (int h = tid; h < H; h += nt) dz0[(size_t)h * B + lane] = s.lam[h];
  }
  if (acc_smem) {
    for (int e = tid; e < W * H; e += nt) mine.w1[e] = gr.w1[e];
    for (int e = tid; e < W * CH; e += nt) mine.w2[e] = gr.w2[e];
    for (int w = tid; w < W; w += nt) mine.b1[w] = gr.b1[w];
    for (int q = tid; q < CH; q += nt) mine.b2[q] = gr.b2[q];
  }
}

size_t fwd_smem_bytes(int H, int C, int W) {
  return sizeof(float) * ((size_t)W * H + (size_t)W * C * H + W + C * H);
}

size_t bwd_smem_bytes(int H, int C, int W) {
  return fwd_smem_bytes(H, C, W) +
         sizeof(float) * (2 * (size_t)W * PAD + (size_t)LANES * C * H +
                          (size_t)LANES * H) +
         fwd_smem_bytes(H, C, W);
}

int make_tableau(int n_stages, const double* alpha, const double* a,
                 const double* c, double dt, Tableau* tab) {
  if (n_stages < 1 || n_stages > MAX_STAGES) return BAD_ARGUMENT;
  tab->n_stages = n_stages;
  for (int s = 0; s < MAX_STAGES; ++s) {
    const bool on = s < n_stages;
    tab->alpha_dt[s] = on ? alpha[s] * dt : 0.0;
    tab->a_dt[s] = on ? (float)(a[s] * dt) : 0.f;
    tab->c_dt[s] = on ? (float)(c[s] * dt) : 0.f;
  }
  return 0;
}

template <int H, int C, typename T, bool MX>
int launch_fwd(const T* ct, const float* z0t, const float* w1t,
               const float* b1, const float* w2t, const float* b2,
               const int* slot, float* out, float* zres, int B, int n, int W,
               int m, double dt, const Tableau& tab, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(H, C, W);
  cudaError_t err = set_smem(fwd_kernel<H, C, T, MX>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + LANES - 1) / LANES);
  fwd_kernel<H, C, T, MX><<<grid, LANES, smem, stream>>>(
      ct, z0t, w1t, b1, w2t, b2, slot, out, zres, B, n, W, m, dt, tab);
  return (int)cudaGetLastError();
}

template <int H, int C, typename T, bool MX>
int launch_bwd(const T* ct, const float* zres, const float* z0t,
               const float* gz, const float* w1t, const float* b1,
               const float* w2t, const float* b2, const int* slot, T* dct,
               float* dz0, float* dw1p, float* db1p, float* dw2p, float* db2p,
               int B, int n, int W, int m, double dt, const Tableau& tab,
               cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(H, C, W);
  cudaError_t err = set_smem(bwd_kernel<H, C, T, MX>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + LANES - 1) / LANES);
  bwd_kernel<H, C, T, MX><<<grid, LANES, smem, stream>>>(
      ct, zres, z0t, gz, w1t, b1, w2t, b2, slot, dct, dz0, dw1p, db1p, dw2p,
      db2p, B, n, W, m, dt, tab);
  return (int)cudaGetLastError();
}

template <typename T, bool MX>
int launch_gen_fwd(const T* ct, const float* z0t, const GenField& f,
                   const int* slot, float* out, float* zres, int B, int n,
                   int m, double dt, const Tableau& tab, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * GenLayout(f.H, f.C, f.W, m, tab.n_stages, false, false).total;
  if (smem > MAX_SMEM) return BAD_ARGUMENT;
  cudaError_t err = set_smem(gen_fwd_kernel<T, MX>, smem);
  if (err != cudaSuccess) return (int)err;
  gen_fwd_kernel<T, MX><<<B, GEN_THREADS, smem, stream>>>(ct, z0t, f, slot, out,
                                                          zres, B, n, m, dt, tab);
  return (int)cudaGetLastError();
}

template <typename T, bool MX>
int launch_gen_bwd(const T* ct, const float* zres, const float* z0t,
                   const float* gz, const GenField& f, const int* slot,
                   T* dct, float* dz0, float* dw1p, float* db1p,
                   float* dw2p, float* db2p, int B, int n, int m, double dt,
                   const Tableau& tab, cudaStream_t stream) {
  const int S = tab.n_stages;
  const bool acc_smem =
      sizeof(float) * GenLayout(f.H, f.C, f.W, m, S, true, true).total <= MAX_SMEM;
  const size_t smem =
      sizeof(float) * GenLayout(f.H, f.C, f.W, m, S, true, acc_smem).total;
  if (smem > MAX_SMEM) return BAD_ARGUMENT;
  cudaError_t err = set_smem(gen_bwd_kernel<T, MX>, smem);
  if (err != cudaSuccess) return (int)err;
  gen_bwd_kernel<T, MX><<<gen_backward_blocks(B, f.H, f.C, f.W), GEN_THREADS, smem,
                          stream>>>(ct, zres, z0t, gz, f, slot, dct, dz0, dw1p, db1p,
                                    dw2p, db2p, B, n, m, dt, tab, acc_smem);
  return (int)cudaGetLastError();
}

// Both variants of one mode: T the slab storage, MX the operand rounding.
template <typename T, bool MX>
int forward_mode(const void* ct, const float* z0t, const float* w1t,
                 const float* b1, const float* w2t, const float* b2,
                 const int* slot, float* out, float* zres, int B, int n, int H,
                 int C, int W, int m, double dt, const Tableau& tab, int variant,
                 cudaStream_t st) {
  const T* slabs = static_cast<const T*>(ct);
  if (variant == SPECIALISED)
    return launch_fwd<8, 3, T, MX>(slabs, z0t, w1t, b1, w2t, b2, slot, out, zres,
                                   B, n, W, m, dt, tab, st);
  return launch_gen_fwd<T, MX>(slabs, z0t, GenField{w1t, b1, w2t, b2, H, C, W},
                               slot, out, zres, B, n, m, dt, tab, st);
}

template <typename T, bool MX>
int backward_mode(const void* ct, const float* zres, const float* z0t,
                  const float* gz, const float* w1t, const float* b1,
                  const float* w2t, const float* b2, const int* slot, void* dct,
                  float* dz0, float* dw1p, float* db1p, float* dw2p, float* db2p,
                  int B, int n, int H, int C, int W, int m, double dt,
                  const Tableau& tab, int variant, cudaStream_t st) {
  const T* slabs = static_cast<const T*>(ct);
  T* dslabs = static_cast<T*>(dct);
  if (variant == SPECIALISED)
    return launch_bwd<8, 3, T, MX>(slabs, zres, z0t, gz, w1t, b1, w2t, b2, slot,
                                   dslabs, dz0, dw1p, db1p, dw2p, db2p, B, n, W,
                                   m, dt, tab, st);
  return launch_gen_bwd<T, MX>(slabs, zres, z0t, gz,
                               GenField{w1t, b1, w2t, b2, H, C, W}, slot, dslabs,
                               dz0, dw1p, db1p, dw2p, db2p, B, n, m, dt, tab, st);
}

bool specialised_fits(int H, int C, int W) {
  return H == 8 && C == 3 && bwd_smem_bytes(8, 3, W) <= MAX_SMEM;
}

int check_call(int B, int n, int H, int C, int W, int m, int variant,
               int mode, int n_stages, const double* alpha, const double* a,
               const double* c, double dt, Tableau* tab) {
  if (B < 1 || n < 1 || H < 1 || C < 1 || W < 1 || m < 1 || m > MAX_SUBSTEPS ||
      (mode != 0 && mode != 1))
    return BAD_ARGUMENT;
  if (variant != GENERIC && !(variant == SPECIALISED && specialised_fits(H, C, W)))
    return BAD_VARIANT;
  return make_tableau(n_stages, alpha, a, c, dt, tab);
}

}  // namespace

extern "C" {

const char* ff_error_string(int code) {
  if (code == BAD_ARGUMENT) return "invalid argument";
  if (code == BAD_VARIANT) return "no such kernel variant for these shapes";
  return cudaGetErrorString((cudaError_t)code);
}

// The variant that runs these shapes: 0 specialised, 1 generic.
int ff_variant(int H, int C, int W, int force_generic) {
  return !force_generic && specialised_fits(H, C, W) ? SPECIALISED : GENERIC;
}

// Blocks of the backward launch: the leading size of its weight partials.
int ff_backward_blocks(int B, int H, int C, int W, int variant) {
  return variant == SPECIALISED ? (B + LANES - 1) / LANES
                                : gen_backward_blocks(B, H, C, W);
}

// mode 0: float32 ct and dct; mode 1: bfloat16 ct and dct, bfloat16
// operands in the stage products (the other pointers are float32 in both).
int ff_forward(const void* ct, const float* z0t, const float* w1t,
               const float* b1, const float* w2t, const float* b2,
               const int* slot, float* out, float* zres, int B, int n, int H,
               int C, int W, int m, double dt, int n_stages,
               const double* alpha, const double* a, const double* c,
               int variant, int mode, void* stream) {
  Tableau tab;
  const int rc = check_call(B, n, H, C, W, m, variant, mode, n_stages, alpha, a, c, dt, &tab);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 1)
    return forward_mode<__nv_bfloat16, true>(ct, z0t, w1t, b1, w2t, b2, slot, out,
                                             zres, B, n, H, C, W, m, dt, tab,
                                             variant, st);
  return forward_mode<float, false>(ct, z0t, w1t, b1, w2t, b2, slot, out, zres, B,
                                    n, H, C, W, m, dt, tab, variant, st);
}

int ff_backward(const void* ct, const float* zres, const float* z0t,
                const float* gz, const float* w1t, const float* b1,
                const float* w2t, const float* b2, const int* slot,
                void* dct, float* dz0, float* dw1p, float* db1p, float* dw2p,
                float* db2p, int B, int n, int H, int C, int W, int m,
                double dt, int n_stages, const double* alpha, const double* a,
                const double* c, int variant, int mode, void* stream) {
  Tableau tab;
  const int rc = check_call(B, n, H, C, W, m, variant, mode, n_stages, alpha, a, c, dt, &tab);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 1)
    return backward_mode<__nv_bfloat16, true>(ct, zres, z0t, gz, w1t, b1, w2t, b2,
                                              slot, dct, dz0, dw1p, db1p, dw2p,
                                              db2p, B, n, H, C, W, m, dt, tab,
                                              variant, st);
  return backward_mode<float, false>(ct, zres, z0t, gz, w1t, b1, w2t, b2, slot, dct,
                                     dz0, dw1p, db1p, dw2p, db2p, B, n, H, C, W, m,
                                     dt, tab, variant, st);
}

}  // extern "C"
