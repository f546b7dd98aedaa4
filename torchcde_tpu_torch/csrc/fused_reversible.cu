// Reversible-Heun Neural CDE solve, forward and backward, as two CUDA
// kernels for Hopper (sm_90a).
//
// Replaces torchcde_tpu/solvers/fused_pallas.py::_rev_fwd_kernel and
// ::_rev_bwd_kernel (built by _make_fused_rev_solve).  The forward runs the
// algebraically reversible Heun method over uniform knots, m substeps of dt
// per interval, carrying the state y and its companion yh:
//   yh1 = 2 y - yh + dt f(yh),  y1 = y + dt/2 (f(yh) + f(yh1)),
// with f(yh) = MLP(yh) . dX/dt.  At the start of every interval f is
// evaluated anew at the interval's fraction 0 with its own rows: dX/dt may
// jump at a knot.  Both y and yh are stored after every interval.  The
// backward walks the intervals in reverse, restarts each from its stored
// (y, yh), so the inverse map never runs across more than one interval and
// its rounding does not accumulate, and per substep, in reverse, rebuilds
//   yh0 = 2 y1 - yh1 - dt f(yh1),  y0 = y1 - dt/2 (f(yh1) + f(yh0)),
// and pulls the cotangents (a_y, a_yh) back through the step:
//   u1 = dt/2 a_y            -> v1 = J(yh1)^T u1,
//   u0 = dt/2 a_y + dt (a_yh + v1) -> v0 = J(yh0)^T u0,
//   a_y += 2 (a_yh + v1),  a_yh = -(a_yh + v1) + v0.
// The two evaluations the inverse needs are the ones the two VJPs recompute
// anyway, so a substep costs two MLP evaluations and two VJPs.
//
// What bounds it.  As for K1 (fused_fixed.cu): a serial chain of small
// dependent matrix-vector products per batch lane, 2 W H (1 + C) FLOP per
// evaluation.  At BASELINE config 5 (B 16384, 99 intervals, m 1, H 8, W 128,
// C 3) the forward evaluates (m + 1) n B times, 26.6 GFLOP; the backward
// evaluates 2 m n B times and adds the VJPs' products and the weight
// gradients' products, 6 m n B evaluations' worth, 79.7 GFLOP.  The control
// rows (58 MB) and the stored states (104 MB, written once, read once) are
// below that: compute-bound on the CUDA cores.
//
// Two variants compute the same function; fr_variant picks one from the
// shapes, and every shape inside the JAX package's caps (W <= 512,
// C*H <= 512, 3*C <= 16, m <= 8) launches one of them.
//
// Specialised variant (H 8, C 3 at widths whose backward fits in shared
// memory, W <= 432): one thread per batch lane, blocks of one warp, the
// weights in shared memory, the stage math of cde_stage.cuh; a batch of 16384
// is 512 warps.  Weight gradients are reduced per block in shared memory and
// written as per-block partials, summed after the launch (deterministic, no
// float atomics).
//
// Generic variant (H, C and W at run time): one block of GEN_THREADS threads
// per lane (blocks stride over the lanes), the lane's vectors in shared
// memory, the weights through L1, and the stage math of cde_generic.cuh
// (shared with K1's generic variant).  Weight gradients accumulate per block,
// in shared memory when they fit and in the block's own slice of the
// partials otherwise.
//
// Layouts (all float32, batch minor):
//   ct   (n, 3, C, B)  rows b, 2c, 3d of the control's cubic per interval
//   z0t  (H, B)        w1t (W, H)  b1 (W)  w2t (C*H, W)  b2 (C*H)
//   y, yh (n, H, B)    the state and its companion after every interval
// Backward: gy (n, H, B), the cotangent of y; outputs dct (n, 3, C, B),
// dz0 (H, B) and per-block partials dw1p (blocks, W, H), db1p (blocks, W),
// dw2p (blocks, W, C*H), db2p (blocks, C*H), with blocks =
// fr_backward_blocks(...).

#include <stddef.h>

#include "cde_generic.cuh"
#include "cde_stage.cuh"

namespace {

constexpr int MAX_SUBSTEPS = 8;

// The interval's fraction after s substeps of dt, rounded once.
__device__ __forceinline__ float fraction(int s, double dt) {
  return (float)((double)s * dt);
}

template <int H, int C>
__device__ __forceinline__ void field(const Smem<H, C>& sm, int W,
                                      const float (&y)[H],
                                      const float (&dx)[C], float (&k)[H]) {
  float g[C * H];
  mlp_forward<H, C, false>(sm, W, y, g, nullptr);
  contract<H, C>(g, dx, k);
}

template <int H, int C>
__global__ void __launch_bounds__(LANES)
    rev_fwd_kernel(const float* __restrict__ ct, const float* __restrict__ z0t,
                   const float* __restrict__ w1t, const float* __restrict__ b1,
                   const float* __restrict__ w2t, const float* __restrict__ b2,
                   float* __restrict__ yres, float* __restrict__ yhres, int B,
                   int n, int W, int m, double dt) {
  extern __shared__ float smem[];
  const Smem<H, C> sm(smem, W);
  load_field<H, C>(sm, w1t, b1, w2t, b2, W);
  __syncthreads();
  const int lane = blockIdx.x * LANES + threadIdx.x;
  if (lane >= B) return;
  const float dtf = (float)dt, hdt = (float)(0.5 * dt);

  float y[H], yh[H];
#pragma unroll
  for (int h = 0; h < H; ++h) y[h] = yh[h] = z0t[(size_t)h * B + lane];
  for (int j = 0; j < n; ++j) {
    float sb[C], sc[C], sd[C], dx[C], f[H];
    load_slab<H, C>(ct, j, B, lane, true, sb, sc, sd);
    control_derivative<C>(sb, sc, sd, 0.f, dx);
    field<H, C>(sm, W, yh, dx, f);
    for (int s = 0; s < m; ++s) {
      float yn[H], f1[H];
#pragma unroll
      for (int h = 0; h < H; ++h) yn[h] = 2.f * y[h] - yh[h] + dtf * f[h];
      control_derivative<C>(sb, sc, sd, fraction(s + 1, dt), dx);
      field<H, C>(sm, W, yn, dx, f1);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        y[h] = y[h] + hdt * (f[h] + f1[h]);
        yh[h] = yn[h];
        f[h] = f1[h];
      }
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
      yres[((size_t)j * H + h) * B + lane] = y[h];
      yhres[((size_t)j * H + h) * B + lane] = yh[h];
    }
  }
}

template <int H, int C>
__global__ void __launch_bounds__(LANES)
    rev_bwd_kernel(const float* __restrict__ ct, const float* __restrict__ yres,
                   const float* __restrict__ yhres, const float* __restrict__ gy,
                   const float* __restrict__ w1t, const float* __restrict__ b1,
                   const float* __restrict__ w2t, const float* __restrict__ b2,
                   float* __restrict__ dct, float* __restrict__ dz0,
                   float* __restrict__ dw1p, float* __restrict__ db1p,
                   float* __restrict__ dw2p, float* __restrict__ db2p, int B,
                   int n, int W, int m, double dt) {
  extern __shared__ float smem[];
  const BwdSmem<H, C> sm(smem, W);
  load_field<H, C>(sm.field, w1t, b1, w2t, b2, W);
  sm.zero_acc(W);
  __syncthreads();

  const int lane = blockIdx.x * LANES + threadIdx.x;
  const bool live = lane < B;
  const float dtf = (float)dt, hdt = (float)(0.5 * dt);
  float ay[H], ayh[H];
#pragma unroll
  for (int h = 0; h < H; ++h) ay[h] = ayh[h] = 0.f;

  for (int jr = 0; jr < n; ++jr) {
    const int j = n - 1 - jr;
    // Knot j + 1's cotangent enters as its interval's walk starts, from the
    // state stored there (lanes past the batch walk zeros).
    float y1[H], yh1[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const size_t at = ((size_t)j * H + h) * B + lane;
      if (live) ay[h] += gy[at];
      y1[h] = live ? yres[at] : 0.f;
      yh1[h] = live ? yhres[at] : 0.f;
    }
    float sb[C], sc[C], sd[C];
    load_slab<H, C>(ct, j, B, lane, live, sb, sc, sd);
    float acc_b[C], acc_c[C], acc_d[C];
#pragma unroll
    for (int i = 0; i < C; ++i) acc_b[i] = acc_c[i] = acc_d[i] = 0.f;

    for (int s = m - 1; s >= 0; --s) {
      const float fr1 = fraction(s + 1, dt), fr0 = fraction(s, dt);
      float dx[C], ddx[C], u[H], v[H], f1[H], f0[H], yh0[H];
      // The step's second evaluation: f1 = f(yh1) and its VJP.
      control_derivative<C>(sb, sc, sd, fr1, dx);
#pragma unroll
      for (int h = 0; h < H; ++h) u[h] = hdt * ay[h];
      stage_vjp<H, C>(sm, W, u, yh1, dx, v, ddx, &f1);
#pragma unroll
      for (int i = 0; i < C; ++i) {
        acc_b[i] += ddx[i];
        acc_c[i] += fr1 * ddx[i];
        acc_d[i] += (fr1 * fr1) * ddx[i];
      }
      // The inverse map's companion, then its evaluation f0 = f(yh0) and VJP.
#pragma unroll
      for (int h = 0; h < H; ++h) {
        yh0[h] = 2.f * y1[h] - yh1[h] - dtf * f1[h];
        ayh[h] += v[h];
        u[h] = hdt * ay[h] + dtf * ayh[h];
      }
      control_derivative<C>(sb, sc, sd, fr0, dx);
      stage_vjp<H, C>(sm, W, u, yh0, dx, v, ddx, &f0);
#pragma unroll
      for (int i = 0; i < C; ++i) {
        acc_b[i] += ddx[i];
        acc_c[i] += fr0 * ddx[i];
        acc_d[i] += (fr0 * fr0) * ddx[i];
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {
        y1[h] = y1[h] - hdt * (f1[h] + f0[h]);
        yh1[h] = yh0[h];
        ay[h] = ay[h] + 2.f * ayh[h];
        ayh[h] = -ayh[h] + v[h];
      }
    }
    if (live) {
      float* row = dct + (size_t)j * 3 * C * B + lane;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        row[(size_t)i * B] = acc_b[i];
        row[(size_t)(C + i) * B] = acc_c[i];
        row[(size_t)(2 * C + i) * B] = acc_d[i];
      }
    }
  }
  // y and yh both start at z0: both adjoints flow there.
  if (live) {
#pragma unroll
    for (int h = 0; h < H; ++h) dz0[(size_t)h * B + lane] = ay[h] + ayh[h];
  }
  __syncthreads();
  sm.store_acc(W, dw1p, db1p, dw2p, db2p);
}

// ---------------------------------------------------------------------------
// Generic variant: H, C and W at run time.

// Offsets, in floats, of the generic kernels' shared-memory vectors.
struct RevLayout {
  size_t y, yh, yn, f, f1, h1, g, dx, slab;  // both kernels
  size_t ay, ayh, u, v, dp1, dp2, acc;       // backward only
  size_t total;
  __host__ __device__ RevLayout(int H, int C, int W, bool bwd, bool acc_smem) {
    const int CH = C * H;
    size_t top = 0;
    y = take(top, H);
    yh = take(top, H);
    yn = take(top, H);
    f = take(top, H);
    f1 = take(top, H);
    h1 = take(top, W);
    g = take(top, CH);
    dx = take(top, C);
    slab = take(top, 3 * C);
    ay = ayh = u = v = dp1 = dp2 = acc = top;
    if (bwd) {
      ay = take(top, H);
      ayh = take(top, H);
      u = take(top, H);
      v = take(top, H);
      dp1 = take(top, W);
      dp2 = take(top, CH);
      if (acc_smem) acc = take(top, partial_floats(H, C, W));
    }
    total = top;
  }
};

struct RevVecs {
  float *y, *yh, *yn, *f, *f1, *h1, *g, *dx, *slab;
  float *ay, *ayh, *u, *v, *dp1, *dp2, *acc;
  __device__ RevVecs(float* base, const RevLayout& L)
      : y(base + L.y), yh(base + L.yh), yn(base + L.yn), f(base + L.f),
        f1(base + L.f1), h1(base + L.h1), g(base + L.g), dx(base + L.dx),
        slab(base + L.slab), ay(base + L.ay), ayh(base + L.ayh), u(base + L.u),
        v(base + L.v), dp1(base + L.dp1), dp2(base + L.dp2),
        acc(base + L.acc) {}
  __device__ GenStage stage() const { return GenStage{h1, g, dx, u, dp1, dp2}; }
  // dX/dt at fraction fr of the interval, channel i to thread i < C.
  __device__ void set_dx(int C, float fr) const {
    const int i = threadIdx.x;
    if (i < C) dx[i] = slab[i] + (slab[C + i] + slab[2 * C + i] * fr) * fr;
  }
  // Entry h of the evaluation, from g and dx.
  __device__ float entry(int H, int C, int h) const {
    float acc = g[h] * dx[0];
    for (int i = 1; i < C; ++i) acc += g[i * H + h] * dx[i];
    return acc;
  }
};

__global__ void __launch_bounds__(GEN_THREADS)
    gen_rev_fwd_kernel(const float* __restrict__ ct, const float* __restrict__ z0t,
                       GenField f, float* __restrict__ yres,
                       float* __restrict__ yhres, int B, int n, int m, double dt) {
  extern __shared__ float smem[];
  const RevVecs s(smem, RevLayout(f.H, f.C, f.W, false, false));
  const int H = f.H, C = f.C, tid = threadIdx.x, nt = blockDim.x;
  const float dtf = (float)dt, hdt = (float)(0.5 * dt);
  // Each state entry h belongs to one thread throughout.
  for (int lane = blockIdx.x; lane < B; lane += gridDim.x) {
    for (int h = tid; h < H; h += nt) s.y[h] = s.yh[h] = z0t[(size_t)h * B + lane];
    for (int j = 0; j < n; ++j) {
      for (int r = tid; r < 3 * C; r += nt) s.slab[r] = ct[((size_t)j * 3 * C + r) * B + lane];
      __syncthreads();
      s.set_dx(C, 0.f);
      __syncthreads();
      gen_mlp(f, s.yh, s.h1, s.g);
      for (int h = tid; h < H; h += nt) s.f[h] = s.entry(H, C, h);
      for (int step = 0; step < m; ++step) {
        for (int h = tid; h < H; h += nt) s.yn[h] = 2.f * s.y[h] - s.yh[h] + dtf * s.f[h];
        __syncthreads();
        s.set_dx(C, fraction(step + 1, dt));
        __syncthreads();
        gen_mlp(f, s.yn, s.h1, s.g);
        for (int h = tid; h < H; h += nt) {
          const float f1 = s.entry(H, C, h);
          s.y[h] = s.y[h] + hdt * (s.f[h] + f1);
          s.yh[h] = s.yn[h];
          s.f[h] = f1;
        }
      }
      for (int h = tid; h < H; h += nt) {
        yres[((size_t)j * H + h) * B + lane] = s.y[h];
        yhres[((size_t)j * H + h) * B + lane] = s.yh[h];
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(GEN_THREADS)
    gen_rev_bwd_kernel(const float* __restrict__ ct, const float* __restrict__ yres,
                       const float* __restrict__ yhres, const float* __restrict__ gy,
                       GenField f, float* __restrict__ dct, float* __restrict__ dz0,
                       float* __restrict__ dw1p, float* __restrict__ db1p,
                       float* __restrict__ dw2p, float* __restrict__ db2p, int B,
                       int n, int m, double dt, bool acc_smem) {
  extern __shared__ float smem[];
  const int H = f.H, C = f.C, W = f.W, CH = C * H;
  const int tid = threadIdx.x, nt = blockDim.x;
  const RevVecs s(smem, RevLayout(H, C, W, true, acc_smem));
  const GenStage st = s.stage();
  const float dtf = (float)dt, hdt = (float)(0.5 * dt);
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
    for (int h = tid; h < H; h += nt) s.ay[h] = s.ayh[h] = 0.f;
    for (int jr = 0; jr < n; ++jr) {
      const int j = n - 1 - jr;
      for (int h = tid; h < H; h += nt) {
        const size_t at = ((size_t)j * H + h) * B + lane;
        s.ay[h] += gy[at];
        s.y[h] = yres[at];
        s.yh[h] = yhres[at];
      }
      for (int r = tid; r < 3 * C; r += nt) s.slab[r] = ct[((size_t)j * 3 * C + r) * B + lane];
      float acc_b = 0.f, acc_c = 0.f, acc_d = 0.f;  // channel tid < C
      for (int step = m - 1; step >= 0; --step) {
        const float fr1 = fraction(step + 1, dt), fr0 = fraction(step, dt);
        for (int h = tid; h < H; h += nt) s.u[h] = hdt * s.ay[h];
        __syncthreads();
        s.set_dx(C, fr1);
        __syncthreads();
        float ddx = gen_stage_vjp(f, st, s.yh, s.v, gr);  // s.g: g(yh1)
        acc_b += ddx;
        acc_c += fr1 * ddx;
        acc_d += (fr1 * fr1) * ddx;
        for (int h = tid; h < H; h += nt) {
          const float f1 = s.entry(H, C, h);
          s.f1[h] = f1;
          s.yn[h] = 2.f * s.y[h] - s.yh[h] - dtf * f1;  // yh0
          s.ayh[h] += s.v[h];
          s.u[h] = hdt * s.ay[h] + dtf * s.ayh[h];
        }
        __syncthreads();
        s.set_dx(C, fr0);
        __syncthreads();
        ddx = gen_stage_vjp(f, st, s.yn, s.v, gr);  // s.g: g(yh0)
        acc_b += ddx;
        acc_c += fr0 * ddx;
        acc_d += (fr0 * fr0) * ddx;
        for (int h = tid; h < H; h += nt) {
          s.y[h] = s.y[h] - hdt * (s.f1[h] + s.entry(H, C, h));
          s.yh[h] = s.yn[h];
          s.ay[h] = s.ay[h] + 2.f * s.ayh[h];
          s.ayh[h] = -s.ayh[h] + s.v[h];
        }
      }
      if (tid < C) {
        float* row = dct + (size_t)j * 3 * C * B + lane;
        row[(size_t)tid * B] = acc_b;
        row[(size_t)(C + tid) * B] = acc_c;
        row[(size_t)(2 * C + tid) * B] = acc_d;
      }
      __syncthreads();
    }
    for (int h = tid; h < H; h += nt) dz0[(size_t)h * B + lane] = s.ay[h] + s.ayh[h];
  }
  if (acc_smem) {
    for (int e = tid; e < W * H; e += nt) mine.w1[e] = gr.w1[e];
    for (int e = tid; e < W * CH; e += nt) mine.w2[e] = gr.w2[e];
    for (int w = tid; w < W; w += nt) mine.b1[w] = gr.b1[w];
    for (int q = tid; q < CH; q += nt) mine.b2[q] = gr.b2[q];
  }
}

bool specialised_fits(int H, int C, int W) {
  return H == 8 && C == 3 && sizeof(float) * BwdSmem<8, 3>::floats(W) <= MAX_SMEM;
}

int check_call(int B, int n, int H, int C, int W, int m, int variant) {
  if (B < 1 || n < 1 || H < 1 || C < 1 || W < 1 || m < 1 || m > MAX_SUBSTEPS)
    return BAD_ARGUMENT;
  if (variant != GENERIC && !(variant == SPECIALISED && specialised_fits(H, C, W)))
    return BAD_VARIANT;
  return 0;
}

}  // namespace

extern "C" {

const char* fr_error_string(int code) {
  if (code == BAD_ARGUMENT) return "invalid argument";
  if (code == BAD_VARIANT) return "no such kernel variant for these shapes";
  return cudaGetErrorString((cudaError_t)code);
}

// The variant that runs these shapes: 0 specialised, 1 generic.
int fr_variant(int H, int C, int W, int force_generic) {
  return !force_generic && specialised_fits(H, C, W) ? SPECIALISED : GENERIC;
}

// Blocks of the backward launch: the leading size of its weight partials.
int fr_backward_blocks(int B, int H, int C, int W, int variant) {
  return variant == SPECIALISED ? (B + LANES - 1) / LANES
                                : gen_backward_blocks(B, H, C, W);
}

int fr_forward(const float* ct, const float* z0t, const float* w1t,
               const float* b1, const float* w2t, const float* b2, float* yres,
               float* yhres, int B, int n, int H, int C, int W, int m,
               double dt, int variant, void* stream) {
  const int rc = check_call(B, n, H, C, W, m, variant);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (variant == SPECIALISED) {
    const size_t smem = sizeof(float) * Smem<8, 3>::floats(W);
    err = set_smem(rev_fwd_kernel<8, 3>, smem);
    if (err != cudaSuccess) return (int)err;
    rev_fwd_kernel<8, 3><<<(B + LANES - 1) / LANES, LANES, smem, st>>>(
        ct, z0t, w1t, b1, w2t, b2, yres, yhres, B, n, W, m, dt);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(float) * RevLayout(H, C, W, false, false).total;
  if (smem > MAX_SMEM) return BAD_ARGUMENT;
  err = set_smem(gen_rev_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  gen_rev_fwd_kernel<<<B, GEN_THREADS, smem, st>>>(
      ct, z0t, GenField{w1t, b1, w2t, b2, H, C, W}, yres, yhres, B, n, m, dt);
  return (int)cudaGetLastError();
}

int fr_backward(const float* ct, const float* yres, const float* yhres,
                const float* gy, const float* w1t, const float* b1,
                const float* w2t, const float* b2, float* dct, float* dz0,
                float* dw1p, float* db1p, float* dw2p, float* db2p, int B,
                int n, int H, int C, int W, int m, double dt, int variant,
                void* stream) {
  const int rc = check_call(B, n, H, C, W, m, variant);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (variant == SPECIALISED) {
    const size_t smem = sizeof(float) * BwdSmem<8, 3>::floats(W);
    err = set_smem(rev_bwd_kernel<8, 3>, smem);
    if (err != cudaSuccess) return (int)err;
    rev_bwd_kernel<8, 3><<<(B + LANES - 1) / LANES, LANES, smem, st>>>(
        ct, yres, yhres, gy, w1t, b1, w2t, b2, dct, dz0, dw1p, db1p, dw2p,
        db2p, B, n, W, m, dt);
    return (int)cudaGetLastError();
  }
  const bool acc_smem = sizeof(float) * RevLayout(H, C, W, true, true).total <= MAX_SMEM;
  const size_t smem = sizeof(float) * RevLayout(H, C, W, true, acc_smem).total;
  if (smem > MAX_SMEM) return BAD_ARGUMENT;
  err = set_smem(gen_rev_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  gen_rev_bwd_kernel<<<gen_backward_blocks(B, H, C, W), GEN_THREADS, smem, st>>>(
      ct, yres, yhres, gy, GenField{w1t, b1, w2t, b2, H, C, W}, dct, dz0, dw1p,
      db1p, dw2p, db2p, B, n, m, dt, acc_smem);
  return (int)cudaGetLastError();
}

}  // extern "C"
