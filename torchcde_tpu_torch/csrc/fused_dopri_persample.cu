// Per-sample adaptive dopri5 Neural CDE solve of one chunk, forward and
// backward, as two CUDA kernels for Hopper (sm_90a): kernel pair K9.
//
// Replaces torchcde_tpu/solvers/fused_dopri_persample.py::_psd_fwd_kernel and
// ::_psd_bwd_kernel, for cubic controls and in their linear-control mode.
// Every lane runs its own PI-controlled solve of dz = MLP(z) . dX/dt over the
// chunk: its own time, step proposal and error norm over its own hidden
// channels, its own attempted-step budget (global, carried across chunks in
// the controller rows) and its own output times.  A lane is active until it
// reaches min(its end, the chunk's end), runs out of budget, or has attempted
// the chunk's cap; a lane that ended short, or entered poisoned, writes NaN
// into its state and into its output rows from its chunk-entry time on, and
// carries the poison flag to later chunks.  The backward walks each lane's
// accepted steps in reverse: the frozen-mesh gradients of direct
// backpropagation through the lane's adaptive loop.
//
// What bounds it.  As K2 (fused_dopri.cu), a serial chain of small
// matrix-vector products per lane, 2 W H (1 + C) FLOP per stage evaluation,
// latency- and compute-bound on the CUDA cores; here each lane's step count
// is its own, so a warp runs as long as its slowest lane.
//
// Design.
//  * Lanes are independent: no norm to share, so no cooperative launch and
//    no cross-block reduction.  One thread per lane, blocks of one warp
//    (32 lanes), each thread running its own loop.  This is the JAX kernel's
//    lockstep loop seen from one lane: there a lane is active from the first
//    iteration until it finishes and idle after, so its attempts in a chunk
//    are min(need, cap) either way.
//  * Each lane reads its own interval of the table (CUDA can gather; the TPU
//    kernel evaluates every resident interval and reduces one-hot).
//  * The store keeps each lane's accepted steps only (t, dt and the entry
//    state): a rejected or idle iteration of the TPU kernel's store has
//    accept 0 and contributes nothing to any gradient.
//  * The backward runs the block's lanes in lockstep for as many iterations
//    as the block's longest mesh, each lane on its own steps in reverse; a
//    lane past its count passes zero cotangents, so that the field's VJP
//    can reduce the block's weight gradients behind its barriers.  Each lane
//    owns its dct column (no atomics); weight gradients are deterministic
//    per-block partials, as in K1, K2 and K8.
//  * The step math (stages, error, controller, dense output, the backward
//    of a step) and both variants of the field are cde_dopri.cuh's, shared
//    with K2.  ps_variant picks one from the shapes: specialised H 8, C 3,
//    W <= 391; generic otherwise inside the JAX kernel's caps.
//
// Layouts (float32, lane minor; B = lanes):
//   ct (n, 3, C, B) or (n, 1, C, B) as in fused_dopri.cu; z0t (H, B);
//   w1t (W, H), b1 (W), w2t (C*H, W), b2 (C*H); ctl (4, B) the carried rows
//   t, step proposal, attempted steps so far, poisoned; ts_rows (n_out, B);
//   tend (B); zout_in (n_out, H, B).
//   Forward out: zout (n_out, H, B), zfin (H, B), ctlout (4, B), nacc (B),
//   natt (B), zst (cap, H, B), tst (cap, B), dtst (cap, B), cnt (B) int32.
// Backward: gzout (n_out, H, B), gzfin (H, B) -> dct (ct's shape), dz0
//   (H, B), dzout_in (n_out, H, B) and per-block partials dw1p (blocks, W, H),
//   db1p (blocks, W), dw2p (blocks, W, C*H), db2p (blocks, C*H).

#include "cde_dopri.cuh"

namespace {

struct PsCommon {
  Table tab;
  FieldArgs f;
  Dense d;
  float* scratch;  // the generic field's vectors
  int n_out;
};

struct PsFwdArgs {
  PsCommon c;
  const float *z0t, *ctl, *ts_rows, *tend, *zout_in;
  float *zout, *zfin, *ctlout, *nacc, *natt, *zst, *tst, *dtst;
  int* cnt;
  int cap;
  float t_chunk_end, rtol, atol, budget, safety, ifactor, dfactor;
};

struct PsBwdArgs {
  PsCommon c;
  const float *zst, *tst, *dtst, *ts_rows, *gzout, *gzfin;
  const int* cnt;
  float *dct, *dz0, *dzout_in;
  Partials p;
};

template <class F>
__global__ void __launch_bounds__(LANES) ps_fwd_kernel(PsFwdArgs a) {
  extern __shared__ float smem[];
  const PsCommon& c = a.c;
  const F field = make_field<F>(smem, c.scratch, c.f, false, Partials{});
  __syncthreads();
  const size_t lane = (size_t)blockIdx.x * LANES + threadIdx.x;
  if (lane >= (size_t)c.tab.B) return;  // the forward has no block-wide step
  const Vecs v = field.vecs(lane, false);
  const int H = c.f.H;
  const size_t B = c.tab.B;

  for (int h = 0; h < H; ++h) {
    v.at(Z, h) = a.z0t[h * B + lane];
    for (int k = 0; k < c.n_out; ++k) {
      const size_t at = ((size_t)k * H + h) * B + lane;
      a.zout[at] = a.zout_in[at];
    }
  }
  float t = a.ctl[lane], dt = a.ctl[B + lane], att = a.ctl[2 * B + lane];
  const bool poisoned = a.ctl[3 * B + lane] > 0.5f;
  const float t_in = t;
  const float t1 = fminf(a.tend[lane], a.t_chunk_end);
  float dx[F::MC];
  int j;
  float fr;
  control_at(c.tab, lane, true, t, dx, j, fr);
  field.eval(v, Z, K0, dx);
  int it = 0, acc = 0;
  while (it < a.cap && t < t1 && att < a.budget && !poisoned) {
    const float dtm = fmaxf(dt, 1e-14f);
    const float dc = fminf(dtm, fmaxf(t1 - t, 0.f));
    attempt_stages(field, v, c.tab, lane, true, t, dc);
    const float ratio = sqrtf(step_error(v, dc, a.rtol, a.atol) / (float)H);
    const bool accept = ratio <= 1.f;
    const float dt_new = next_step(ratio, dc, dtm, accept, a.safety, a.ifactor, a.dfactor);
    if (accept) {
      a.tst[(size_t)acc * B + lane] = t;
      a.dtst[(size_t)acc * B + lane] = dc;
      for (int h = 0; h < H; ++h) a.zst[((size_t)acc * H + h) * B + lane] = v.at(Z, h);
      for (int k = 0; k < c.n_out; ++k) {
        const float tk = a.ts_rows[(size_t)k * B + lane];
        if (!(tk > t && tk <= t + dc)) continue;
        const float theta = theta_of(tk, t, dc);
        float cA, cB, cC;
        dense_coeffs(c.d.minv, theta, cA, cB, cC);
        for (int h = 0; h < H; ++h)
          a.zout[((size_t)k * H + h) * B + lane] = dense_value(v, c.d, h, dc, theta, cA, cB, cC);
      }
      for (int h = 0; h < H; ++h) {
        v.at(Z, h) = v.at(Y, h);
        v.at(K0, h) = v.at(K0 + 6, h);
      }
      t = t + dc;
      ++acc;
    }
    dt = dt_new;
    att += 1.f;
    ++it;
  }
  // Loud exhaustion per lane: short of its target, or poisoned before.
  const bool bad = t < t1 || poisoned;
  a.ctlout[lane] = t;
  a.ctlout[B + lane] = dt;
  a.ctlout[2 * B + lane] = att;
  a.ctlout[3 * B + lane] = bad ? 1.f : 0.f;
  a.nacc[lane] = (float)acc;
  a.natt[lane] = att;
  a.cnt[lane] = acc;
  for (int h = 0; h < H; ++h) a.zfin[h * B + lane] = bad ? NAN : v.at(Z, h);
  if (bad)
    for (int k = 0; k < c.n_out; ++k)
      if (a.ts_rows[(size_t)k * B + lane] > t_in)
        for (int h = 0; h < H; ++h) a.zout[((size_t)k * H + h) * B + lane] = NAN;
}

template <class F>
__global__ void __launch_bounds__(LANES) ps_bwd_kernel(PsBwdArgs a) {
  extern __shared__ float smem[];
  const PsCommon& c = a.c;
  const F field = make_field<F>(smem, c.scratch, c.f, true, a.p);
  __syncthreads();
  const size_t lane = (size_t)blockIdx.x * LANES + threadIdx.x;
  const bool live = lane < (size_t)c.tab.B;
  const Vecs v = field.vecs(lane, false);
  const int H = c.f.H;
  const size_t B = c.tab.B;
  const int cnt = live ? a.cnt[lane] : 0;
  int steps = cnt;  // the block's (one warp's) longest mesh
  for (int off = LANES / 2; off > 0; off >>= 1)
    steps = max(steps, __shfl_xor_sync(0xffffffffu, steps, off));

  for (int h = 0; h < H; ++h) v.at(LAM, h) = live ? a.gzfin[h * B + lane] : 0.f;
  uint64_t emitted = 0;
  for (int i = 0; i < steps; ++i) {
    const bool act = i < cnt;
    const int s = cnt - 1 - i;
    const float t = act ? a.tst[(size_t)s * B + lane] : 0.f;
    const float dt = act ? a.dtst[(size_t)s * B + lane] : 0.f;
    for (int h = 0; h < H; ++h)
      v.at(YS, h) = act ? a.zst[((size_t)s * H + h) * B + lane] : 0.f;
    recompute_stages(field, v, c.tab, lane, live, t, dt);
    start_step_cotangents(v);
    for (int k = 0; act && k < c.n_out; ++k) {
      const float tk = a.ts_rows[(size_t)k * B + lane];
      if (!(tk > t && tk <= t + dt)) continue;
      emitted |= uint64_t(1) << k;
      add_row_cotangent(v, c.d, theta_of(tk, t, dt), dt, a.gzout + (size_t)k * H * B + lane, B,
                        live);
    }
    step_backward(field, v, c.tab, c.d, lane, live, act, t, dt, a.dct);
  }
  if (live) {
    for (int h = 0; h < H; ++h) a.dz0[h * B + lane] = v.at(LAM, h);
    // The rows this chunk did not emit pass their cotangent to the rows it
    // was given.
    for (int k = 0; k < c.n_out; ++k)
      for (int h = 0; h < H; ++h) {
        const size_t at = ((size_t)k * H + h) * B + lane;
        a.dzout_in[at] = ((emitted >> k) & 1) ? 0.f : a.gzout[at];
      }
  }
  field.finish(a.p);
}

template <class F>
int launch_fwd(const PsFwdArgs& a, size_t smem, cudaStream_t stream) {
  auto kernel = ps_fwd_kernel<F>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks_of(a.c.tab.B), LANES, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class F>
int launch_bwd(const PsBwdArgs& a, size_t smem, cudaStream_t stream) {
  auto kernel = ps_bwd_kernel<F>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks_of(a.c.tab.B), LANES, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int make_ps_common(PsCommon& c, const float* ct, const float* w1t, const float* b1,
                   const float* w2t, const float* b2, float* scratch, int B, int n, int H,
                   int C, int W, int n_out, const float* dense, float t0g, float w,
                   int linear, int lead, int variant) {
  const int rc = make_table(c.tab, c.f, c.d, ct, w1t, b1, w2t, b2, B, n, H, C, W, n_out, dense,
                            t0g, w, linear, lead, variant);
  if (rc) return rc;
  c.scratch = scratch;
  c.n_out = n_out;
  return 0;
}

}  // namespace

extern "C" {

const char* ps_error_string(int code) {
  if (code == BAD_ARGUMENT) return "invalid argument";
  if (code == BAD_VARIANT) return "no such kernel variant for these shapes";
  return cudaGetErrorString((cudaError_t)code);
}

// The variant that runs these shapes: 0 specialised, 1 generic.
int ps_variant(int H, int C, int W) {
  return specialised_fits(H, C, W) ? SPECIALISED : GENERIC;
}

// Blocks of a launch over B lanes: the leading size of the weight partials.
int ps_blocks(int B) { return blocks_of(B); }

// Floats of the zeroed scratch a launch needs.
long ps_scratch_floats(int B, int H, int C, int W, int variant, int bwd) {
  if (variant != GENERIC) return 1;
  return (long)(GenField::rows(H, C, W, bwd != 0) * (size_t)blocks_of(B) * LANES);
}

// dense: the 7 midpoint weights, then the 3x3 quartic inverse row-major.
// budget: the global cap on a lane's attempted steps; cap: this chunk's.
int ps_forward(const float* ct, const float* z0t, const float* w1t, const float* b1,
               const float* w2t, const float* b2, const float* ctl, const float* ts_rows,
               const float* tend, const float* zout_in, float* zout, float* zfin,
               float* ctlout, float* nacc, float* natt, float* zst, float* tst, float* dtst,
               int* cnt, float* scratch, int B, int n, int H, int C, int W, int cap, int n_out,
               const float* dense, float t_chunk_end, float t0g, float w, float rtol,
               float atol, float budget, float safety, float ifactor, float dfactor,
               int linear, int lead, int variant, void* stream) {
  PsFwdArgs a;
  int rc = make_ps_common(a.c, ct, w1t, b1, w2t, b2, scratch, B, n, H, C, W, n_out, dense, t0g,
                          w, linear, lead, variant);
  if (rc) return rc;
  if (cap < 1) return BAD_ARGUMENT;
  a.z0t = z0t;
  a.ctl = ctl;
  a.ts_rows = ts_rows;
  a.tend = tend;
  a.zout_in = zout_in;
  a.zout = zout;
  a.zfin = zfin;
  a.ctlout = ctlout;
  a.nacc = nacc;
  a.natt = natt;
  a.zst = zst;
  a.tst = tst;
  a.dtst = dtst;
  a.cnt = cnt;
  a.cap = cap;
  a.t_chunk_end = t_chunk_end;
  a.rtol = rtol;
  a.atol = atol;
  a.budget = budget;
  a.safety = safety;
  a.ifactor = ifactor;
  a.dfactor = dfactor;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == SPECIALISED)
    return launch_fwd<SpecField>(a, sizeof(float) * SpecField::smem_floats(W, false), st);
  return launch_fwd<GenField>(a, 0, st);
}

int ps_backward(const float* ct, const float* zst, const float* tst, const float* dtst,
                const float* ts_rows, const float* gzout, const float* gzfin, const float* w1t,
                const float* b1, const float* w2t, const float* b2, const int* cnt, float* dct,
                float* dz0, float* dzout_in, float* dw1p, float* db1p, float* dw2p,
                float* db2p, float* scratch, int B, int n, int H, int C, int W, int n_out,
                const float* dense, float t0g, float w, int linear, int lead, int variant,
                void* stream) {
  PsBwdArgs a;
  int rc = make_ps_common(a.c, ct, w1t, b1, w2t, b2, scratch, B, n, H, C, W, n_out, dense, t0g,
                          w, linear, lead, variant);
  if (rc) return rc;
  a.zst = zst;
  a.tst = tst;
  a.dtst = dtst;
  a.ts_rows = ts_rows;
  a.gzout = gzout;
  a.gzfin = gzfin;
  a.cnt = cnt;
  a.dct = dct;
  a.dz0 = dz0;
  a.dzout_in = dzout_in;
  a.p = Partials{dw1p, db1p, dw2p, db2p};
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == SPECIALISED)
    return launch_bwd<SpecField>(a, sizeof(float) * SpecField::smem_floats(W, true), st);
  return launch_bwd<GenField>(a, 0, st);
}

}  // extern "C"
