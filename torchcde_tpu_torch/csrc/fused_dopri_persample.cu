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
// latency-bound on the CUDA cores; here each lane's step count is its own,
// so a launch lasts as long as its hardest lane's chain.
//
// Design.
//  * Lanes are independent: no norm to share, so no cooperative launch and
//    no cross-block reduction.  The forward and the backward each run a team
//    of 32 threads (a warp) per lane, 256 warps at B 256, each team walking
//    its own lane with no lockstep and no barrier across lanes: a warp ends
//    when its own lane ends.  The forward is the JAX kernel's lockstep loop
//    seen from one lane: there a lane is active from the first iteration
//    until it finishes and idle after, so its attempts in a chunk are
//    min(need, cap) either way.  Both run on one stage evaluation
//    (cde_dopri.cuh, "The forward in teams" and "The backward in teams"),
//    so the backward's recompute rounds as the forward's stages did: the
//    padded weights in shared memory once per block, each thread's rows of
//    the hidden layer, the lane's vectors and the activations in the team's
//    slice; the backward's weight gradients are kept privately by the team
//    and written once to its slot of the partials.  Each lane owns its dct
//    column (no atomics).
//  * Each lane reads its own interval of the table (CUDA can gather; the TPU
//    kernel evaluates every resident interval and reduces one-hot).
//  * The store keeps each lane's accepted steps only (t, dt and the entry
//    state): a rejected or idle iteration of the TPU kernel's store has
//    accept 0 and contributes nothing to any gradient.
//
// Layouts (float32, lane minor; B = lanes):
//   ct (n, 3, C, B) or (n, 1, C, B) as in fused_dopri.cu; z0t (H, B);
//   the weights padded as the team kernels read them (cde_dopri.cuh,
//   team_weight_floats; from w1t (W, H), b1 (W), w2t (C*H, W), b2 (C*H));
//   ctl (4, B) the carried rows
//   t, step proposal, attempted steps so far, poisoned; ts_rows (n_out, B);
//   tend (B); zout_in (n_out, H, B).
//   Forward out: zout (n_out, H, B), zfin (H, B), ctlout (4, B), nacc (B),
//   natt (B), zst (cap, H, B), tst (cap, B), dtst (cap, B), cnt (B) int32.
// Backward: gzout (n_out, H, B), gzfin (H, B) -> dct (ct's shape), dz0
//   (H, B), dzout_in (n_out, H, B) and, over the padded weights, weight
//   partials dw1p (slots, H, S), db1p (slots, S), dw2p (slots, C*H, S),
//   db2p (slots, round4(C*H)), one per team (fd_team_plan in fused_dopri.cu).

#include "cde_dopri.cuh"

namespace {

struct PsCommon {
  Table tab;
  FieldArgs f;
  Dense d;
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

// The forward: a team of threads per lane (cde_dopri.cuh, "The forward in
// teams"), each team walking its own lane until it ends.
template <bool SMEM, int RB, bool NARROW>
__global__ void __launch_bounds__(MAX_TEAM_BLOCK) ps_fwd_kernel(PsFwdArgs a, TeamPlan p) {
  extern __shared__ float smem[];
  const PsCommon& c = a.c;
  TeamWeights wt;
  TeamShape s;
  const Team tm = team_fwd_setup<SMEM>(smem, c.f, p, wt, s);
  const size_t lane = tm.slot, B = c.tab.B;
  if (lane >= B) return;  // the forward has no block-wide step after the setup
  const int H = s.H;

  for (int h = tm.r; h < H; h += tm.T) {
    tm.at(s, YS, h) = a.z0t[h * B + lane];
    for (int k = 0; k < c.n_out; ++k) {
      const size_t at = ((size_t)k * H + h) * B + lane;
      a.zout[at] = a.zout_in[at];
    }
  }
  float t = a.ctl[lane], dt = a.ctl[B + lane], att = a.ctl[2 * B + lane];
  const bool poisoned = a.ctl[3 * B + lane] > 0.5f;
  const float t_in = t;
  const float t1 = fminf(a.tend[lane], a.t_chunk_end);
  tm.sync();
  team_load_dx(c.tab, tm, lane, t, dt);
  team_eval<RB, true, NARROW>(wt, s, tm, 0);
  int it = 0, acc = 0;
  while (it < a.cap && t < t1 && att < a.budget && !poisoned) {
    const float dtm = fmaxf(dt, 1e-14f);
    const float dc = fminf(dtm, fmaxf(t1 - t, 0.f));
    // The previous evaluation's reads of dX/dt, h1 and g are done.
    tm.sync();
    team_load_dx(c.tab, tm, lane, t, dc);
    team_stages<RB, true, NARROW>(wt, s, tm, dc, 1);
    const float ratio = sqrtf(team_error(s, tm, dc, a.rtol, a.atol) / (float)H);
    const bool accept = ratio <= 1.f;
    const float dt_new = next_step(ratio, dc, dtm, accept, a.safety, a.ifactor, a.dfactor);
    if (accept) {
      if (tm.r == 0) {
        a.tst[(size_t)acc * B + lane] = t;
        a.dtst[(size_t)acc * B + lane] = dc;
      }
      for (int h = tm.r; h < H; h += tm.T)
        a.zst[((size_t)acc * H + h) * B + lane] = tm.at(s, YS, h);
      for (int k = 0; k < c.n_out; ++k) {
        const float tk = a.ts_rows[(size_t)k * B + lane];
        if (!(tk > t && tk <= t + dc)) continue;
        team_dense(s, tm, c.d, dc, theta_of(tk, t, dc), a.zout + (size_t)k * H * B + lane, B);
      }
      team_advance(s, tm);
      t = t + dc;
      ++acc;
    }
    dt = dt_new;
    att += 1.f;
    ++it;
  }
  // Loud exhaustion per lane: short of its target, or poisoned before.
  const bool bad = t < t1 || poisoned;
  if (tm.r == 0) {
    a.ctlout[lane] = t;
    a.ctlout[B + lane] = dt;
    a.ctlout[2 * B + lane] = att;
    a.ctlout[3 * B + lane] = bad ? 1.f : 0.f;
    a.nacc[lane] = (float)acc;
    a.natt[lane] = att;
    a.cnt[lane] = acc;
  }
  for (int h = tm.r; h < H; h += tm.T) {
    a.zfin[h * B + lane] = bad ? NAN : tm.at(s, YS, h);
    if (bad)
      for (int k = 0; k < c.n_out; ++k)
        if (a.ts_rows[(size_t)k * B + lane] > t_in) a.zout[((size_t)k * H + h) * B + lane] = NAN;
  }
}

// A team of threads per lane (cde_dopri.cuh), each walking its own lane's
// accepted steps in reverse; teams stride over the lanes.
template <bool SMEM, int RB>
__global__ void __launch_bounds__(MAX_TEAM_BLOCK) ps_bwd_kernel(PsBwdArgs a, TeamPlan p) {
  extern __shared__ float smem[];
  const PsCommon& c = a.c;
  TeamWeights wt;
  TeamShape s;
  const Team tm = team_setup<SMEM>(smem, c.f, p, a.p, wt, s);
  const int H = s.H;
  const size_t B = c.tab.B;
  for (size_t lane = tm.slot; lane < B; lane += p.slots) {
    const int cnt = a.cnt[lane];
    for (int h = tm.r; h < H; h += tm.T) tm.at(s, LAM, h) = a.gzfin[h * B + lane];
    uint64_t emitted = 0;
    // Each step's t and dt are read during the step before.
    float t_next = cnt > 0 ? a.tst[(size_t)(cnt - 1) * B + lane] : 0.f;
    float dt_next = cnt > 0 ? a.dtst[(size_t)(cnt - 1) * B + lane] : 0.f;
    for (int i = 0; i < cnt; ++i) {
      const int st = cnt - 1 - i;
      const float t = t_next, dt = dt_next;
      if (st > 0) {
        t_next = a.tst[(size_t)(st - 1) * B + lane];
        dt_next = a.dtst[(size_t)(st - 1) * B + lane];
      }
      team_load_step(s, tm, c.tab, lane, t, dt, a.zst + (size_t)st * H * B + lane, B);
      team_stages<RB, false>(wt, s, tm, dt, 0);
      team_start_cotangents(s, tm);
      for (int k = 0; k < c.n_out; ++k) {
        const float tk = a.ts_rows[(size_t)k * B + lane];
        if (!(tk > t && tk <= t + dt)) continue;
        emitted |= uint64_t(1) << k;
        team_add_row(s, tm, c.d, theta_of(tk, t, dt), dt, a.gzout + (size_t)k * H * B + lane, B);
      }
      team_step_backward<RB>(wt, s, tm, c.tab, c.d, lane, t, dt, a.dct);
    }
    for (int h = tm.r; h < H; h += tm.T) {
      a.dz0[h * B + lane] = tm.at(s, LAM, h);
      // The rows this chunk did not emit pass their cotangent to the rows it
      // was given.
      for (int k = 0; k < c.n_out; ++k) {
        const size_t at = ((size_t)k * H + h) * B + lane;
        a.dzout_in[at] = ((emitted >> k) & 1) ? 0.f : a.gzout[at];
      }
    }
  }
  team_finish<SMEM>(tm, s, a.p);
}

template <bool SMEM, int RB>
int launch_fwd(const PsFwdArgs& a, const TeamPlan& p, cudaStream_t stream) {
  auto kernel = p.narrow ? ps_fwd_kernel<SMEM, RB, true> : ps_fwd_kernel<SMEM, RB, false>;
  cudaError_t err = set_smem(kernel, p.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.blocks, p.L * TEAM, p.bytes, stream>>>(a, p);
  return (int)cudaGetLastError();
}

int fwd_team_plan(TeamPlan& p, int B, int H, int C, int W) {
  return team_fwd_plan(p, B, H, C, W, false, [](const TeamPlan&, int, size_t) { return 1; });
}

template <bool SMEM, int RB>
int launch_bwd(const PsBwdArgs& a, const TeamPlan& p, cudaStream_t stream) {
  auto kernel = ps_bwd_kernel<SMEM, RB>;
  cudaError_t err = set_smem(kernel, p.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.blocks, p.L * TEAM, p.bytes, stream>>>(a, p);
  return (int)cudaGetLastError();
}

int make_ps_common(PsCommon& c, const float* ct, const float* w1t, const float* b1,
                   const float* w2t, const float* b2, int B, int n, int H, int C, int W,
                   int n_out, const float* dense, float t0g, float w, int linear, int lead) {
  const int rc = make_table(c.tab, c.f, c.d, ct, w1t, b1, w2t, b2, B, n, H, C, W, n_out, dense,
                            t0g, w, linear, lead);
  if (rc) return rc;
  c.n_out = n_out;
  return 0;
}

}  // namespace

extern "C" {

const char* ps_error_string(int code) {
  if (code == BAD_ARGUMENT) return "invalid argument";
  if (code == BAD_VARIANT) return "no kernel variant or launch fits these shapes";
  return cudaGetErrorString((cudaError_t)code);
}

// The team forward's launch for these shapes: teams per block, blocks,
// lanes each team walks (1), outputs a thread carries at once, weights in
// shared memory (1) or not (0), the bytes of shared memory a block takes, S
// (the padded row length of the weights), the floats of a scratch (0) and
// one first-layer row per thread (1) or quads (0) into out[0..8], as
// fd_forward_plan; returns 0 or an error code.
// ps_forward checks the blocks and S it is given against its own plan.
int ps_forward_plan(int B, int H, int C, int W, long* out) {
  TeamPlan p;
  const int rc = fwd_team_plan(p, B, H, C, W);
  if (rc) return rc;
  const long v[9] = {p.L, p.blocks, p.lanes, p.rows, p.smem, (long)p.bytes, team_row(W), 0,
                     p.narrow};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// dense: the 7 midpoint weights, then the 3x3 quartic inverse row-major.
// budget: the global cap on a lane's attempted steps; cap: this chunk's.
// The weights padded, with the blocks and row length of ps_forward_plan.
int ps_forward(const float* ct, const float* z0t, const float* w1t, const float* b1,
               const float* w2t, const float* b2, const float* ctl, const float* ts_rows,
               const float* tend, const float* zout_in, float* zout, float* zfin,
               float* ctlout, float* nacc, float* natt, float* zst, float* tst, float* dtst,
               int* cnt, int B, int n, int H, int C, int W, int cap, int n_out,
               const float* dense, float t_chunk_end, float t0g, float w, float rtol,
               float atol, float budget, float safety, float ifactor, float dfactor,
               int linear, int lead, int blocks, int row, void* stream) {
  PsFwdArgs a;
  int rc = make_ps_common(a.c, ct, w1t, b1, w2t, b2, B, n, H, C, W, n_out, dense, t0g, w,
                          linear, lead);
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
  TeamPlan p;
  rc = fwd_team_plan(p, B, H, C, W);
  if (rc) return rc;
  if (p.blocks != blocks || team_row(W) != row) return BAD_ARGUMENT;
  cudaStream_t st = (cudaStream_t)stream;
  if (p.smem) return p.rows == 4 ? launch_fwd<true, 4>(a, p, st) : launch_fwd<true, 1>(a, p, st);
  return p.rows == 4 ? launch_fwd<false, 4>(a, p, st) : launch_fwd<false, 1>(a, p, st);
}

// The weights padded (cde_dopri.cuh, team_weight_floats) and zeroed
// partials (slots, H, S), (slots, S), (slots, C*H, S), (slots, CH4), with
// the slots and S of fused_dopri.cu's fd_team_plan.
int ps_backward(const float* ct, const float* zst, const float* tst, const float* dtst,
                const float* ts_rows, const float* gzout, const float* gzfin, const float* w1t,
                const float* b1, const float* w2t, const float* b2, const int* cnt, float* dct,
                float* dz0, float* dzout_in, float* dw1p, float* db1p, float* dw2p,
                float* db2p, int B, int n, int H, int C, int W, int n_out,
                const float* dense, float t0g, float w, int linear, int lead, int slots,
                int row, void* stream) {
  PsBwdArgs a;
  int rc = make_ps_common(a.c, ct, w1t, b1, w2t, b2, B, n, H, C, W, n_out, dense, t0g, w,
                          linear, lead);
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
  TeamPlan p;
  rc = team_plan(p, B, H, C, W);
  if (rc) return rc;
  if (p.slots != slots || team_row(W) != row) return BAD_ARGUMENT;
  cudaStream_t st = (cudaStream_t)stream;
  if (p.smem) return p.rows == 4 ? launch_bwd<true, 4>(a, p, st) : launch_bwd<true, 1>(a, p, st);
  return p.rows == 4 ? launch_bwd<false, 4>(a, p, st) : launch_bwd<false, 1>(a, p, st);
}

}  // extern "C"
