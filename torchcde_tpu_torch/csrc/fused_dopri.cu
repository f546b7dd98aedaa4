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
// What bounds it.  A serial chain of small matrix-vector products per lane
// (2 W H (1 + C) FLOP per stage; 6 stages per attempted step), latency-bound
// on the CUDA cores.  The forward also needs the error norm of the whole
// group at every attempted step: a reduction across every block, after
// which every block must take the same accept / step-size decision bit for
// bit.  The backward needs no norm; with one thread per lane it would leave
// most of the card idle (8 one-warp blocks at B 256), each thread carrying
// its lane's whole field.
//
// Design.
//  * The forward, at every shape and in either mode: a team of 32 threads
//    (a warp) per lane, on the team backward's stage evaluation
//    (cde_dopri.cuh, "The forward in teams"), the padded weights in shared
//    memory once per block where they fit.  Where the group's teams cannot
//    all be resident, each team walks several lanes per attempt
//    (fd_forward_plan: the least number that fits, by the runtime's
//    occupancy of the kernel), two at once (team_eval_pair: each weight
//    read serves both; at the default B 4096, 2 lanes a team); a shape that
//    no plan fits is refused.
//  * The forward is one cooperative launch per group of up to 4096 lanes,
//    every block resident at once (cudaLaunchCooperativeKernel refuses a
//    grid that could not be), so they can wait for each other.
//  * The norm: each block sums its lanes' squares in one fixed order (each
//    lane over its channels by a butterfly, each team over its lanes in
//    order, then one thread over the block's teams in order) and writes one
//    partial; a barrier on a global counter; then each block's first warp
//    sums the partials (lane i over blocks i, i + 32, ..., then a butterfly
//    across the lanes) and shares the total.  The same float operations in
//    the same order give the same value everywhere, so every block takes
//    the same decision: no float atomics in the norm.  The partials are
//    double-buffered by step parity (a block can run at most one step
//    ahead) and read past L1 (__ldcg).
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
//  * The backward is an ordinary launch over the fixed mesh, every lane
//    walking the group's accepted steps in reverse, one kernel for every
//    shape: a team of 32 threads (a warp) per lane, 256 warps at B 256 and
//    4096 at the default B 4096, with the weights in shared memory once per
//    block, each thread's rows of the hidden layer, the lane's vectors and
//    each stage's activations in the team's slice, and weight gradients the
//    team keeps privately and writes once to its slot of the partials
//    (cde_dopri.cuh, "The backward in teams").  Each lane owns its dct
//    column (no atomics).
//
// Layouts (float32, lane minor; B = lanes of the group):
//   ct (n, 3, C, B) rows b, 2c, 3d of the chunk's intervals, or (n, 1, C, B)
//   the slopes in linear mode; z0t (H, B);
//   the weights padded as the team kernels read them (cde_dopri.cuh,
//   team_weight_floats), rows q = i*H + h of the second layer;
//   zout (n_out, H, B), zfin (H, B), dtfin (1), zst (cap, H, B), tst (cap),
//   dtst (cap), stats (2) int32: accepted and attempted steps.
// Backward: gzout (n_out, H, B), gzfin (H, B) -> dct (ct's shape), dz0 (H, B)
//   and, over the padded weights, weight partials dw1p (slots, H, S), db1p
//   (slots, S), dw2p (slots, C*H, S), db2p (slots, round4(C*H)), one per
//   team (fd_team_plan).

#include "cde_dopri.cuh"

namespace {

struct Common {
  Table tab;
  FieldArgs f;
  Dense d;
  float* scratch;  // [2][blocks] norm partials, a barrier counter
  int n_out;
  float out_ts[MAX_OUT];
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

// The sum of every team's `part` over the launch, the same bits in every
// thread: the block's teams in team order (in smem[0 .. L - 1], by one
// thread), then, after the barrier, the blocks' partials by the first warp,
// lane i over blocks i, i + 32, ... in order and the lanes by a butterfly
// of shuffles (so every block forms the same sum, with the same bits, and
// reads the partials 32 at a time), shared through smem[L].
__device__ float team_group_sum(float part, const Team& tm, const TeamPlan& p, float* smem,
                                float* partials, unsigned* counter, unsigned& generation) {
  const unsigned nb = gridDim.x;
  float* slot = partials + (generation & 1u) * nb;
  if (tm.r == 0) smem[threadIdx.x / TEAM] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int i = 0; i < p.L; ++i) total += smem[i];
    slot[blockIdx.x] = total;
  }
  ++generation;
  grid_barrier(counter, generation * nb);
  if (threadIdx.x < 32) {
    float total = 0.f;
    for (unsigned b = threadIdx.x; b < nb; b += 32) total += __ldcg(slot + b);
    for (int m = 16; m > 0; m >>= 1) total += __shfl_xor_sync(0xffffffffu, total, m);
    if (threadIdx.x == 0) smem[p.L] = total;
  }
  __syncthreads();
  return smem[p.L];
}

// The forward, for every shape: a team of threads per lane (cde_dopri.cuh,
// "The forward in teams"), each team walking lanes slot + l * slots,
// l < p.lanes, at every attempt, two at once where it has two.
template <bool SMEM, int RB, bool NARROW>
__global__ void __launch_bounds__(MAX_TEAM_BLOCK) dopri_fwd_team_kernel(FwdArgs a, TeamPlan p) {
  extern __shared__ float smem[];
  const Common& c = a.c;
  TeamWeights wt;
  TeamShape s;
  const Team tm = team_fwd_setup<SMEM>(smem, c.f, p, wt, s);
  const int H = s.H;
  const size_t B = c.tab.B;
  float* partials = c.scratch;
  unsigned* counter = reinterpret_cast<unsigned*>(c.scratch + 2 * gridDim.x);
  int live = 0;  // the team's lanes inside the group
  while (live < p.lanes && tm.slot + (size_t)live * p.slots < B) ++live;

  float t = a.t_start;
  const float t1 = a.t_end;
  float dt = *a.dt0;
  for (int l = 0; l < live; ++l) {
    const Team tl = team_lane(tm, s, l);
    const size_t lane = tm.slot + (size_t)l * p.slots;
    for (int h = tl.r; h < H; h += tl.T) {
      const float z = a.z0t[h * B + lane];
      tl.at(s, YS, h) = z;
      for (int k = 0; k < c.n_out; ++k) a.zout[((size_t)k * H + h) * B + lane] = z;
    }
    tl.sync();
    team_load_dx(c.tab, tl, lane, t, dt);
    team_eval<RB, true, NARROW>(wt, s, tl, 0);
  }
  int attempted = 0, cnt = 0;
  unsigned generation = 0;

  while (t < t1 && attempted < a.cap && cnt < a.cap) {
    dt = fmaxf(dt, 1e-14f);
    const float dc = fminf(dt, t1 - t);
    float part = 0.f;
    for (int l = 0; l < live; ++l) {
      const Team tl = team_lane(tm, s, l);
      // The previous evaluation's reads of dX/dt, h1 and g are done.
      tl.sync();
      team_load_dx(c.tab, tl, tm.slot + (size_t)l * p.slots, t, dc);
      if (!NARROW && l + 1 < live) {  // lanes l and l + 1 at once
        const Team tb = team_pair_view(team_lane(tm, s, l + 1), s);
        team_load_dx(c.tab, tb, tm.slot + (size_t)(l + 1) * p.slots, t, dc);
        team_stages_pair<RB>(wt, s, tl, tb, dc);
        part += team_error(s, tl, dc, a.rtol, a.atol);
        part += team_error(s, tb, dc, a.rtol, a.atol);
        ++l;
        continue;
      }
      team_stages<RB, true, NARROW>(wt, s, tl, dc, 1);
      part += team_error(s, tl, dc, a.rtol, a.atol);
    }
    const float ratio = sqrtf(
        team_group_sum(part, tm, p, smem, partials, counter, generation) / (float)(B * H));
    const bool accept = ratio <= 1.f;
    const float dt_new = next_step(ratio, dc, dt, accept, a.safety, a.ifactor, a.dfactor);
    if (accept) {
      if (blockIdx.x == 0 && threadIdx.x == 0) {
        a.tst[cnt] = t;
        a.dtst[cnt] = dc;
      }
      for (int l = 0; l < live; ++l) {
        const Team tl = team_lane(tm, s, l);
        const size_t lane = tm.slot + (size_t)l * p.slots;
        for (int h = tl.r; h < H; h += tl.T)
          a.zst[((size_t)cnt * H + h) * B + lane] = tl.at(s, YS, h);
        for (int k = 0; k < c.n_out; ++k) {
          const float tk = c.out_ts[k];
          if (!(tk > t && tk <= t + dc)) continue;
          team_dense(s, tl, c.d, dc, theta_of(tk, t, dc), a.zout + (size_t)k * H * B + lane, B);
        }
        team_advance(s, tl);
      }
      t = t + dc;
      ++cnt;
    }
    dt = dt_new;
    ++attempted;
  }
  // Loud exhaustion, as the JAX kernel: t < t1 means the budget ran out.
  for (int l = 0; l < live; ++l) {
    const Team tl = team_lane(tm, s, l);
    const size_t lane = tm.slot + (size_t)l * p.slots;
    for (int h = tl.r; h < H; h += tl.T) {
      a.zfin[h * B + lane] = t < t1 ? NAN : tl.at(s, YS, h);
      if (t < t1)
        for (int k = 0; k < c.n_out; ++k) a.zout[((size_t)k * H + h) * B + lane] = NAN;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.dtfin = dt;
    a.stats[0] = cnt;
    a.stats[1] = attempted;
  }
}

// The backward, for every shape: a team of threads per lane (cde_dopri.cuh),
// every lane walking the group's accepted steps; teams stride over the lanes.
template <bool SMEM, int RB>
__global__ void __launch_bounds__(MAX_TEAM_BLOCK) dopri_bwd_team_kernel(BwdArgs a, TeamPlan p) {
  extern __shared__ float smem[];
  const Common& c = a.c;
  TeamWeights wt;
  TeamShape s;
  const Team tm = team_setup<SMEM>(smem, c.f, p, a.p, wt, s);
  const int H = s.H;
  const size_t B = c.tab.B;
  const int cnt = a.stats[0];
  for (size_t lane = tm.slot; lane < B; lane += p.slots) {
    for (int h = tm.r; h < H; h += tm.T) tm.at(s, LAM, h) = a.gzfin[h * B + lane];
    uint64_t emitted = 0;
    // Each step's t and dt are read during the step before.
    float t_next = cnt > 0 ? a.tst[cnt - 1] : 0.f, dt_next = cnt > 0 ? a.dtst[cnt - 1] : 0.f;
    for (int i = 0; i < cnt; ++i) {
      const int st = cnt - 1 - i;
      const float t = t_next, dt = dt_next;
      if (st > 0) {
        t_next = a.tst[st - 1];
        dt_next = a.dtst[st - 1];
      }
      team_load_step(s, tm, c.tab, lane, t, dt, a.zst + (size_t)st * H * B + lane, B);
      team_stages<RB, false>(wt, s, tm, dt, 0);
      team_start_cotangents(s, tm);
      for (int k = 0; k < c.n_out; ++k) {
        const float tk = c.out_ts[k];
        if (!(tk > t && tk <= t + dt)) continue;
        emitted |= uint64_t(1) << k;
        team_add_row(s, tm, c.d, theta_of(tk, t, dt), dt, a.gzout + (size_t)k * H * B + lane, B);
      }
      team_step_backward<RB>(wt, s, tm, c.tab, c.d, lane, t, dt, a.dct);
    }
    for (int h = tm.r; h < H; h += tm.T) {
      float d = tm.at(s, LAM, h);
      for (int k = 0; k < c.n_out; ++k)
        if (!((emitted >> k) & 1)) d = d + a.gzout[((size_t)k * H + h) * B + lane];
      a.dz0[h * B + lane] = d;
    }
  }
  team_finish<SMEM>(tm, s, a.p);
}

using TeamFwdKernel = void (*)(FwdArgs, TeamPlan);

template <bool SMEM, int RB>
TeamFwdKernel team_fwd_kernel(bool narrow) {
  return narrow ? dopri_fwd_team_kernel<SMEM, RB, true> : dopri_fwd_team_kernel<SMEM, RB, false>;
}

TeamFwdKernel team_fwd_kernel(const TeamPlan& p) {
  if (p.smem) return p.rows == 4 ? team_fwd_kernel<true, 4>(p.narrow) : team_fwd_kernel<true, 1>(p.narrow);
  return p.rows == 4 ? team_fwd_kernel<false, 4>(p.narrow) : team_fwd_kernel<false, 1>(p.narrow);
}

// Blocks of the plan's team forward kernel an SM holds at once (0 where
// the runtime cannot tell).
int team_fwd_resident(const TeamPlan& p, int threads, size_t bytes) {
  const TeamFwdKernel kernel = team_fwd_kernel(p);
  int n = 0;
  if (set_smem(kernel, bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, bytes) != cudaSuccess)
    return 0;
  return n;
}

int fwd_team_plan(TeamPlan& p, int B, int H, int C, int W) {
  return team_fwd_plan(p, B, H, C, W, true, team_fwd_resident);
}

int launch_fwd_team(FwdArgs a, TeamPlan p, cudaStream_t stream) {
  const TeamFwdKernel kernel = team_fwd_kernel(p);
  cudaError_t err = set_smem(kernel, p.bytes);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a, &p};
  // Cooperative: every block of the group resident at once, or a refusal.
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(p.blocks), dim3(p.L * TEAM), args,
                                    p.bytes, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool SMEM, int RB>
int launch_bwd_team(const BwdArgs& a, const TeamPlan& p, cudaStream_t stream) {
  auto kernel = dopri_bwd_team_kernel<SMEM, RB>;
  cudaError_t err = set_smem(kernel, p.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.blocks, p.L * TEAM, p.bytes, stream>>>(a, p);
  return (int)cudaGetLastError();
}

int make_common(Common& c, const float* ct, const float* w1t, const float* b1,
                const float* w2t, const float* b2, float* scratch, int B, int n, int H,
                int C, int W, int n_out, const float* out_ts, const float* dense,
                float t0g, float w, int linear, int lead) {
  const int rc = make_table(c.tab, c.f, c.d, ct, w1t, b1, w2t, b2, B, n, H, C, W, n_out, dense,
                            t0g, w, linear, lead);
  if (rc) return rc;
  c.scratch = scratch;
  c.n_out = n_out;
  for (int k = 0; k < MAX_OUT; ++k) c.out_ts[k] = k < n_out ? out_ts[k] : 0.f;
  return 0;
}

}  // namespace

extern "C" {

const char* fd_error_string(int code) {
  if (code == BAD_ARGUMENT) return "invalid argument";
  if (code == BAD_VARIANT) return "no launch fits these shapes";
  return cudaGetErrorString((cudaError_t)code);
}

// The forward's launch for these shapes: teams per
// block, blocks, lanes each team walks, outputs a thread carries at once,
// weights in shared memory (1) or not (0), the bytes of shared memory a
// block takes, S (the padded row length of the weights), the floats of the
// zeroed scratch (the norm's partials and counter) and one first-layer row
// per thread (1) or quads (0) into out[0..8]; returns 0 or an error code.  fd_forward checks the blocks and S it is
// given against its own plan.
int fd_forward_plan(int B, int H, int C, int W, long* out) {
  TeamPlan p;
  const int rc = fwd_team_plan(p, B, H, C, W);
  if (rc) return rc;
  const long v[9] = {p.L, p.blocks, p.lanes, p.rows, p.smem, (long)p.bytes, team_row(W),
                     (long)head_floats(p.blocks), p.narrow};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// The team backward's launch for these shapes (K2 and K9): teams per block, blocks, slots of the partials, outputs a thread
// carries at once, weights and accumulators in shared memory (1) or not
// (0), the bytes of shared memory a block takes, and S, the padded row
// length of the weights and partials, into out[0..6]; returns 0 or an error
// code.  The wrappers size the padded weights and the partials from it;
// fd_backward and ps_backward check that they did.
int fd_team_plan(int B, int H, int C, int W, long* out) {
  TeamPlan p;
  const int rc = team_plan(p, B, H, C, W);
  if (rc) return rc;
  const long v[7] = {p.L, p.blocks, p.slots, p.rows, p.smem, (long)p.bytes, team_row(W)};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// dense: the 7 midpoint weights, then the 3x3 quartic inverse row-major.
// linear: ct holds a linear control's slopes; lead: its row 0 is the
// interval left of t0g.  The forward takes the padded weights and the blocks
// and row length of fd_forward_plan.
int fd_forward(const float* ct, const float* z0t, const float* w1t, const float* b1,
               const float* w2t, const float* b2, const float* dt0, float* zout,
               float* zfin, float* dtfin, float* zst, float* tst, float* dtst,
               int* stats, float* scratch, int B, int n, int H, int C, int W, int cap,
               int n_out, const float* out_ts, const float* dense, float t_start,
               float t_end, float t0g, float w, float rtol, float atol, float safety,
               float ifactor, float dfactor, int linear, int lead, int blocks, int row,
               void* stream) {
  FwdArgs a;
  int rc = make_common(a.c, ct, w1t, b1, w2t, b2, scratch, B, n, H, C, W, n_out,
                       out_ts, dense, t0g, w, linear, lead);
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
  TeamPlan p;
  rc = fwd_team_plan(p, B, H, C, W);
  if (rc) return rc;
  if (p.blocks != blocks || team_row(W) != row) return BAD_ARGUMENT;
  return launch_fwd_team(a, p, (cudaStream_t)stream);
}

// The weights padded (cde_dopri.cuh, team_weight_floats) and zeroed
// partials (slots, H, S), (slots, S), (slots, C*H, S), (slots, CH4), with
// the slots and S of fd_team_plan.
int fd_backward(const float* ct, const float* zst, const float* tst, const float* dtst,
                const float* gzout, const float* gzfin, const float* w1t, const float* b1,
                const float* w2t, const float* b2, const int* stats, float* dct,
                float* dz0, float* dw1p, float* db1p, float* dw2p, float* db2p,
                int B, int n, int H, int C, int W, int n_out,
                const float* out_ts, const float* dense, float t0g, float w,
                int linear, int lead, int slots, int row, void* stream) {
  BwdArgs a;
  int rc = make_common(a.c, ct, w1t, b1, w2t, b2, nullptr, B, n, H, C, W, n_out,
                       out_ts, dense, t0g, w, linear, lead);
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
  TeamPlan p;
  rc = team_plan(p, B, H, C, W);
  if (rc) return rc;
  if (p.slots != slots || team_row(W) != row) return BAD_ARGUMENT;
  if (p.smem) return p.rows == 4 ? launch_bwd_team<true, 4>(a, p, st) : launch_bwd_team<true, 1>(a, p, st);
  return p.rows == 4 ? launch_bwd_team<false, 4>(a, p, st) : launch_bwd_team<false, 1>(a, p, st);
}

}  // extern "C"
