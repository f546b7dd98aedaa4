// The adaptive dopri5 step math shared by the two adaptive Neural CDE kernel
// pairs: the whole-group solve (fused_dopri.cu, K2) and the per-lane solve
// (fused_dopri_persample.cu, K9): the dopri5 tableau, the control's dX/dt at
// a stage time on a uniform knot grid (cubic or, left-continuous at knots,
// linear), an attempted step's stages, error and controller, the quartic
// dense output, and the backward of one accepted step.
//
// Replaces the step math of torchcde_tpu/solvers/fused_dopri_pallas.py
// (_dopri_fwd_kernel, _dopri_bwd_kernel) and of
// torchcde_tpu/solvers/fused_dopri_persample.py (_psd_fwd_kernel,
// _psd_bwd_kernel).
//
// Every forward and every backward of K2 (in both modes) and of K9 runs in
// teams: T = 32 threads, one warp, per lane, on one stage evaluation
// (team_eval), so that a forward's stages and its backward's recompute
// round alike.  What bounds them is the
// serial chain of small products of the field, W H (1 + C) multiply-adds
// per stage evaluation, and in the backward again twice as many for the
// VJP and the weight gradients; one thread per lane would leave 8 warps on
// the card at B 256 and walk each lane's whole field serially.  A team
// splits each product: thread r owns quads of hidden rows (h1, dp1, the
// ReLU mask, dh1 = W2^T dp2) and outputs q = r (mod T) of the second layer;
// the sums over the rows (g, dy) go through the team's shared slice or warp
// shuffles, each in one fixed order, and every pass reads four floats at
// once along the rows.  The lane's vectors (stage inputs, stages and
// cotangents, lambda, the dense output's terms), each stage's h1, g, dp1,
// dp2 and dX/dt live in the team's slice of shared memory; thread r owns
// channels h = r (mod T) of every vector, so the step's axpys need no
// synchronisation, and the team meets at __syncwarp between the passes of
// an evaluation.  The weights sit once per block in shared memory, rows
// padded to an odd multiple of four floats so that a quarter-warp's
// 16-byte reads of different rows fall in different banks.
//
// The forward in teams: every thread of a team carries the same t, dt and
// attempt count.  An attempt issues the dX/dt loads of its seven stage times
// at once, evaluates stages 1..6 (the first is the last of the step before),
// and sums the lane's squared scaled errors over its channels, each thread
// its own channels, then across the team by a butterfly of shuffles: one
// fixed order, the same bits in every thread, so that every thread takes the
// same accept decision and step size.  The channels' owners write the dense
// output, the store of accepted steps and the FSAL swap.  The forward keeps
// one h1 and one g, shared by the stages.  Where a team walks two or more
// lanes (K2 where its teams cannot all be resident), it evaluates two lanes'
// stages at once (team_eval_pair): each weight read from shared memory
// serves both, and each lane's sums run in team_eval's order, so it gets the
// same bits as alone; the pair takes a second dX/dt, h1 and g.
//
// The backward in teams: at the step's end each thread adds the step's
// weight gradients of its rows (dW1[w, :], db1[w], dW2[:, w]), summed over
// the seven stages, and of its outputs (db2[q]) to the team's private
// accumulators, across every step of every lane the team walks, and the
// team writes them once at the end to its slot of the partials, which the
// wrapper sums over the slots in order: no block-wide barrier inside a step
// and no float atomics.  Where the weights (and, in the backward, the
// accumulators) do not fit in shared memory (inside the JAX kernels' caps
// W <= 512, C*H <= 512) they stay in device memory, the accumulators in the
// team's own slot.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int NS = 7;            // dopri5 stages
constexpr int MAX_ROWS = 16;     // table rows per interval: 3 * C cubic, C linear
constexpr int MAX_OUT = 64;      // output times per chunk (per lane in K9)
constexpr size_t MAX_SMEM = 232448;
constexpr int BAD_ARGUMENT = -2;
constexpr int BAD_VARIANT = -3;
// Vectors of a lane in its team's slice: stage inputs (the first the state z, the last the step's
// solution z1), stages (then, in the backward, their cotangents), and in the
// backward lambda and the dense output's cotangent terms.
constexpr int YS = 0, KV = 7, NV_TEAM_FWD = 14, LAM = 14, LZ = 15, LZ1 = 16, UMID = 17,
              E0 = 18, E6 = 19, U = 20, NV_BWD = 21;

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

// The interval j and fraction fr of time tval on the chunk's uniform grid.
// Cubic: j = clamp(floor((tval - t0g) / w), 0, n - 1).  Linear: j =
// clamp(ceil((tval - t0g) / w) - (lead ? 0 : 1), 0, n - 1), the slope on
// the left of a knot; fr is unused (0).
__device__ __forceinline__ void locate(const Table& c, float tval, int& j, float& fr) {
  const float pos = (tval - c.t0g) / c.w;
  if (c.linear) {
    const float jf = ceilf(pos) - (c.lead ? 0.f : 1.f);
    j = (int)fminf(fmaxf(jf, 0.f), (float)(c.n - 1));
    fr = 0.f;
    return;
  }
  j = (int)fminf(fmaxf(floorf(pos), 0.f), (float)(c.n - 1));
  fr = tval - (c.t0g + (float)j * c.w);
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

// theta of output time tk in the step (t, dc].
__device__ __forceinline__ float theta_of(float tk, float t, float dc) {
  return fminf(fmaxf((tk - t) / fmaxf(dc, 1e-30f), 0.f), 1.f);
}

// ---------------------------------------------------------------------------
// Teams (K2, K9): T threads per lane.
//
// Layouts, padded so that every pass reads four floats at once: H4, CH4
// are H and C*H rounded up to a multiple of 4, and S, the row length of the
// weights and accumulators, is W rounded up to an odd multiple of 4 (rows of
// a quarter-warp's 16-byte reads then fall in distinct banks).  Thread r
// owns the quads of hidden rows 4p .. 4p + 3, p = r (mod T), the outputs
// q = r (mod T) of the second layer and the channels h = r (mod T).

// Threads per lane: one warp.  The team code reads it from the plan
// (TeamPlan::T, Team::T), not as this constant: compiled with the constant,
// the kernels that keep the weights in device memory stopped with an
// illegal instruction on an H100 (CUDA 12.8).
constexpr int TEAM = 32;
constexpr int MAX_TEAM_BLOCK = 256;   // threads per block
constexpr size_t MAX_PARTIALS = size_t(1) << 26;  // floats of the partials
constexpr int PS = 4;                 // partial sums a long dot product keeps apart

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int team_row(int W) {
  const int r = round4(W);
  return (r / 4) % 2 ? r : r + 4;
}

// The weights as the wrapper pads them (fd_backward, ps_backward): w1
// [H4][S] (w1[h][w] = W1[w, h]), b1 [S], w2 [CH4][S] (w2[q][w] = W2[q, w]),
// b2 [CH4], zero outside W, H and C*H.
__host__ __device__ inline size_t team_weight_floats(int H, int C, int W) {
  return ((size_t)round4(H) + 1 + round4(C * H)) * team_row(W) + round4(C * H);
}
// The forward's team slice: for each of the p.lanes lanes it walks
// [NV_TEAM_FWD][H4] vectors, then [NS][MAX_ROWS] dX/dt, [S] h1 and [CH4] g,
// which its lanes and stages share, and with two lanes or more a second
// dX/dt, h1 and g for the second lane of a pair (team_pair_view).
__host__ __device__ inline size_t team_fwd_floats(int H, int C, int W, int lanes) {
  const size_t shared = (size_t)NS * MAX_ROWS + team_row(W) + round4(C * H);
  return (size_t)lanes * NV_TEAM_FWD * round4(H) + (lanes > 1 ? 2 : 1) * shared;
}
// Floats before the forward's weights and slices: a block's team sums of
// the group norm (K2).
constexpr int FWD_HEAD = 16;
// One backward team's vectors: [NV_BWD][H4] the lane's vectors, and for each stage
// of the step [NS][MAX_ROWS] its dX/dt, [NS][S] h1, [NS][CH4] g (then u g),
// [NS][S] dp1, [NS][CH4] dp2, [NS][MAX_ROWS] ddx.
__host__ __device__ inline size_t team_vec_floats(int H, int C, int W) {
  return (size_t)NV_BWD * round4(H) +
         2 * NS * ((size_t)MAX_ROWS + team_row(W) + round4(C * H));
}
// One slot of the partials (a team's accumulators): w1 [H][S], b1 [S],
// w2 [C*H][S], b2 [CH4]; columns past W stay zero.
__host__ __device__ inline size_t team_acc_floats(int H, int C, int W) {
  return ((size_t)H + 1 + (size_t)C * H) * team_row(W) + round4(C * H);
}

// A team launch: T (TEAM) threads per lane, L teams per block, the slots
// (the teams: blocks * L; in the backward one slot of the partials per
// team, teams striding over the lanes when the partials would pass
// MAX_PARTIALS), the lanes a forward team walks at each attempt (lane
// slot + l * slots, l < lanes), the outputs of the second layer a thread
// carries at once (4 where each thread owns more than two, else 1),
// whether the weights (and the backward's accumulators) sit in shared
// memory, and whether a forward's first layer takes one row per thread
// (narrow: W <= T).
struct TeamPlan {
  int T, L, blocks, slots, lanes, rows;
  bool smem, narrow;
  size_t bytes;  // dynamic shared memory of a block
};

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      n = 1;
  }
  return n;
}

// Enough teams per block to spread B lanes over the SMs, as many as fit.
int team_plan(TeamPlan& p, int B, int H, int C, int W) {
  if (B < 1) return BAD_ARGUMENT;
  p.T = TEAM;
  const size_t smem = MAX_SMEM / sizeof(float), acc = team_acc_floats(H, C, W);
  const size_t vec = team_vec_floats(H, C, W), wts = team_weight_floats(H, C, W);
  const size_t teams = std::min((size_t)B, std::max<size_t>(1, MAX_PARTIALS / acc));
  const size_t spread = (teams + sm_count() - 1) / sm_count();
  const size_t want = std::min<size_t>(std::max<size_t>(spread, 1), MAX_TEAM_BLOCK / TEAM);
  const size_t slice = vec + acc;
  p.smem = wts + slice <= smem;
  const size_t fit = p.smem ? (smem - wts) / slice : smem / vec;
  if (fit < 1) return BAD_VARIANT;
  p.L = (int)std::min(want, fit);
  p.bytes = sizeof(float) * (p.smem ? wts + p.L * slice : p.L * vec);
  p.blocks = (int)((teams + p.L - 1) / p.L);
  p.slots = p.blocks * p.L;
  p.lanes = 1;
  p.rows = C * H > 2 * TEAM ? 4 : 1;
  p.narrow = false;
  return 0;
}

// The team forward's launch: a team per lane, as many per block as spread
// the teams over the SMs (at most MAX_TEAM_BLOCK threads), the weights in
// shared memory where they fit beside one team's slice, as in team_plan.
// A cooperative launch (K2: the group norm needs every block resident at
// once) takes the least lanes per team whose grid `resident(p, threads,
// bytes)`, the blocks of the plan's kernel an SM holds, allows; BAD_VARIANT
// where even one team per block cannot be resident.
template <class Resident>
int team_fwd_plan(TeamPlan& p, int B, int H, int C, int W, bool cooperative,
                  Resident resident) {
  if (B < 1) return BAD_ARGUMENT;
  p.T = TEAM;
  p.rows = C * H > 2 * TEAM ? 4 : 1;
  p.narrow = round4(W) <= TEAM;
  const size_t smem = MAX_SMEM / sizeof(float) - FWD_HEAD, wts = team_weight_floats(H, C, W);
  p.smem = wts + team_fwd_floats(H, C, W, 1) <= smem;
  const size_t base = p.smem ? wts : 0;
  const size_t sms = sm_count();
  size_t teams_before = 0;
  for (size_t lanes = 1; lanes <= (cooperative ? (size_t)B : 1); ++lanes) {
    const size_t teams = (B + lanes - 1) / lanes;
    if (teams == teams_before) continue;
    teams_before = teams;
    const size_t slice = team_fwd_floats(H, C, W, (int)lanes);
    if (base + slice > smem) return BAD_VARIANT;
    const size_t want = std::min<size_t>((teams + sms - 1) / sms, MAX_TEAM_BLOCK / TEAM);
    for (size_t L = std::min(want, (smem - base) / slice); L >= 1; --L) {
      p.L = (int)L;
      p.lanes = (int)lanes;
      p.bytes = sizeof(float) * (FWD_HEAD + base + L * slice);
      p.blocks = (int)((teams + L - 1) / L);
      p.slots = p.blocks * p.L;
      const int per_sm = cooperative ? resident(p, (int)L * TEAM, p.bytes) : 1;
      if (!cooperative || (size_t)p.blocks <= (size_t)per_sm * sms) return 0;
      if (L == 1 && per_sm < 1) return BAD_VARIANT;
    }
  }
  return BAD_VARIANT;
}

// The partial sums added in one fixed order.
__device__ __forceinline__ float partial_sum(const float (&a)[PS]) {
  return (a[0] + a[1]) + (a[2] + a[3]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float at4(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

struct TeamShape {
  int H, C, W, CH;
  int H4, CH4, S, Wq;  // padded sizes; Wq: W rounded up to a multiple of 4
};

struct TeamWeights {
  const float *w1, *b1, *w2, *b2;  // w1 [H4][S], b1 [S], w2 [CH4][S], b2 [CH4]
};

struct Team {
  int T;          // threads per team: the plan's T
  int r;          // rank in the team (the lane of its warp)
  int slot;       // the team's slot (of the partials, in the backward)
  float *vec, *dx, *h1, *g, *dp1, *dp2, *ddx;
  Partials acc;   // w1 [H][S], b1 [S], w2 [C*H][S], b2 [CH4]
  __device__ void sync() const { __syncwarp(); }
  __device__ float& at(const TeamShape& s, int i, int h) const { return vec[i * s.H4 + h]; }
};

// A team's slot of the partials dw1p (slots, H, S), db1p (slots, S), dw2p
// (slots, C*H, S), db2p (slots, CH4).
__device__ __forceinline__ Partials team_slot(const Partials& part, const TeamShape& s,
                                              size_t slot) {
  const size_t S = s.S;
  return Partials{part.dw1 + slot * s.H * S, part.db1 + slot * S,
                  part.dw2 + slot * s.CH * S, part.db2 + slot * s.CH4};
}

// The block's shapes and weights: copied from the padded weights in f to
// shared memory at top with SMEM (one contiguous copy: w1, b1, w2, b2),
// else read where they are.  Returns the first float past them.
template <bool SMEM>
__device__ __forceinline__ float* team_load_weights(float* top, const FieldArgs& f,
                                                   TeamWeights& wt, TeamShape& s) {
  const int H = f.H, C = f.C, W = f.W, CH = C * H;
  s = TeamShape{H, C, W, CH, round4(H), round4(CH), team_row(W), round4(W)};
  const size_t S = s.S;
  if (!SMEM) {
    wt = TeamWeights{f.w1t, f.b1, f.w2t, f.b2};
    return top;
  }
  const float* src[4] = {f.w1t, f.b1, f.w2t, f.b2};
  const size_t len[4] = {s.H4 * S, S, s.CH4 * S, (size_t)s.CH4};
  float* dst = top;
  for (int k = 0; k < 4; ++k) {
    for (size_t i = 4 * threadIdx.x; i < len[k]; i += 4 * blockDim.x) st4(dst + i, ld4(src[k] + i));
    dst += len[k];
  }
  wt = TeamWeights{top, top + s.H4 * S, top + (s.H4 + 1) * S, top + (s.H4 + 1 + s.CH4) * S};
  return top + team_weight_floats(H, C, W);
}

// The block's weights and this thread's backward team: its zeroed slice of
// shared memory and its accumulators, zeroed (in shared memory) or its slot
// of the zeroed partials.  Ends with the block's one barrier.
template <bool SMEM>
__device__ __forceinline__ Team team_setup(float* smem, const FieldArgs& f, const TeamPlan& p,
                                           const Partials& part, TeamWeights& wt,
                                           TeamShape& s) {
  const int H = f.H, C = f.C, W = f.W, CH = C * H;
  float* top = team_load_weights<SMEM>(smem, f, wt, s);
  const size_t S = s.S;
  const int ti = threadIdx.x / TEAM;
  Team tm;
  tm.r = threadIdx.x % TEAM;
  tm.T = p.T;
  tm.slot = blockIdx.x * p.L + ti;
  const size_t vec = team_vec_floats(H, C, W), acc = team_acc_floats(H, C, W);
  float* base = top + (size_t)ti * (vec + (SMEM ? acc : 0));
  for (size_t i = 4 * tm.r; i < vec + (SMEM ? acc : 0); i += 4 * tm.T)
    st4(base + i, make_float4(0.f, 0.f, 0.f, 0.f));
  tm.vec = base;
  tm.dx = tm.vec + NV_BWD * s.H4;
  tm.h1 = tm.dx + NS * MAX_ROWS;
  tm.g = tm.h1 + NS * S;
  tm.dp1 = tm.g + (size_t)NS * s.CH4;
  tm.dp2 = tm.dp1 + NS * S;
  tm.ddx = tm.dp2 + (size_t)NS * s.CH4;
  if (SMEM) {
    float* a = base + vec;
    tm.acc = Partials{a, a + H * S, a + (H + 1) * S, a + (H + 1 + (size_t)CH) * S};
  } else {
    tm.acc = team_slot(part, s, tm.slot);
  }
  __syncthreads();
  return tm;
}

// The block's weights (behind FWD_HEAD floats) and this thread's forward
// team: its zeroed slice of shared memory, p.lanes lanes' vectors (lane l's
// by team_lane), then dX/dt and one h1 and g.  Ends with the block's
// barrier.
template <bool SMEM>
__device__ __forceinline__ Team team_fwd_setup(float* smem, const FieldArgs& f,
                                               const TeamPlan& p, TeamWeights& wt,
                                               TeamShape& s) {
  float* top = team_load_weights<SMEM>(smem + FWD_HEAD, f, wt, s);
  const int ti = threadIdx.x / TEAM;
  Team tm{};
  tm.r = threadIdx.x % TEAM;
  tm.T = p.T;
  tm.slot = blockIdx.x * p.L + ti;
  const size_t slice = team_fwd_floats(f.H, f.C, f.W, p.lanes);
  float* base = top + (size_t)ti * slice;
  for (size_t i = 4 * tm.r; i < slice; i += 4 * tm.T)
    st4(base + i, make_float4(0.f, 0.f, 0.f, 0.f));
  tm.vec = base;
  tm.dx = base + (size_t)p.lanes * NV_TEAM_FWD * s.H4;
  tm.h1 = tm.dx + NS * MAX_ROWS;
  tm.g = tm.h1 + s.S;
  __syncthreads();
  return tm;
}

// The forward team's view of its lane l: the same team with lane l's vectors.
__device__ __forceinline__ Team team_lane(const Team& tm, const TeamShape& s, int l) {
  Team v = tm;
  v.vec = tm.vec + (size_t)l * NV_TEAM_FWD * s.H4;
  return v;
}

// A lane view tl with the slice's second dX/dt, h1 and g: the second lane
// of a pair (team_fwd_floats with two lanes or more).
__device__ __forceinline__ Team team_pair_view(const Team& tl, const TeamShape& s) {
  Team v = tl;
  v.dx = tl.g + s.CH4;
  v.h1 = v.dx + NS * MAX_ROWS;
  v.g = v.h1 + s.S;
  return v;
}

// The team's accumulators to its slot of the partials (after the team's
// last barrier).
template <bool SMEM>
__device__ __forceinline__ void team_finish(const Team& tm, const TeamShape& s,
                                            const Partials& part) {
  if (!SMEM) return;
  const Partials dst = team_slot(part, s, tm.slot);
  const float* src[4] = {tm.acc.dw1, tm.acc.db1, tm.acc.dw2, tm.acc.db2};
  float* out[4] = {dst.dw1, dst.db1, dst.dw2, dst.db2};
  const size_t len[4] = {s.H * (size_t)s.S, (size_t)s.S, s.CH * (size_t)s.S, (size_t)s.CH4};
  for (int k = 0; k < 4; ++k)
    for (size_t i = 4 * tm.r; i < len[k]; i += 4 * tm.T) st4(out[k] + i, ld4(src[k] + i));
}

// dX/dt at the seven stage times of the step (t, dt) into tm.dx (threads
// i = r (mod T) < C): every load of the step issued at once.
__device__ __forceinline__ void team_load_dx(const Table& tab, const Team& tm, size_t lane,
                                             float t, float dt) {
  const int C = tab.C;
  const size_t B = tab.B;
  for (int i = tm.r; i < C; i += tm.T) {
    for (int st = 0; st < NS; ++st) {
      int j;
      float fr;
      locate(tab, st == 0 ? t : stage_time(t, kAlpha[st - 1], dt), j, fr);
      float d;
      if (tab.linear) {
        d = tab.ct[((size_t)j * C + i) * B + lane];
      } else {
        const float* row = tab.ct + (size_t)j * 3 * C * B + lane;
        d = row[(size_t)i * B] +
            (row[(size_t)(C + i) * B] + row[(size_t)(2 * C + i) * B] * fr) * fr;
      }
      tm.dx[st * MAX_ROWS + i] = d;
    }
  }
}

// Stage st's evaluation k = g(y) . dX/dt, y = vector YS + st, into KV + st;
// keeps the stage's h1 and g for its VJP (in the stage's slots; with ONE,
// the forward's, in the one slot its stages share).  The caller has written
// y (each thread its own channels) and the step's dX/dt.  RB outputs q at a
// time.  NARROW (the forwards' kernels for W <= T): where the rows fit the
// team, one hidden row per thread in the first layer, not a quad; each
// row's sum runs over h in the same order either way, so both give the
// same bits.
template <int RB, bool ONE, bool NARROW = false>
__device__ __forceinline__ void team_eval(const TeamWeights& wt, const TeamShape& s,
                                          const Team& tm, int st) {
  const int H = s.H, CH = s.CH, T = tm.T, r = tm.r;
  const size_t S = s.S;
  tm.sync();
  const float* y = tm.vec + (YS + st) * s.H4;
  float* h1 = ONE ? tm.h1 : tm.h1 + st * S;
  if (NARROW && s.Wq <= T) {
    if (r < s.Wq) {
      float a = 0.f;
      for (int h = 0; h < H; ++h) a = fmaf(wt.w1[h * S + r], y[h], a);
      h1[r] = fmaxf(a + wt.b1[r], 0.f);
    }
  } else
  for (int w = 4 * r; w < s.Wq; w += 4 * T) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int h = 0; h < H; h += 4) {
      const float4 yv = ld4(y + h);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 wv = ld4(wt.w1 + (h + u) * S + w);
        const float yu = at4(yv, u);
        a[0] = fmaf(wv.x, yu, a[0]);
        a[1] = fmaf(wv.y, yu, a[1]);
        a[2] = fmaf(wv.z, yu, a[2]);
        a[3] = fmaf(wv.w, yu, a[3]);
      }
    }
    const float4 bv = ld4(wt.b1 + w);
    const float4 o = make_float4(fmaxf(a[0] + bv.x, 0.f), fmaxf(a[1] + bv.y, 0.f),
                                 fmaxf(a[2] + bv.z, 0.f), fmaxf(a[3] + bv.w, 0.f));
    st4(h1 + w, o);
  }
  tm.sync();
  float* g = ONE ? tm.g : tm.g + st * s.CH4;
  for (int q0 = r; q0 < CH; q0 += RB * T) {
    const float* row[RB];
    float a[RB][PS];
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      row[k] = wt.w2 + (size_t)min(q0 + k * T, CH - 1) * S;
#pragma unroll
      for (int u = 0; u < PS; ++u) a[k][u] = 0.f;
    }
    for (int w = 0; w < s.Wq; w += 4) {
      const float4 hv = ld4(h1 + w);
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        const float4 wv = ld4(row[k] + w);
        a[k][0] = fmaf(wv.x, hv.x, a[k][0]);
        a[k][1] = fmaf(wv.y, hv.y, a[k][1]);
        a[k][2] = fmaf(wv.z, hv.z, a[k][2]);
        a[k][3] = fmaf(wv.w, hv.w, a[k][3]);
      }
    }
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int q = q0 + k * T;
      if (q < CH) g[q] = tanhf(partial_sum(a[k]) + wt.b2[q]);
    }
  }
  tm.sync();
  const float* dx = tm.dx + st * MAX_ROWS;
  for (int h = r; h < H; h += T) {
    float acc = g[h] * dx[0];
    for (int i = 1; i < s.C; ++i) acc += g[i * H + h] * dx[i];
    tm.at(s, KV + st, h) = acc;
  }
}

// VJP of stage st for the cotangent in vector U, which the caller has
// written (each thread its own channels): dy into KV + st, and the stage's
// dp2, dp1 and ddx kept for the step's end.
__device__ __forceinline__ void team_vjp(const TeamWeights& wt, const TeamShape& s,
                                         const Team& tm, int st) {
  const int H = s.H, C = s.C, CH = s.CH, T = tm.T, r = tm.r;
  const size_t S = s.S;
  tm.sync();
  // dp2 = u dx (1 - g^2) of the outputs q this thread owns; g becomes u g.
  const float* u = tm.vec + U * s.H4;
  const float* dx = tm.dx + st * MAX_ROWS;
  float* g = tm.g + st * s.CH4;
  float* dp2 = tm.dp2 + st * s.CH4;
  for (int q = r; q < CH; q += T) {
    const int i = q / H, h = q - i * H;
    const float gq = g[q], uh = u[h];
    dp2[q] = (uh * dx[i]) * (1.f - gq * gq);
    g[q] = uh * gq;
  }
  tm.sync();
  // ddx_i = sum_h u_h g_(i H + h).
  for (int i = r; i < C; i += T) {
    float acc = 0.f;
    for (int h = 0; h < H; ++h) acc += g[i * H + h];
    tm.ddx[st * MAX_ROWS + i] = acc;
  }
  // The quads of rows this thread owns: dh1 = W2^T dp2 (four outputs apart)
  // and dp1 behind the ReLU mask.
  const float* h1 = tm.h1 + st * S;
  float* dp1 = tm.dp1 + st * S;
  for (int w = 4 * r; w < s.Wq; w += 4 * T) {
    float dh[4][PS];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int u2 = 0; u2 < PS; ++u2) dh[j][u2] = 0.f;
    for (int q = 0; q < CH; q += 4) {
      const float4 dv = ld4(dp2 + q);
#pragma unroll
      for (int u2 = 0; u2 < 4; ++u2) {
        const float4 wv = ld4(wt.w2 + (q + u2) * S + w);
        const float d = at4(dv, u2);
        dh[0][u2] = fmaf(wv.x, d, dh[0][u2]);
        dh[1][u2] = fmaf(wv.y, d, dh[1][u2]);
        dh[2][u2] = fmaf(wv.z, d, dh[2][u2]);
        dh[3][u2] = fmaf(wv.w, d, dh[3][u2]);
      }
    }
    const float4 hv = ld4(h1 + w);
    st4(dp1 + w, make_float4(hv.x > 0.f ? partial_sum(dh[0]) : 0.f,
                             hv.y > 0.f ? partial_sum(dh[1]) : 0.f,
                             hv.z > 0.f ? partial_sum(dh[2]) : 0.f,
                             hv.w > 0.f ? partial_sum(dh[3]) : 0.f));
  }
  tm.sync();
  // dy_h = sum_w W1[w, h] dp1_w: Hp channels at a time, each summed by
  // T / Hp threads over interleaved quads of rows, then across them by
  // shuffles.
  int Hp = 1;
  while (Hp < H && Hp < T) Hp <<= 1;
  const int G = T / Hp, hh = r & (Hp - 1), seg = r / Hp;
  for (int base = 0; base < H; base += Hp) {
    const int h = base + hh;
    float a4[PS] = {0.f, 0.f, 0.f, 0.f};
    if (h < H) {
      for (int w = 4 * seg; w < s.Wq; w += 4 * G) {
        const float4 wv = ld4(wt.w1 + h * S + w), pv = ld4(dp1 + w);
        a4[0] = fmaf(wv.x, pv.x, a4[0]);
        a4[1] = fmaf(wv.y, pv.y, a4[1]);
        a4[2] = fmaf(wv.z, pv.z, a4[2]);
        a4[3] = fmaf(wv.w, pv.w, a4[3]);
      }
    }
    float a = partial_sum(a4);
    for (int o = Hp; o < T; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    if (seg == 0 && h < H) tm.at(s, KV + st, h) = a;
  }
}

// The step's weight gradients into the team's accumulators, each entry by
// the thread that owns it, summed over the seven stages first: dW1[w, h] +=
// sum_st dp1_st[w] y_st[h], db1[w] += sum_st dp1_st[w], dW2[q, w] += sum_st
// dp2_st[q] h1_st[w], db2[q] += sum_st dp2_st[q].  A quad of rows at a
// time, so that each broadcast y_st and dp2_st serves four.  Reads only what
// the step's passes left behind their barriers.
__device__ __forceinline__ void team_step_weights(const TeamShape& s, const Team& tm) {
  const int H = s.H, CH = s.CH, T = tm.T;
  const size_t S = s.S;
  for (int w = 4 * tm.r; w < s.Wq; w += 4 * T) {
    float4 hv[NS], pv[NS];
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      hv[st] = ld4(tm.h1 + st * S + w);
      pv[st] = ld4(tm.dp1 + st * S + w);
    }
    {
      float4 b = ld4(tm.acc.db1 + w);
      float sb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int st = 0; st < NS; ++st) {
        sb[0] += pv[st].x;
        sb[1] += pv[st].y;
        sb[2] += pv[st].z;
        sb[3] += pv[st].w;
      }
      b.x += sb[0];
      b.y += sb[1];
      b.z += sb[2];
      b.w += sb[3];
      st4(tm.acc.db1 + w, b);
    }
    for (int h = 0; h < H; ++h) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int st = 0; st < NS; ++st) {
        const float yv = tm.vec[(YS + st) * s.H4 + h];
        a[0] = fmaf(pv[st].x, yv, a[0]);
        a[1] = fmaf(pv[st].y, yv, a[1]);
        a[2] = fmaf(pv[st].z, yv, a[2]);
        a[3] = fmaf(pv[st].w, yv, a[3]);
      }
      float* dst = tm.acc.dw1 + h * S + w;
      float4 o = ld4(dst);
      o.x += a[0];
      o.y += a[1];
      o.z += a[2];
      o.w += a[3];
      st4(dst, o);
    }
    for (int q = 0; q < CH; ++q) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int st = 0; st < NS; ++st) {
        const float d = tm.dp2[st * s.CH4 + q];
        a[0] = fmaf(d, hv[st].x, a[0]);
        a[1] = fmaf(d, hv[st].y, a[1]);
        a[2] = fmaf(d, hv[st].z, a[2]);
        a[3] = fmaf(d, hv[st].w, a[3]);
      }
      float* dst = tm.acc.dw2 + q * S + w;
      float4 o = ld4(dst);
      o.x += a[0];
      o.y += a[1];
      o.z += a[2];
      o.w += a[3];
      st4(dst, o);
    }
  }
  for (int q = tm.r; q < CH; q += T) {
    float a = 0.f;
#pragma unroll
    for (int st = 0; st < NS; ++st) a += tm.dp2[st * s.CH4 + q];
    tm.acc.db2[q] += a;
  }
}

// The step's ddx into the lane's dct rows (threads i = r (mod T) < C):
// stages in one interval (their times do not decrease) are summed first.
__device__ __forceinline__ void team_flush_dct(const Table& tab, const Team& tm, size_t lane,
                                               float t, float dt, float* dct) {
  const int C = tab.C;
  const size_t B = tab.B;
  for (int i = tm.r; i < C; i += tm.T) {
    int jc = -1;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int st = 0; st <= NS; ++st) {
      int j = -2;
      float fr = 0.f;
      if (st < NS) locate(tab, st == 0 ? t : stage_time(t, kAlpha[st - 1], dt), j, fr);
      if (j != jc && jc >= 0) {
        if (tab.linear) {
          dct[((size_t)jc * C + i) * B + lane] += a0;
        } else {
          float* row = dct + (size_t)jc * 3 * C * B + lane;
          row[(size_t)i * B] += a0;
          row[(size_t)(C + i) * B] += a1;
          row[(size_t)(2 * C + i) * B] += a2;
        }
        a0 = a1 = a2 = 0.f;
      }
      if (st == NS) break;
      jc = j;
      const float d = tm.ddx[st * MAX_ROWS + i];
      a0 += d;
      a1 += fr * d;
      a2 += (fr * fr) * d;
    }
  }
}

// The step's stored state z (z[h * stride]) into YS and its dX/dt, the
// loads of both issued before either is stored.
__device__ __forceinline__ void team_load_step(const TeamShape& s, const Team& tm,
                                               const Table& tab, size_t lane, float t, float dt,
                                               const float* z, size_t stride) {
  const float z0 = tm.r < s.H ? z[(size_t)tm.r * stride] : 0.f;
  for (int h = tm.r + tm.T; h < s.H; h += tm.T) tm.at(s, YS, h) = z[(size_t)h * stride];
  team_load_dx(tab, tm, lane, t, dt);
  if (tm.r < s.H) tm.at(s, YS, tm.r) = z0;
}

// Stages first .. 6 of the step of size dt into KV + first .., each
// stage's input into YS + st, after the step's dX/dt (team_load_dx): the
// backward's recompute (first 0, after team_load_step) and the forward's
// attempt (ONE, first 1: the first stage is the last of the step before).
template <int RB, bool ONE, bool NARROW = false>
__device__ __forceinline__ void team_stages(const TeamWeights& wt, const TeamShape& s,
                                            const Team& tm, float dt, int first) {
  // One copy of the evaluation in the code: with a second call site for
  // stage 0, K9's backward took 2 % longer on an H100.
#pragma unroll 1
  for (int st = first; st < NS; ++st) {
    for (int h = tm.r; st > 0 && h < s.H; h += tm.T) {
      float y = tm.at(s, YS, h);
      for (int q = 0; q < st; ++q) {
        const float coef = kBeta[st - 1][q];
        if (coef != 0.f) y = y + (dt * coef) * tm.at(s, KV + q, h);
      }
      tm.at(s, YS + st, h) = y;
    }
    team_eval<RB, ONE, NARROW>(wt, s, tm, st);
  }
}

// Stage st's evaluation of two lanes at once, a and b (the forward's, each
// with its own dX/dt, h1 and g; not NARROW): team_eval<RB, true>'s
// operations on each lane in its order, so each gets the same bits as
// alone, with every weight read once for both.
template <int RB>
__device__ __forceinline__ void team_eval_pair(const TeamWeights& wt, const TeamShape& s,
                                               const Team& a, const Team& b, int st) {
  const int H = s.H, CH = s.CH, T = a.T, r = a.r;
  const size_t S = s.S;
  a.sync();
  const float* ya = a.vec + (YS + st) * s.H4;
  const float* yb = b.vec + (YS + st) * s.H4;
  for (int w = 4 * r; w < s.Wq; w += 4 * T) {
    float pa[4] = {0.f, 0.f, 0.f, 0.f}, pb[4] = {0.f, 0.f, 0.f, 0.f};
    for (int h = 0; h < H; h += 4) {
      const float4 va = ld4(ya + h), vb = ld4(yb + h);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 wv = ld4(wt.w1 + (h + u) * S + w);
        const float ua = at4(va, u), ub = at4(vb, u);
        pa[0] = fmaf(wv.x, ua, pa[0]);
        pa[1] = fmaf(wv.y, ua, pa[1]);
        pa[2] = fmaf(wv.z, ua, pa[2]);
        pa[3] = fmaf(wv.w, ua, pa[3]);
        pb[0] = fmaf(wv.x, ub, pb[0]);
        pb[1] = fmaf(wv.y, ub, pb[1]);
        pb[2] = fmaf(wv.z, ub, pb[2]);
        pb[3] = fmaf(wv.w, ub, pb[3]);
      }
    }
    const float4 bv = ld4(wt.b1 + w);
    st4(a.h1 + w, make_float4(fmaxf(pa[0] + bv.x, 0.f), fmaxf(pa[1] + bv.y, 0.f),
                              fmaxf(pa[2] + bv.z, 0.f), fmaxf(pa[3] + bv.w, 0.f)));
    st4(b.h1 + w, make_float4(fmaxf(pb[0] + bv.x, 0.f), fmaxf(pb[1] + bv.y, 0.f),
                              fmaxf(pb[2] + bv.z, 0.f), fmaxf(pb[3] + bv.w, 0.f)));
  }
  a.sync();
  for (int q0 = r; q0 < CH; q0 += RB * T) {
    const float* row[RB];
    float ga[RB][PS], gb[RB][PS];
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      row[k] = wt.w2 + (size_t)min(q0 + k * T, CH - 1) * S;
#pragma unroll
      for (int u = 0; u < PS; ++u) ga[k][u] = gb[k][u] = 0.f;
    }
    for (int w = 0; w < s.Wq; w += 4) {
      const float4 ha = ld4(a.h1 + w), hb = ld4(b.h1 + w);
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        const float4 wv = ld4(row[k] + w);
        ga[k][0] = fmaf(wv.x, ha.x, ga[k][0]);
        ga[k][1] = fmaf(wv.y, ha.y, ga[k][1]);
        ga[k][2] = fmaf(wv.z, ha.z, ga[k][2]);
        ga[k][3] = fmaf(wv.w, ha.w, ga[k][3]);
        gb[k][0] = fmaf(wv.x, hb.x, gb[k][0]);
        gb[k][1] = fmaf(wv.y, hb.y, gb[k][1]);
        gb[k][2] = fmaf(wv.z, hb.z, gb[k][2]);
        gb[k][3] = fmaf(wv.w, hb.w, gb[k][3]);
      }
    }
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int q = q0 + k * T;
      if (q < CH) {
        a.g[q] = tanhf(partial_sum(ga[k]) + wt.b2[q]);
        b.g[q] = tanhf(partial_sum(gb[k]) + wt.b2[q]);
      }
    }
  }
  a.sync();
  const float *dxa = a.dx + st * MAX_ROWS, *dxb = b.dx + st * MAX_ROWS;
  for (int h = r; h < H; h += T) {
    float acc = a.g[h] * dxa[0], bcc = b.g[h] * dxb[0];
    for (int i = 1; i < s.C; ++i) {
      acc += a.g[i * H + h] * dxa[i];
      bcc += b.g[i * H + h] * dxb[i];
    }
    a.at(s, KV + st, h) = acc;
    b.at(s, KV + st, h) = bcc;
  }
}

// team_stages<RB, true> of the forward's attempt (stages 1 .. 6) for two
// lanes at once, after both lanes' dX/dt.
template <int RB>
__device__ __forceinline__ void team_stages_pair(const TeamWeights& wt, const TeamShape& s,
                                                 const Team& a, const Team& b, float dt) {
#pragma unroll 1
  for (int st = 1; st < NS; ++st) {
    for (int h = a.r; h < s.H; h += a.T) {
      float ya = a.at(s, YS, h), yb = b.at(s, YS, h);
      for (int q = 0; q < st; ++q) {
        const float coef = kBeta[st - 1][q];
        if (coef != 0.f) {
          ya = ya + (dt * coef) * a.at(s, KV + q, h);
          yb = yb + (dt * coef) * b.at(s, KV + q, h);
        }
      }
      a.at(s, YS + st, h) = ya;
      b.at(s, YS + st, h) = yb;
    }
    team_eval_pair<RB>(wt, s, a, b, st);
  }
}

// The lane's sum over its hidden channels of the attempted step's squared
// scaled error (z in YS, z1 the last stage input YS + 6, which the plain
// versions' z + dt sum csol_q k_q is): each thread sums its own channels,
// then the team adds across by a butterfly of shuffles, one fixed order
// whose sum has the same bits in every thread (float addition commutes).
__device__ __forceinline__ float team_error(const TeamShape& s, const Team& tm, float dc,
                                            float rtol, float atol) {
  float part = 0.f;
  for (int h = tm.r; h < s.H; h += tm.T) {
    const float z = tm.at(s, YS, h), z1 = tm.at(s, YS + NS - 1, h);
    float e = 0.f;
    for (int q = 0; q < NS; ++q)
      if (kCerr[q] != 0.f) e = e + kCerr[q] * tm.at(s, KV + q, h);
    e = dc * e;
    const float scaled = e / (atol + rtol * fmaxf(fabsf(z), fabsf(z1)));
    part += scaled * scaled;
  }
  for (int o = 1; o < tm.T; o <<= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  return part;
}

// The dense output at theta of the accepted step (z to z1) into out[h *
// stride], by the channels' owners.
__device__ __forceinline__ void team_dense(const TeamShape& s, const Team& tm, const Dense& d,
                                           float dc, float theta, float* out, size_t stride) {
  float cA, cB, cC;
  dense_coeffs(d.minv, theta, cA, cB, cC);
  for (int h = tm.r; h < s.H; h += tm.T) {
    const float z = tm.at(s, YS, h), z1 = tm.at(s, YS + NS - 1, h);
    const float k0 = tm.at(s, KV, h), k6 = tm.at(s, KV + NS - 1, h);
    float ymid = z;
    for (int q = 0; q < NS; ++q)
      if (d.bmid[q] != 0.f) ymid = ymid + (dc * d.bmid[q]) * tm.at(s, KV + q, h);
    const float rA = z1 - z - dc * k0;
    const float rB = dc * (k6 - k0);
    const float rC = ymid - z - (0.5f * dc) * k0;
    out[(size_t)h * stride] = z + (theta * dc) * k0 + cA * rA + cB * rB + cC * rC;
  }
}

// An accepted step's end, by the channels' owners: z becomes z1 and the
// first stage the last (FSAL).
__device__ __forceinline__ void team_advance(const TeamShape& s, const Team& tm) {
  for (int h = tm.r; h < s.H; h += tm.T) {
    tm.at(s, YS, h) = tm.at(s, YS + NS - 1, h);
    tm.at(s, KV, h) = tm.at(s, KV + NS - 1, h);
  }
}

// The dense output's cotangent terms before any output row: lambda flows
// into z1.
__device__ __forceinline__ void team_start_cotangents(const TeamShape& s, const Team& tm) {
  for (int h = tm.r; h < s.H; h += tm.T) {
    tm.at(s, LZ, h) = 0.f;
    tm.at(s, LZ1, h) = tm.at(s, LAM, h);
    tm.at(s, E0, h) = tm.at(s, E6, h) = tm.at(s, UMID, h) = 0.f;
  }
}

// Adds the cotangent gk (gk[h * stride]) of the output row at theta.
__device__ __forceinline__ void team_add_row(const TeamShape& s, const Team& tm, const Dense& d,
                                             float theta, float dt, const float* gk,
                                             size_t stride) {
  float cA, cB, cC;
  dense_coeffs(d.minv, theta, cA, cB, cC);
  for (int h = tm.r; h < s.H; h += tm.T) {
    const float g = gk[(size_t)h * stride];
    tm.at(s, LZ, h) += (1.f - cA - cC) * g;
    tm.at(s, LZ1, h) += cA * g;
    tm.at(s, E0, h) += (dt * (theta - cA - cB - 0.5f * cC)) * g;
    tm.at(s, E6, h) += (dt * cB) * g;
    tm.at(s, UMID, h) += cC * g;
  }
}

// The stages' cotangents in reverse, each through the field's VJP, then
// lambda before the step, the step's weight gradients and its dct rows.
// Ends with the team at a barrier.
template <int RB>
__device__ __forceinline__ void team_step_backward(const TeamWeights& wt, const TeamShape& s,
                                                   const Team& tm, const Table& tab,
                                                   const Dense& d, size_t lane, float t,
                                                   float dt, float* dct) {
  const int H = s.H;
  // y_mid = z + dt sum bmid_q k_q and z1 = z + dt sum csol_q k_q.
  for (int h = tm.r; h < H; h += tm.T)
    tm.at(s, LZ, h) = tm.at(s, LZ, h) + tm.at(s, UMID, h) + tm.at(s, LZ1, h);
  for (int st = NS - 1; st >= 0; --st) {
    for (int h = tm.r; h < H; h += tm.T) {
      float u = st == 0 ? tm.at(s, E0, h) : (st == NS - 1 ? tm.at(s, E6, h) : 0.f);
      u = u + (dt * d.bmid[st]) * tm.at(s, UMID, h) + (dt * kCsol[st]) * tm.at(s, LZ1, h);
      for (int s2 = st + 1; s2 < NS; ++s2) {
        const float coef = kBeta[s2 - 1][st];
        if (coef != 0.f) u = u + (dt * coef) * tm.at(s, KV + s2, h);
      }
      tm.at(s, U, h) = u;
    }
    team_vjp(wt, s, tm, st);
  }
  for (int h = tm.r; h < H; h += tm.T) {
    float lz = tm.at(s, LZ, h);
    for (int st = 0; st < NS; ++st) lz = lz + tm.at(s, KV + st, h);
    tm.at(s, LAM, h) = lz;
  }
  team_step_weights(s, tm);
  team_flush_dct(tab, tm, lane, t, dt, dct);
  tm.sync();
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Fills the table, the field and the dense constants; 0 or an error code.
int make_table(Table& tab, FieldArgs& f, Dense& d, const float* ct, const float* w1t,
               const float* b1, const float* w2t, const float* b2, int B, int n, int H, int C,
               int W, int n_out, const float* dense, float t0g, float w, int linear, int lead) {
  const int rows = linear ? C : 3 * C;
  if (B < 1 || n < 1 || H < 1 || C < 1 || rows > MAX_ROWS || W < 1 || n_out < 0 ||
      n_out > MAX_OUT || !(w > 0.f) || (lead && !linear))
    return BAD_ARGUMENT;
  tab = Table{ct, B, n, C, linear != 0, lead != 0, t0g, w};
  f = FieldArgs{w1t, b1, w2t, b2, H, C, W};
  for (int q = 0; q < NS; ++q) d.bmid[q] = dense[q];
  for (int q = 0; q < 9; ++q) d.minv[q] = dense[NS + q];
  return 0;
}

}  // namespace
