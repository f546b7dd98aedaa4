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
// H 8, C 3 at every width of the caps, W <= 512).  Both directions run a
// group of FB_G threads per batch lane, each owning every FB_G-th hidden
// row, so that a 4096 batch fills the card with several warps per SM, and
// blocks of lanes share one copy of the weights (FB_REC-float records), as
// many blocks as the SMs hold at once (blocks stride over the lane groups
// beyond that).
//  * The forward ("Specialised forward" below): a group of FB_G threads per
//    lane runs the lane's chain replicated in registers, each evaluation
//    split over the group's rows (fb_eval, the same stage evaluation as the
//    backward's recompute); blocks of FF_LANES lanes.  Its shared memory is
//    the weight records and b2 alone.  This replaces the TPU's sequential
//    grid axis and its VMEM carry of z.
//  * The backward ("Specialised backward" below) recomputes each interval's
//    substeps and stages from the stored knot state, as the TPU kernel
//    does, with FB_G threads per lane and blocks of FB_LANES lanes, and each
//    thread keeps a register tile of the weight gradients summed over its
//    block's lanes, written once as the block's partial and summed after the
//    launch, as the JAX package sums its per-tile partials: deterministic,
//    no float atomics.

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
//   db2p (blocks, C*H), with the blocks of ff_backward_plan(...).

#include <stddef.h>

#include <algorithm>

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

// ---------------------------------------------------------------------------
// Specialised backward (H 8, C 3): a group of FB_G threads per lane, blocks
// of FB_LANES lanes that share one copy of the weights, as many blocks as
// the SMs hold at once (blocks stride over the lane groups beyond that), and
// the weight gradients reduced in register tiles.
//
// The JAX kernel walks a tile of lanes per program and sums the tile's
// weight gradients over every interval as products over its lanes.  Here a
// block's FB_LANES lanes are the tile.  Per evaluation or VJP, thread r of
// a lane's group owns the hidden rows w = r (mod FB_G): it computes their
// h1 (and in the VJP their dp1 and the products for dy), reading each row
// of the weights as float4 broadcasts from a record of FB_REC floats (row
// w of W1, column w of W2, b1[w]; records 36 floats apart, so the group's
// rows fall in distinct banks).  The group's partial pre-activations of
// the second layer are summed across its threads by a butterfly of
// shuffles that leaves each thread C*H/FB_G of the sums; the thread takes
// their tanh, and a second butterfly gathers g back into every thread, the
// same bits in each.  dy is summed by a butterfly too.  So the lane's
// chain (the stage inputs and cotangents, lambda, the recomputed substeps)
// runs replicated in each thread of its group, in registers, with no
// synchronisation.  A VJP stages what the weight gradients need in shared
// memory, per lane: h1 and dp1 of every row (the left operands), dp2 and y
// (the right ones); then the block reduces them over its lanes as a
// product: thread (lane k, r) owns a register tile of rows 4k .. 4k + 3 of
// each chunk of FB_CHUNK rows by FB_NC columns, of dW2 (columns
// FB_NC r .. of dp2, left h1) or of dW1 (columns of y, left dp1), with db1
// and db2 beside them.  Each VJP's lanes are summed in order into a fresh
// partial, which is then added to the tile; the tile holds its sums over
// the whole walk and is written once, as the block's partial.  Every sum
// runs in a fixed order, without atomics: two launches give the same bits.
//
// Mixed precision (MX): the operands of each product are rounded to
// bfloat16 where the JAX kernel's _stage_forward and _stage_backward (_dg)
// feed bfloat16 to its matrix unit: y and h1 in the evaluation, dp2 in dh1
// and dW2, h1 in dW2, dp1 in dy and dW1, y in dW1; db1 and db2 sum the
// unrounded dp1 and dp2 (a lane's unrounded dp2 is staged beside the
// rounded one).

constexpr int FB_G = 8;                 // threads per lane (a power of two)
constexpr int FB_LANES = 32;            // lanes per block
constexpr int FB_THREADS = FB_LANES * FB_G;
constexpr int FB_H = 8, FB_C = 3, FB_CH = FB_C * FB_H;
constexpr int FB_COLS = FB_CH + FB_H;   // tile columns: dW2's, then dW1's
constexpr int FB_NC = FB_COLS / FB_G;   // columns of one thread's tile
constexpr int FB_OWN = FB_CH / FB_G;    // second-layer outputs a thread finishes
constexpr int FB_CHUNK = 4 * FB_LANES;  // weight rows per tile chunk: a quad per lane
constexpr int FB_MAX_CHUNKS = 4;        // W <= 512, the JAX kernel's cap
constexpr int FB_REC = 36;              // floats of a weight record: w1 (8), w2 (24), b1, pad
constexpr int FB_RIGHT = 60;            // floats per lane: dp2 and y as the products take
                                        // them, the unrounded dp2 (MX), pad
constexpr int FB_DP2 = 32;              // offset of the unrounded dp2 in a lane's right operands
static_assert(FB_CH % FB_NC == 0 && FB_NC % 4 == 0 && FB_CH % FB_G == 0,
              "each thread's tile columns are whole float4s of dW2 or of dW1");

// Rows the groups walk: W rounded up to a multiple of FB_G (and of 4).
__host__ __device__ inline int fb_rows(int W) { return (W + FB_G - 1) / FB_G * FB_G; }

__host__ __device__ inline int fb_chunks(int W) {
  return (fb_rows(W) + FB_CHUNK - 1) / FB_CHUNK;
}

// Row stride of the staged h1 and dp1: the rows rounded up to FB_G (mod 32),
// so that the stores of a warp's lanes (FB_G threads each) hit distinct banks.
__host__ __device__ inline int fb_stride(int W) {
  const int rows = fb_rows(W);
  return rows + ((FB_G - rows) % 32 + 32) % 32;
}

__host__ __device__ inline size_t fb_smem_floats(int W) {
  return (size_t)fb_rows(W) * FB_REC + FB_CH + 2 * (size_t)FB_LANES * fb_stride(W) + 16 +
         (size_t)FB_LANES * FB_RIGHT;
}

// The weights in a block's shared memory, all the forward keeps there.
struct FbWeights {
  float* rec;  // [rows][FB_REC]  w1t row, w2t column, b1; zero past W
  float* b2;   // [24]
  int rows;
  __device__ FbWeights(float* base, int W)
      : rec(base), b2(base + (size_t)fb_rows(W) * FB_REC), rows(fb_rows(W)) {}
};

__host__ __device__ inline size_t fb_weight_floats(int W) {
  return (size_t)fb_rows(W) * FB_REC + FB_CH;
}

// The backward's shared memory: the weights, then the staged products;
// every offset is a multiple of 4 floats.
struct FbShared : FbWeights {
  float* h1;     // [FB_LANES][S]   the lanes' h1 ...
  float* dp1;    // [FB_LANES][S]   ... and dp1, 16 floats (half the banks) further on
  float* right;  // [FB_LANES][FB_RIGHT]
  int S;
  __device__ FbShared(float* base, int W) : FbWeights(base, W), S(fb_stride(W)) {
    h1 = b2 + FB_CH;
    dp1 = h1 + FB_LANES * S + 16;
    right = dp1 + FB_LANES * S;
  }
};

__device__ void fb_load_field(const FbWeights& s, const float* __restrict__ w1t,
                              const float* __restrict__ b1, const float* __restrict__ w2t,
                              const float* __restrict__ b2, int W) {
  for (int i = threadIdx.x; i < s.rows * FB_REC; i += blockDim.x) {
    const int w = i / FB_REC, e = i - w * FB_REC;
    float v = 0.f;
    if (w < W) {
      if (e < FB_H) v = w1t[w * FB_H + e];
      else if (e < FB_H + FB_CH) v = w2t[(size_t)(e - FB_H) * W + w];
      else if (e == FB_H + FB_CH) v = b1[w];
    }
    s.rec[i] = v;
  }
  for (int i = threadIdx.x; i < FB_CH; i += blockDim.x) s.b2[i] = b2[i];
}

// The sums of v over the group's FB_G threads, scattered: a butterfly of
// shuffles from the highest bit of r down, each step keeping half of the
// live entries, leaves thread r the sums of entries [r N/FB_G, (r+1) N/FB_G)
// in v[0 .. N/FB_G).
template <int M, int N, int LIVE>
struct Scatter {
  static __device__ __forceinline__ void run(float (&v)[N], int r) {
    constexpr int HALF = LIVE / 2;
    const bool hi = r & M;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float keep = hi ? v[HALF + i] : v[i];
      const float send = hi ? v[i] : v[HALF + i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
    }
    Scatter<M / 2, N, HALF>::run(v, r);
  }
};
template <int N, int LIVE>
struct Scatter<0, N, LIVE> {
  static __device__ __forceinline__ void run(float (&)[N], int) {}
};

// The inverse: thread r's block v[0 .. N/FB_G) of entries [r N/FB_G, ...)
// gathered from the group into v[0 .. N) of every thread, each entry a copy
// of its one owner's.
template <int M, int N, int LIVE>
struct Gather {
  static __device__ __forceinline__ void run(float (&v)[N], int r) {
    const bool hi = r & M;
#pragma unroll
    for (int i = 0; i < LIVE; ++i) {
      const float mine = v[i];
      const float other = __shfl_xor_sync(0xffffffffu, mine, M);
      v[i] = hi ? other : mine;
      v[LIVE + i] = hi ? mine : other;
    }
    Gather<2 * M, N, 2 * LIVE>::run(v, r);
  }
};
template <int N, int LIVE>
struct Gather<FB_G, N, LIVE> {
  static __device__ __forceinline__ void run(float (&)[N], int) {}
};

// v summed over the group's threads, the same bits in each (a butterfly:
// at every step both partners add the same two values).
template <int N>
__device__ __forceinline__ void fb_group_sum(float (&v)[N]) {
#pragma unroll
  for (int m = 1; m < FB_G; m *= 2) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], m);
  }
}

// g = tanh(W2 relu(W1 y + b1) + b2) for one lane, by its group; thread r
// walks rows r, r + FB_G, ..., each row's sum over h in order.  With STAGE,
// each row's h1 goes to the lane's row h1 (in shared memory).
template <bool MX, bool STAGE>
__device__ __forceinline__ void fb_eval(const FbWeights& s, float* h1, int r,
                                        const float (&y)[FB_H], float (&g)[FB_CH]) {
  float yr[FB_H];
#pragma unroll
  for (int h = 0; h < FB_H; ++h) yr[h] = mx_round<MX>(y[h]);
#pragma unroll
  for (int q = 0; q < FB_CH; ++q) g[q] = 0.f;
#pragma unroll 2
  for (int w = r; w < s.rows; w += FB_G) {
    const float* rec = s.rec + w * FB_REC;
    const float4 a0 = *reinterpret_cast<const float4*>(rec);
    const float4 a1 = *reinterpret_cast<const float4*>(rec + 4);
    float a = 0.f;
    a = fmaf(a0.x, yr[0], a);
    a = fmaf(a0.y, yr[1], a);
    a = fmaf(a0.z, yr[2], a);
    a = fmaf(a0.w, yr[3], a);
    a = fmaf(a1.x, yr[4], a);
    a = fmaf(a1.y, yr[5], a);
    a = fmaf(a1.z, yr[6], a);
    a = fmaf(a1.w, yr[7], a);
    a += rec[FB_H + FB_CH];
    a = (a < 0.f) ? 0.f : a;
    if (STAGE) h1[w] = a;
    const float ar = mx_round<MX>(a);
    const float4* r2 = reinterpret_cast<const float4*>(rec + FB_H);
#pragma unroll
    for (int j = 0; j < FB_CH / 4; ++j) {
      const float4 v = r2[j];
      g[4 * j] = fmaf(v.x, ar, g[4 * j]);
      g[4 * j + 1] = fmaf(v.y, ar, g[4 * j + 1]);
      g[4 * j + 2] = fmaf(v.z, ar, g[4 * j + 2]);
      g[4 * j + 3] = fmaf(v.w, ar, g[4 * j + 3]);
    }
  }
  Scatter<FB_G / 2, FB_CH, FB_CH>::run(g, r);
#pragma unroll
  for (int j = 0; j < FB_OWN; ++j) g[j] = tanhf(g[j] + s.b2[r * FB_OWN + j]);
  Gather<1, FB_CH, FB_OWN>::run(g, r);
}

// A thread's share of the block's weight gradients.
template <int R>
struct FbTile {
  float w[R][4][FB_NC];  // rows FB_CHUNK c + 4k + e, columns FB_NC r + j of [dW2 | dW1]
  float b1[R][4];        // db1 of those rows (the first dW1 group)
  float b2[FB_NC];       // db2 columns FB_NC r + j (lane k = 0, dW2 groups)
};

// Adds chunk c of the staged products over the block's lanes to thread
// (lane k, r)'s tile (and db2 once per VJP, with chunk 0): summed over the
// lanes in order into a fresh partial first.
template <bool MX>
__device__ __forceinline__ void fb_reduce(const FbShared& s, int k, int r, int c,
                                          float (&acc)[4][FB_NC], float (&acc_b1)[4],
                                          float (&acc_b2)[FB_NC]) {
  const int row0 = c * FB_CHUNK + 4 * k;
  if (row0 >= s.rows) return;
  const bool w1cols = r * FB_NC >= FB_CH;
  const bool db1 = r * FB_NC == FB_CH, db2 = c == 0 && k == 0 && !w1cols;
  const float* lp = (w1cols ? s.dp1 : s.h1) + row0;
  const float* rp = s.right + r * FB_NC;
  float part[4][FB_NC], part_b1[4], part_b2[FB_NC];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    part_b1[e] = 0.f;
#pragma unroll
    for (int j = 0; j < FB_NC; ++j) part[e][j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < FB_NC; ++j) part_b2[j] = 0.f;
#pragma unroll 2
  for (int l = 0; l < FB_LANES; ++l) {
    const float4 lv = *reinterpret_cast<const float4*>(lp + l * s.S);
    const float L[4] = {lv.x, lv.y, lv.z, lv.w};
    float Rt[FB_NC];
#pragma unroll
    for (int j = 0; j < FB_NC / 4; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(rp + l * FB_RIGHT + 4 * j);
      Rt[4 * j] = v.x;
      Rt[4 * j + 1] = v.y;
      Rt[4 * j + 2] = v.z;
      Rt[4 * j + 3] = v.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float le = mx_round<MX>(L[e]);
#pragma unroll
      for (int j = 0; j < FB_NC; ++j) part[e][j] = fmaf(le, Rt[j], part[e][j]);
    }
    if (db1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part_b1[e] += L[e];
    }
    if (db2) {
#pragma unroll
      for (int j = 0; j < FB_NC / 4; ++j) {
        const float4 v = MX ? *reinterpret_cast<const float4*>(rp + l * FB_RIGHT + FB_DP2 + 4 * j)
                            : make_float4(Rt[4 * j], Rt[4 * j + 1], Rt[4 * j + 2], Rt[4 * j + 3]);
        part_b2[4 * j] += v.x;
        part_b2[4 * j + 1] += v.y;
        part_b2[4 * j + 2] += v.z;
        part_b2[4 * j + 3] += v.w;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc_b1[e] += part_b1[e];
#pragma unroll
    for (int j = 0; j < FB_NC; ++j) acc[e][j] += part[e][j];
  }
#pragma unroll
  for (int j = 0; j < FB_NC; ++j) acc_b2[j] += part_b2[j];
}

// VJP of one evaluation k = contract(mlp(y), dx) for the cotangent u of k,
// for lane l by its group: dy and ddx (the same bits in every thread of the
// group), and the evaluation's weight gradients, summed over the block's
// lanes, added to the tiles.  Every thread of the block calls it (lanes
// past the batch with zero state and cotangent).
template <int R, bool MX>
__device__ __forceinline__ void fb_vjp(const FbShared& s, int l, int r, const float (&u)[FB_H],
                                       const float (&y)[FB_H], const float (&dx)[FB_C],
                                       float (&dy)[FB_H], float (&ddx)[FB_C], FbTile<R>& t) {
  float g[FB_CH];
  fb_eval<MX, true>(s, s.h1 + l * s.S, r, y, g);
  float dp2[FB_CH];
#pragma unroll
  for (int i = 0; i < FB_C; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int h = 0; h < FB_H; ++h) {
      const int q = i * FB_H + h;
      acc += u[h] * g[q];
      dp2[q] = (u[h] * dx[i]) * (1.f - g[q] * g[q]);
    }
    ddx[i] = acc;
  }
  // This thread's float4s of the lane's right operands: dp2 and y rounded
  // as the products take them (float4s 0-7), the unrounded dp2 (8-13, MX).
  float4* right = reinterpret_cast<float4*>(s.right + l * FB_RIGHT);
  if (MX) {
#pragma unroll
    for (int j = 0; j < FB_CH / 4; ++j) {
      if ((FB_DP2 / 4 + j) % FB_G == r)
        right[FB_DP2 / 4 + j] =
            make_float4(dp2[4 * j], dp2[4 * j + 1], dp2[4 * j + 2], dp2[4 * j + 3]);
    }
#pragma unroll
    for (int q = 0; q < FB_CH; ++q) dp2[q] = mx_round<MX>(dp2[q]);
  }
#pragma unroll
  for (int j = 0; j < FB_CH / 4; ++j) {
    if (j % FB_G == r)
      right[j] = make_float4(dp2[4 * j], dp2[4 * j + 1], dp2[4 * j + 2], dp2[4 * j + 3]);
  }
#pragma unroll
  for (int j = 0; j < FB_H / 4; ++j) {
    if ((FB_CH / 4 + j) % FB_G == r)
      right[FB_CH / 4 + j] = make_float4(mx_round<MX>(y[4 * j]), mx_round<MX>(y[4 * j + 1]),
                                         mx_round<MX>(y[4 * j + 2]), mx_round<MX>(y[4 * j + 3]));
  }
#pragma unroll
  for (int h = 0; h < FB_H; ++h) dy[h] = 0.f;
  const float* h1 = s.h1 + l * s.S;
  float* dp1 = s.dp1 + l * s.S;
#pragma unroll 2
  for (int w = r; w < s.rows; w += FB_G) {
    const float* rec = s.rec + w * FB_REC;
    const float4* r2 = reinterpret_cast<const float4*>(rec + FB_H);
    float dh = 0.f;
#pragma unroll
    for (int j = 0; j < FB_CH / 4; ++j) {
      const float4 v = r2[j];
      dh = fmaf(v.x, dp2[4 * j], dh);
      dh = fmaf(v.y, dp2[4 * j + 1], dh);
      dh = fmaf(v.z, dp2[4 * j + 2], dh);
      dh = fmaf(v.w, dp2[4 * j + 3], dh);
    }
    const float p = h1[w] > 0.f ? dh : 0.f;
    dp1[w] = p;
    const float pr = mx_round<MX>(p);
    const float4 a0 = *reinterpret_cast<const float4*>(rec);
    const float4 a1 = *reinterpret_cast<const float4*>(rec + 4);
    dy[0] = fmaf(a0.x, pr, dy[0]);
    dy[1] = fmaf(a0.y, pr, dy[1]);
    dy[2] = fmaf(a0.z, pr, dy[2]);
    dy[3] = fmaf(a0.w, pr, dy[3]);
    dy[4] = fmaf(a1.x, pr, dy[4]);
    dy[5] = fmaf(a1.y, pr, dy[5]);
    dy[6] = fmaf(a1.z, pr, dy[6]);
    dy[7] = fmaf(a1.w, pr, dy[7]);
  }
  fb_group_sum(dy);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < R; ++c) fb_reduce<MX>(s, l, r, c, t.w[c], t.b1[c], t.b2);
  __syncthreads();
}

// One substep from z, all stages, in place, by the lane's group; with ys,
// only the stage inputs ys[0 .. S-1] (the last stage is not evaluated) and
// z is left as it was.
template <bool MX>
__device__ __forceinline__ void fb_substep(const FbWeights& s, int r, const Tableau& tab,
                                           int step, double dt, const float (&sb)[FB_C],
                                           const float (&sc)[FB_C], const float (&sd)[FB_C],
                                           float (&z)[FB_H], float (*ys)[FB_H]) {
  float znew[FB_H], k[FB_H];
#pragma unroll
  for (int h = 0; h < FB_H; ++h) {
    znew[h] = z[h];
    k[h] = 0.f;
  }
  for (int st = 0; st < tab.n_stages; ++st) {
    float y[FB_H];
#pragma unroll
    for (int h = 0; h < FB_H; ++h) y[h] = st ? z[h] + tab.a_dt[st] * k[h] : z[h];
    if (ys) {
#pragma unroll
      for (int h = 0; h < FB_H; ++h) ys[st][h] = y[h];
      if (st + 1 == tab.n_stages) break;
    }
    float dx[FB_C], g[FB_CH];
    control_derivative<FB_C>(sb, sc, sd, stage_fraction(tab, step, st, dt), dx);
    fb_eval<MX, false>(s, nullptr, r, y, g);
    contract<FB_H, FB_C>(g, dx, k);
    if (tab.c_dt[st] != 0.f) {
#pragma unroll
      for (int h = 0; h < FB_H; ++h) znew[h] += tab.c_dt[st] * k[h];
    }
  }
  if (!ys) {
#pragma unroll
    for (int h = 0; h < FB_H; ++h) z[h] = znew[h];
  }
}

// ---------------------------------------------------------------------------
// Specialised forward (H 8, C 3): the backward's group of FB_G threads per
// lane, blocks of FF_LANES lanes that share one copy of the weights, as
// many blocks as the SMs hold at once (blocks stride over the lane groups
// beyond that).
//
// The lane's chain (z, the stage inputs and k) runs replicated in its
// group's threads, in registers; each evaluation is fb_eval, thread r
// owning the hidden rows w = r (mod FB_G), the second layer's sums scattered
// and gathered by shuffle butterflies, so every thread of the group holds
// the same bits of g and of the state, and the forward's stage values are
// the backward's recompute's.  In the bfloat16 mode y and each thread's own
// h1 are rounded where fb_eval rounds them, off the lane's serial chain.
// The block's shared memory holds the weight records and b2 only
// (fb_weight_floats: 18.5 KB at W 128), so many blocks fit an SM.  Thread r
// writes state row h = r of zres and of the requested outputs (H = FB_G);
// the slab rows are read by every thread of the group (one address a group,
// served by L1).

// 8-lane blocks: on an H100 at the flagship, 32-lane blocks took 1.30x as
// long and 16-lane ones up to 2 % longer; 4 threads a lane in 8-, 16- or
// 32-lane blocks gained nothing (PERF.md).
constexpr int FF_LANES = 8;  // lanes per block of the forward
constexpr int FF_THREADS = FF_LANES * FB_G;
static_assert(FB_H == FB_G, "thread r of a group writes state row r");

template <typename T, bool MX>
__global__ void __launch_bounds__(FF_THREADS)
    fwd_group_kernel(const T* __restrict__ ct, const float* __restrict__ z0t,
                     const float* __restrict__ w1t, const float* __restrict__ b1,
                     const float* __restrict__ w2t, const float* __restrict__ b2,
                     const int* __restrict__ slot, float* __restrict__ out,
                     float* __restrict__ zres, int B, int n, int W, int m, double dt,
                     Tableau tab) {
  extern __shared__ float4 ff_smem[];
  const FbWeights s(reinterpret_cast<float*>(ff_smem), W);
  fb_load_field(s, w1t, b1, w2t, b2, W);
  __syncthreads();

  const int l = threadIdx.x / FB_G, r = threadIdx.x % FB_G;
  for (int grp = blockIdx.x; grp < (B + FF_LANES - 1) / FF_LANES; grp += gridDim.x) {
    const int lane = grp * FF_LANES + l;
    const bool live = lane < B;
    float z[FB_H];
#pragma unroll
    for (int h = 0; h < FB_H; ++h) z[h] = live ? z0t[(size_t)h * B + lane] : 0.f;
    for (int j = 0; j < n; ++j) {
      float sb[FB_C], sc[FB_C], sd[FB_C];
      load_slab<FB_H, FB_C, T>(ct, j, B, lane, live, sb, sc, sd);
      for (int step = 0; step < m; ++step)
        fb_substep<MX>(s, r, tab, step, dt, sb, sc, sd, z, nullptr);
      if (!live) continue;
      const int sl = slot[j];
#pragma unroll
      for (int h = 0; h < FB_H; ++h) {
        if (h != r) continue;
        zres[((size_t)j * FB_H + h) * B + lane] = z[h];
        if (sl >= 0) out[((size_t)sl * FB_H + h) * B + lane] = z[h];
      }
    }
  }
}

// Writes the thread's tiles into the block's slice of the partials.
template <int R>
__device__ void fb_store(const FbTile<R>& t, int k, int r, int W, float* __restrict__ dw1p,
                         float* __restrict__ db1p, float* __restrict__ dw2p,
                         float* __restrict__ db2p) {
  const size_t blk = blockIdx.x;
  const int col = r * FB_NC;
#pragma unroll
  for (int c = 0; c < R; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int w = c * FB_CHUNK + 4 * k + e;
      if (w >= W) continue;
      float* row = col < FB_CH ? dw2p + (blk * W + w) * FB_CH + col
                               : dw1p + (blk * W + w) * FB_H + (col - FB_CH);
#pragma unroll
      for (int j = 0; j < FB_NC; ++j) row[j] = t.w[c][e][j];
      if (col == FB_CH) db1p[blk * W + w] = t.b1[c][e];
    }
  }
  if (k == 0 && col < FB_CH) {
#pragma unroll
    for (int j = 0; j < FB_NC; ++j) db2p[blk * FB_CH + col + j] = t.b2[j];
  }
}

template <int R, typename T, bool MX>
__global__ void __launch_bounds__(FB_THREADS)
    bwd_group_kernel(const T* __restrict__ ct, const float* __restrict__ zres,
                     const float* __restrict__ z0t, const float* __restrict__ gz,
                     const float* __restrict__ w1t, const float* __restrict__ b1,
                     const float* __restrict__ w2t, const float* __restrict__ b2,
                     const int* __restrict__ slot, T* __restrict__ dct,
                     float* __restrict__ dz0, float* __restrict__ dw1p,
                     float* __restrict__ db1p, float* __restrict__ dw2p,
                     float* __restrict__ db2p, int B, int n, int W, int m, double dt,
                     Tableau tab) {
  extern __shared__ float4 fb_smem[];
  const FbShared s(reinterpret_cast<float*>(fb_smem), W);
  fb_load_field(s, w1t, b1, w2t, b2, W);
  FbTile<R> t;
#pragma unroll
  for (int c = 0; c < R; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      t.b1[c][e] = 0.f;
#pragma unroll
      for (int j = 0; j < FB_NC; ++j) t.w[c][e][j] = 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < FB_NC; ++j) t.b2[j] = 0.f;
  __syncthreads();

  const int l = threadIdx.x / FB_G, r = threadIdx.x % FB_G;
  const int S = tab.n_stages;
  for (int grp = blockIdx.x; grp < (B + FB_LANES - 1) / FB_LANES; grp += gridDim.x) {
    const int lane = grp * FB_LANES + l;
    const bool live = lane < B;
    float lam[FB_H];
#pragma unroll
    for (int h = 0; h < FB_H; ++h) lam[h] = 0.f;
    float zs[MAX_SUBSTEPS][FB_H];

    for (int jr = 0; jr < n; ++jr) {
      const int j = n - 1 - jr;
      // Fold in the cotangent of a requested knot at this interval's end.
      const int sl = slot[j];
      if (live && sl >= 0) {
#pragma unroll
        for (int h = 0; h < FB_H; ++h) lam[h] += gz[((size_t)sl * FB_H + h) * B + lane];
      }
      float sb[FB_C], sc[FB_C], sd[FB_C];
      load_slab<FB_H, FB_C, T>(ct, j, B, lane, live, sb, sc, sd);
      // Interval j starts from knot j: z0 or the residual of interval j - 1.
#pragma unroll
      for (int h = 0; h < FB_H; ++h) {
        float v = 0.f;
        if (live)
          v = j == 0 ? z0t[(size_t)h * B + lane] : zres[((size_t)(j - 1) * FB_H + h) * B + lane];
        zs[0][h] = v;
      }
      // Recompute the substep chain z_0 .. z_{m-1}.
      for (int step = 0; step + 1 < m; ++step) {
        float z[FB_H];
#pragma unroll
        for (int h = 0; h < FB_H; ++h) z[h] = zs[step][h];
        fb_substep<MX>(s, r, tab, step, dt, sb, sc, sd, z, nullptr);
#pragma unroll
        for (int h = 0; h < FB_H; ++h) zs[step + 1][h] = z[h];
      }

      float acc_b[FB_C], acc_c[FB_C], acc_d[FB_C];
#pragma unroll
      for (int i = 0; i < FB_C; ++i) acc_b[i] = acc_c[i] = acc_d[i] = 0.f;
      for (int step = m - 1; step >= 0; --step) {
        float ys[MAX_STAGES][FB_H];
        {
          float z[FB_H];
#pragma unroll
          for (int h = 0; h < FB_H; ++h) z[h] = zs[step][h];
          fb_substep<MX>(s, r, tab, step, dt, sb, sc, sd, z, ys);
        }
        float v[MAX_STAGES][FB_H];
        for (int st = S - 1; st >= 0; --st) {
          float u[FB_H], y[FB_H], dy[FB_H], dx[FB_C], ddx[FB_C];
#pragma unroll
          for (int h = 0; h < FB_H; ++h) {
            float uh = tab.c_dt[st] != 0.f ? tab.c_dt[st] * lam[h] : 0.f;
            if (st + 1 < S) uh += tab.a_dt[st + 1] * v[st + 1][h];
            u[h] = uh;
            y[h] = ys[st][h];
          }
          const float fr = stage_fraction(tab, step, st, dt);
          control_derivative<FB_C>(sb, sc, sd, fr, dx);
          fb_vjp<R, MX>(s, l, r, u, y, dx, dy, ddx, t);
#pragma unroll
          for (int i = 0; i < FB_C; ++i) {
            acc_b[i] += ddx[i];
            acc_c[i] += fr * ddx[i];
            acc_d[i] += (fr * fr) * ddx[i];
          }
#pragma unroll
          for (int h = 0; h < FB_H; ++h) v[st][h] = dy[h];
        }
        for (int st = 0; st < S; ++st) {
#pragma unroll
          for (int h = 0; h < FB_H; ++h) lam[h] += v[st][h];
        }
      }
      if (live && r == 0) {
        T* row = dct + (size_t)j * 3 * FB_C * B + lane;
#pragma unroll
        for (int i = 0; i < FB_C; ++i) {
          store_as(row + (size_t)i * B, acc_b[i]);
          store_as(row + (size_t)(FB_C + i) * B, acc_c[i]);
          store_as(row + (size_t)(2 * FB_C + i) * B, acc_d[i]);
        }
      }
    }
    if (live && r == 0) {
#pragma unroll
      for (int h = 0; h < FB_H; ++h) dz0[(size_t)h * B + lane] = lam[h];
    }
  }
  fb_store<R>(t, l, r, W, dw1p, db1p, dw2p, db2p);
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

bool specialised_fits(int H, int C, int W) {
  return H == FB_H && C == FB_C && fb_chunks(W) <= FB_MAX_CHUNKS &&
         sizeof(float) * fb_smem_floats(W) <= MAX_SMEM;
}

template <typename T, bool MX>
using FbKernel = decltype(&bwd_group_kernel<1, T, MX>);

template <typename T, bool MX>
FbKernel<T, MX> fb_kernel(int W) {
  switch (fb_chunks(W)) {
    case 1: return bwd_group_kernel<1, T, MX>;
    case 2: return bwd_group_kernel<2, T, MX>;
    case 3: return bwd_group_kernel<3, T, MX>;
    default: return bwd_group_kernel<4, T, MX>;
  }
}

// A launch of the forward or the backward for some shapes.
struct LaunchPlan {
  int variant, blocks, threads, lanes, group;  // lanes a block walks at once; threads per lane
  int resident, sms;                           // blocks an SM holds; SMs
  size_t bytes;                                // shared memory of a block
  bool acc_smem;                               // generic backward: partials in shared memory
};

int card_sms(LaunchPlan& p) {
  int dev = 0, rc = (int)cudaGetDevice(&dev);
  if (!rc) rc = (int)cudaDeviceGetAttribute(&p.sms, cudaDevAttrMultiProcessorCount, dev);
  return rc;
}

// The specialised forward runs as many blocks as the SMs hold at once, at
// most one per group of FF_LANES lanes (blocks stride over the rest); the
// generic one a block per lane.
template <typename T, bool MX>
int forward_plan(LaunchPlan& p, int B, int H, int C, int W, int m, int n_stages,
                 int force_generic) {
  p.variant = !force_generic && specialised_fits(H, C, W) ? SPECIALISED : GENERIC;
  p.acc_smem = false;
  const int rc = card_sms(p);
  if (rc) return rc;
  if (p.variant == SPECIALISED) {
    p.threads = FF_THREADS;
    p.lanes = FF_LANES;
    p.group = FB_G;
    p.bytes = sizeof(float) * fb_weight_floats(W);
    const int err = resident_blocks(fwd_group_kernel<T, MX>, p.threads, p.bytes, p.resident);
    if (err) return err;
    if (p.resident < 1) return BAD_VARIANT;
    p.blocks = std::min<long>((B + FF_LANES - 1) / FF_LANES, (long)p.resident * p.sms);
    return 0;
  }
  p.threads = p.group = GEN_THREADS;
  p.lanes = 1;
  p.bytes = sizeof(float) * GenLayout(H, C, W, m, n_stages, false, false).total;
  if (p.bytes > MAX_SMEM) return BAD_ARGUMENT;
  p.blocks = B;
  return resident_blocks(gen_fwd_kernel<T, MX>, p.threads, p.bytes, p.resident);
}

// The forward launch of one mode, as forward_plan plans it: T the slab
// storage, MX the operand rounding.
template <typename T, bool MX>
int forward_mode(const void* ct, const float* z0t, const float* w1t, const float* b1,
                 const float* w2t, const float* b2, const int* slot, float* out,
                 float* zres, int B, int n, int H, int C, int W, int m, double dt,
                 const Tableau& tab, int variant, int blocks, cudaStream_t st) {
  LaunchPlan p;
  const int rc = forward_plan<T, MX>(p, B, H, C, W, m, tab.n_stages, variant == GENERIC);
  if (rc) return rc;
  if (p.variant != variant || p.blocks != blocks) return BAD_ARGUMENT;
  const T* slabs = static_cast<const T*>(ct);
  if (variant == SPECIALISED) {
    fwd_group_kernel<T, MX><<<p.blocks, p.threads, p.bytes, st>>>(
        slabs, z0t, w1t, b1, w2t, b2, slot, out, zres, B, n, W, m, dt, tab);
  } else {
    gen_fwd_kernel<T, MX><<<p.blocks, p.threads, p.bytes, st>>>(
        slabs, z0t, GenField{w1t, b1, w2t, b2, H, C, W}, slot, out, zres, B, n, m, dt, tab);
  }
  return (int)cudaGetLastError();
}

// The specialised variant runs as many blocks as the SMs hold at once, at
// most one per group of FB_LANES lanes (blocks stride over the rest); the
// generic one a block per lane, capped by its partials.
template <typename T, bool MX>
int backward_plan(LaunchPlan& p, int B, int H, int C, int W, int m, int n_stages,
                  int force_generic) {
  p.variant = !force_generic && specialised_fits(H, C, W) ? SPECIALISED : GENERIC;
  int rc = card_sms(p);
  if (rc) return rc;
  if (p.variant == SPECIALISED) {
    p.acc_smem = false;
    p.threads = FB_THREADS;
    p.lanes = FB_LANES;
    p.group = FB_G;
    p.bytes = sizeof(float) * fb_smem_floats(W);
    rc = resident_blocks(fb_kernel<T, MX>(W), p.threads, p.bytes, p.resident);
    if (rc) return rc;
    if (p.resident < 1) return BAD_VARIANT;
    p.blocks = std::min<long>((B + FB_LANES - 1) / FB_LANES, (long)p.resident * p.sms);
    return 0;
  }
  p.threads = p.group = GEN_THREADS;
  p.lanes = 1;
  p.acc_smem =
      sizeof(float) * GenLayout(H, C, W, m, n_stages, true, true).total <= MAX_SMEM;
  p.bytes = sizeof(float) * GenLayout(H, C, W, m, n_stages, true, p.acc_smem).total;
  if (p.bytes > MAX_SMEM) return BAD_ARGUMENT;
  p.blocks = gen_backward_blocks(B, H, C, W);
  return resident_blocks(gen_bwd_kernel<T, MX>, p.threads, p.bytes, p.resident);
}

// The backward launch of one mode, as backward_plan plans it.
template <typename T, bool MX>
int backward_mode(const void* ct, const float* zres, const float* z0t,
                  const float* gz, const float* w1t, const float* b1,
                  const float* w2t, const float* b2, const int* slot, void* dct,
                  float* dz0, float* dw1p, float* db1p, float* dw2p, float* db2p,
                  int B, int n, int H, int C, int W, int m, double dt,
                  const Tableau& tab, int variant, int blocks, cudaStream_t st) {
  LaunchPlan p;
  const int rc = backward_plan<T, MX>(p, B, H, C, W, m, tab.n_stages, variant == GENERIC);
  if (rc) return rc;
  if (p.variant != variant || p.blocks != blocks) return BAD_ARGUMENT;
  const T* slabs = static_cast<const T*>(ct);
  T* dslabs = static_cast<T*>(dct);
  if (variant == SPECIALISED) {
    fb_kernel<T, MX>(W)<<<p.blocks, p.threads, p.bytes, st>>>(
        slabs, zres, z0t, gz, w1t, b1, w2t, b2, slot, dslabs, dz0, dw1p, db1p, dw2p, db2p, B,
        n, W, m, dt, tab);
    return (int)cudaGetLastError();
  }
  const cudaError_t err = set_smem(gen_bwd_kernel<T, MX>, p.bytes);
  if (err != cudaSuccess) return (int)err;
  gen_bwd_kernel<T, MX><<<p.blocks, p.threads, p.bytes, st>>>(
      slabs, zres, z0t, gz, GenField{w1t, b1, w2t, b2, H, C, W}, slot, dslabs, dz0, dw1p,
      db1p, dw2p, db2p, B, n, m, dt, tab, p.acc_smem);
  return (int)cudaGetLastError();
}

bool plan_args_ok(int B, int H, int C, int W, int m, int n_stages, int mode) {
  return B >= 1 && H >= 1 && C >= 1 && W >= 1 && m >= 1 && m <= MAX_SUBSTEPS &&
         n_stages >= 1 && n_stages <= MAX_STAGES && (mode == 0 || mode == 1);
}

void write_plan(const LaunchPlan& p, long* out) {
  const long values[] = {p.variant, p.blocks, p.threads, p.lanes,
                         p.group, p.resident, p.sms, (long)p.bytes};
  for (int i = 0; i < 8; ++i) out[i] = values[i];
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

// The forward launch for these shapes in this mode, into out[8]: the
// variant, blocks, threads per block, lanes a block walks at once, threads
// per lane, blocks an SM holds, SMs, shared bytes of a block.
int ff_forward_plan(int B, int H, int C, int W, int m, int n_stages, int force_generic,
                    int mode, long* out) {
  if (!plan_args_ok(B, H, C, W, m, n_stages, mode)) return BAD_ARGUMENT;
  LaunchPlan p;
  const int rc = mode == 1 ? forward_plan<__nv_bfloat16, true>(p, B, H, C, W, m, n_stages,
                                                              force_generic)
                           : forward_plan<float, false>(p, B, H, C, W, m, n_stages,
                                                        force_generic);
  if (!rc) write_plan(p, out);
  return rc;
}

// The backward launch, as ff_forward_plan reports the forward's; its blocks
// are the leading size of the weight partials.
int ff_backward_plan(int B, int H, int C, int W, int m, int n_stages, int force_generic,
                     int mode, long* out) {
  if (!plan_args_ok(B, H, C, W, m, n_stages, mode)) return BAD_ARGUMENT;
  LaunchPlan p;
  const int rc = mode == 1 ? backward_plan<__nv_bfloat16, true>(p, B, H, C, W, m, n_stages,
                                                               force_generic)
                           : backward_plan<float, false>(p, B, H, C, W, m, n_stages,
                                                         force_generic);
  if (!rc) write_plan(p, out);
  return rc;
}

// mode 0: float32 ct and dct; mode 1: bfloat16 ct and dct, bfloat16
// operands in the stage products (the other pointers are float32 in both).
// blocks: as ff_forward_plan (ff_backward_plan for ff_backward) plans them.
int ff_forward(const void* ct, const float* z0t, const float* w1t,
               const float* b1, const float* w2t, const float* b2,
               const int* slot, float* out, float* zres, int B, int n, int H,
               int C, int W, int m, double dt, int n_stages,
               const double* alpha, const double* a, const double* c,
               int variant, int mode, int blocks, void* stream) {
  Tableau tab;
  const int rc = check_call(B, n, H, C, W, m, variant, mode, n_stages, alpha, a, c, dt, &tab);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 1)
    return forward_mode<__nv_bfloat16, true>(ct, z0t, w1t, b1, w2t, b2, slot, out,
                                             zres, B, n, H, C, W, m, dt, tab,
                                             variant, blocks, st);
  return forward_mode<float, false>(ct, z0t, w1t, b1, w2t, b2, slot, out, zres, B,
                                    n, H, C, W, m, dt, tab, variant, blocks, st);
}

int ff_backward(const void* ct, const float* zres, const float* z0t,
                const float* gz, const float* w1t, const float* b1,
                const float* w2t, const float* b2, const int* slot,
                void* dct, float* dz0, float* dw1p, float* db1p, float* dw2p,
                float* db2p, int B, int n, int H, int C, int W, int m,
                double dt, int n_stages, const double* alpha, const double* a,
                const double* c, int variant, int mode, int blocks, void* stream) {
  Tableau tab;
  const int rc = check_call(B, n, H, C, W, m, variant, mode, n_stages, alpha, a, c, dt, &tab);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 1)
    return backward_mode<__nv_bfloat16, true>(ct, zres, z0t, gz, w1t, b1, w2t, b2,
                                              slot, dct, dz0, dw1p, db1p, dw2p,
                                              db2p, B, n, H, C, W, m, dt, tab,
                                              variant, blocks, st);
  return backward_mode<float, false>(ct, zres, z0t, gz, w1t, b1, w2t, b2, slot, dct,
                                     dz0, dw1p, db1p, dw2p, db2p, B, n, H, C, W, m,
                                     dt, tab, variant, blocks, st);
}

}  // extern "C"
