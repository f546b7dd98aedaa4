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
// below that: compute-bound, the forward on the tensor cores (three TF32
// passes, 0.161 ms at their rate), the backward on the CUDA cores.
//
// Two variants compute the same function; fr_variant picks one from the
// shapes, and every shape inside the JAX package's caps (W <= 512,
// C*H <= 512, 3*C <= 16, m <= 8) launches one of them.
//
// Specialised variant (H 8, C 3, every width of the caps, W <= 512).  The
// forward ("Specialised forward" below) runs a warp per 16 batch lanes and
// the stage products on the tensor cores (mma.sync m16n8k8 in TF32, three
// passes for float32 accuracy), in blocks of four warps that share one copy
// of the weights, staged in fragment order; a batch of 16384 is 1024 warps.
// The backward ("Specialised backward" below) runs one thread per lane, in
// blocks of RB_LANES lanes that share one copy of the weights, as many as
// the SMs hold at once (at config 5, 128 blocks of 4 warps, one wave), and
// reduces the weight gradients over each block's lanes in register tiles,
// written once as per-block partials and summed after the launch
// (deterministic, no float atomics).  Its recompute runs the evaluations on
// the CUDA cores in float32, so it rounds otherwise than the forward did:
// the inverse map starts from each interval's stored state, so the two
// roundings never accumulate across intervals.
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
// dw2p (blocks, W, C*H), db2p (blocks, C*H), with blocks from
// fr_backward_plan(...).

#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "cde_generic.cuh"
#include "cde_stage.cuh"

namespace {

constexpr int MAX_SUBSTEPS = 8;

// The interval's fraction after s substeps of dt, rounded once.
__device__ __forceinline__ float fraction(int s, double dt) {
  return (float)((double)s * dt);
}

// ---------------------------------------------------------------------------
// Specialised forward (H 8, C 3, W <= 512): a warp per 16 batch lanes, the
// stage products on the tensor cores.
//
// Replaces the TPU kernel's walk (fused_pallas.py::_rev_fwd_kernel), which
// runs these products on its matrix unit (_dot), float32 as several passes.
// What bounds it: the two products of every evaluation, 2 W H (1 + C) flops
// a lane.  As float32 on the CUDA cores, one thread a lane issues a shared
// load per few FMAs, and at config 5 (B 16384, 99 intervals, m 1, W 128)
// the issue slots set the pace (1.14 ms against the FMAs' 0.40).  Here the
// products run as mma.sync.m16n8k8 in TF32: three passes, lo.hi, hi.lo and
// hi.hi, with each float32 operand split as hi = tf32(x), lo = tf32(x -
// hi), summed in float32, the two cross terms in an accumulator of their
// own that joins hi.hi's at the end (smallest terms first): the float32
// products to about 2^-21, as the TPU kernel's multi-pass f32 dots.  Apart,
// the two accumulators are two dependent chains of MMAs where one would be
// three in a row, which the card runs slower (PERF.md).  Three times
// the 26.6 GFLOP at 495 TFLOP/s TF32 is 0.161 ms.
//
// The tile.  A warp's 16 lanes are the M of the products; a chunk of 8
// hidden units is the K of the first (N = 8 of them from the H = 8 state
// components) and of the second (N = 8 state components per channel, three
// n-tiles).  Thread (g = lane / 4, t = lane % 4) holds, in the accumulator
// layout, rows g and g + 8 (two batch lanes) at columns 2t and 2t + 1.  An
// accumulator fragment read as an A fragment with k-index t standing for
// column 2t and t + 4 for 2t + 1 (as_a) needs no shuffle: the state (the
// first product's A, K = H = 8), each chunk's h1 (the first product's C,
// the second's A) and g (the second's C) all stay in the registers that
// hold them, and dX/dt . g and the step are thread-local.  The contraction
// index is permuted to match when the block stages the weights: W1's
// columns and W2's rows within a chunk, both in B-fragment order, split
// into hi and lo once per block (tc_load_field).  W is padded with zero
// weights to a multiple of 8.  Lanes past B run on zeros and are not
// written.  Blocks of TC_WARPS warps share one copy of the weights: 2 KB a
// chunk, 32 KB at W 128, 130 KB at W 512.

constexpr int TC_H = 8, TC_C = 3, TC_CH = TC_H * TC_C;
constexpr int TC_LANES = 16;                    // batch lanes a warp: the M of a product
constexpr int TC_WARPS = 4;                     // warps a block
constexpr int TC_BLOCK = TC_LANES * TC_WARPS;   // batch lanes a block
constexpr int TC_K = 8;                         // hidden units a chunk
constexpr int TC_FRAGS = 4;                     // B fragments a chunk: W1's, W2's of 3 channels

__host__ __device__ inline int tc_chunks(int W) { return (W + TC_K - 1) / TC_K; }

__host__ __device__ inline size_t tc_smem_bytes(int W) {
  return sizeof(float4) * (size_t)tc_chunks(W) * TC_FRAGS * 32 +
         sizeof(float) * ((size_t)tc_chunks(W) * TC_K + TC_CH);
}

__device__ __forceinline__ uint32_t tf32_of(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo up to 2^-22 |x|: hi rounds x to TF32, lo what hi missed.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_of(x);
  lo = tf32_of(x - __uint_as_float(hi));
}

// d += a b on one 16 x 8 x 8 tile, fragments as PTX lays them out.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], float b0,
                                         float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

// The three passes of d += a b, b as staged (hi0, hi1, lo0, lo1): the
// cross terms lo.hi and hi.lo into x, hi.hi into d; the caller adds x to d
// once every pass is in.
__device__ __forceinline__ void mma3(float (&d)[4], float (&x)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], const float4 b) {
  mma_tf32(x, alo, b.x, b.y);
  mma_tf32(x, ahi, b.z, b.w);
  mma_tf32(d, ahi, b.x, b.y);
}

// The A fragments (hi, lo) of an operand held as an accumulator fragment
// (c: rows g, g + 8 at columns 2t, 2t + 1): a0 row g k t, a1 row g + 8 k t,
// a2 row g k t + 4, a3 row g + 8 k t + 4, with k t column 2t and k t + 4
// column 2t + 1.
__device__ __forceinline__ void as_a(const float (&c)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  tf32_split(c[0], hi[0], lo[0]);
  tf32_split(c[2], hi[1], lo[1]);
  tf32_split(c[1], hi[2], lo[2]);
  tf32_split(c[3], hi[3], lo[3]);
}

// The block's weights in fragment order: frag[(c * TC_FRAGS + j) * 32 + lane]
// holds the B fragment (b0, b1 for k t and t + 4, column g) of chunk c of
// W1 (j = 0: B[k][n] = w1t[8c + n][perm k]) or of channel j - 1's W2 (B[k][n]
// = w2t[8 (j - 1) + n][8c + perm k]), perm t = 2t, perm t + 4 = 2t + 1, as
// (hi0, hi1, lo0, lo1); b1s[w], zero past W; b2s[q].
__device__ void tc_load_field(float4* frag, float* b1s, float* b2s, const float* __restrict__ w1t,
                              const float* __restrict__ b1, const float* __restrict__ w2t,
                              const float* __restrict__ b2, int W) {
  const int chunks = tc_chunks(W);
  for (int e = threadIdx.x; e < chunks * TC_FRAGS * 32; e += blockDim.x) {
    const int lane = e & 31, j = (e >> 5) % TC_FRAGS, c = (e >> 5) / TC_FRAGS;
    const int g = lane >> 2, t = lane & 3;
    float v0 = 0.f, v1 = 0.f;
    if (j == 0) {
      const int w = c * TC_K + g;
      if (w < W) {
        v0 = w1t[w * TC_H + 2 * t];
        v1 = w1t[w * TC_H + 2 * t + 1];
      }
    } else {
      const float* row = w2t + (size_t)((j - 1) * TC_H + g) * W;
      const int w = c * TC_K + 2 * t;
      if (w < W) v0 = row[w];
      if (w + 1 < W) v1 = row[w + 1];
    }
    uint32_t h0, l0, h1, l1;
    tf32_split(v0, h0, l0);
    tf32_split(v1, h1, l1);
    frag[e] = make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                          __uint_as_float(l1));
  }
  for (int i = threadIdx.x; i < chunks * TC_K; i += blockDim.x) b1s[i] = i < W ? b1[i] : 0.f;
  for (int i = threadIdx.x; i < TC_CH; i += blockDim.x) b2s[i] = b2[i];
}

// k = f(y) along dx for the warp's 16 lanes: this thread's y and k at
// positions r (r / 2: lane g or g + 8; r % 2: component 2t or 2t + 1), dx
// of its two lanes.
__device__ __forceinline__ void tc_field(const float4* __restrict__ frag,
                                         const float* __restrict__ b1s,
                                         const float* __restrict__ b2s, int chunks,
                                         const float (&y)[4], const float (&dx)[2][TC_C],
                                         float (&k)[4]) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  uint32_t yhi[4], ylo[4];
  as_a(y, yhi, ylo);
  float G[TC_C][4], X[TC_C][4];  // hi.hi from b2; the cross terms
#pragma unroll
  for (int i = 0; i < TC_C; ++i) {
    const float2 bias = *reinterpret_cast<const float2*>(b2s + i * TC_H + 2 * t);
    G[i][0] = G[i][2] = bias.x;
    G[i][1] = G[i][3] = bias.y;
#pragma unroll
    for (int r = 0; r < 4; ++r) X[i][r] = 0.f;
  }
  const float4* f = frag + lane;
#pragma unroll 4
  for (int c = 0; c < chunks; ++c, f += TC_FRAGS * 32) {
    const float2 bias = *reinterpret_cast<const float2*>(b1s + c * TC_K + 2 * t);
    float h[4] = {bias.x, bias.y, bias.x, bias.y}, hx[4] = {0.f, 0.f, 0.f, 0.f};
    mma3(h, hx, yhi, ylo, f[0]);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      h[r] += hx[r];
      h[r] = (h[r] < 0.f) ? 0.f : h[r];
    }
    uint32_t hhi[4], hlo[4];
    as_a(h, hhi, hlo);
#pragma unroll
    for (int i = 0; i < TC_C; ++i) mma3(G[i], X[i], hhi, hlo, f[(1 + i) * 32]);
  }
#pragma unroll
  for (int i = 0; i < TC_C; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) G[i][r] += X[i][r];
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float(&d)[TC_C] = dx[r >> 1];
    float acc = tanhf(G[0][r]) * d[0];
#pragma unroll
    for (int i = 1; i < TC_C; ++i) acc += tanhf(G[i][r]) * d[i];
    k[r] = acc;
  }
}

__global__ void __launch_bounds__(TC_WARPS * 32)
    rev_fwd_tc_kernel(const float* __restrict__ ct, const float* __restrict__ z0t,
                      const float* __restrict__ w1t, const float* __restrict__ b1,
                      const float* __restrict__ w2t, const float* __restrict__ b2,
                      float* __restrict__ yres, float* __restrict__ yhres, int B, int n, int W,
                      int m, double dt) {
  extern __shared__ float4 tc_smem[];
  const int chunks = tc_chunks(W);
  float4* frag = tc_smem;
  float* b1s = reinterpret_cast<float*>(tc_smem + chunks * TC_FRAGS * 32);
  float* b2s = b1s + chunks * TC_K;
  tc_load_field(frag, b1s, b2s, w1t, b1, w2t, b2, W);
  __syncthreads();
  const int base = blockIdx.x * TC_BLOCK + (threadIdx.x >> 5) * TC_LANES;
  if (base >= B) return;  // the whole warp: mma.sync needs all its threads
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int row[2] = {base + g, base + g + 8};
  const bool live[2] = {row[0] < B, row[1] < B};
  const float dtf = (float)dt, hdt = (float)(0.5 * dt);

  float y[4], yh[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int h = 2 * t + (r & 1);
    y[r] = yh[r] = live[r >> 1] ? z0t[(size_t)h * B + row[r >> 1]] : 0.f;
  }
  for (int j = 0; j < n; ++j) {
    float sb[2][TC_C], sc[2][TC_C], sd[2][TC_C], dx[2][TC_C], f[4];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      load_slab<TC_H, TC_C>(ct, j, B, row[p], live[p], sb[p], sc[p], sd[p]);
      control_derivative<TC_C>(sb[p], sc[p], sd[p], 0.f, dx[p]);
    }
    tc_field(frag, b1s, b2s, chunks, yh, dx, f);
    for (int s = 0; s < m; ++s) {
      float yn[4], f1[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) yn[r] = 2.f * y[r] - yh[r] + dtf * f[r];
#pragma unroll
      for (int p = 0; p < 2; ++p)
        control_derivative<TC_C>(sb[p], sc[p], sd[p], fraction(s + 1, dt), dx[p]);
      tc_field(frag, b1s, b2s, chunks, yn, dx, f1);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        y[r] = y[r] + hdt * (f[r] + f1[r]);
        yh[r] = yn[r];
        f[r] = f1[r];
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (!live[r >> 1]) continue;
      const size_t at = ((size_t)j * TC_H + 2 * t + (r & 1)) * B + row[r >> 1];
      yres[at] = y[r];
      yhres[at] = yh[r];
    }
  }
}

// ---------------------------------------------------------------------------
// Specialised backward (H 8, C 3): blocks of RB_LANES lanes, one thread per
// lane, as many blocks as the SMs hold at once (one resident wave), the
// weight gradients reduced in register tiles.
//
// The JAX kernel walks a tile of lanes per program and accumulates the
// tile's weight gradients across all intervals as products over the tile's
// lanes (dw1_acc ... db2_acc).  Here a block's RB_LANES lanes are the tile,
// and the block holds one copy of the weights in shared memory.  Per VJP
// each thread runs its lane's evaluation and backward pass, reading weight
// rows as float4 broadcasts, and stages what the weight gradients need: per
// lane dp2 and y (the right operands), and h1 and dp1 for a chunk of up to
// RB_CHUNK weight rows (the left operands; the backward pass recomputes h1,
// 8 FMAs a row, so nothing of the evaluation is kept across the passes).
// Then the block reduces the chunk over its lanes as a product: thread
// (group g = tid % 4, quad k = tid / 4) owns a register tile of 4 rows x 8
// columns, of dW2 (g < 3: columns 8g..8g+7, h1 x dp2) or of dW1 (g = 3:
// dp1 x y): three float4 loads and 32 FMAs per lane, into a partial that
// is added to the tile once per VJP.  The tile holds its sums for the
// whole walk and is written once, as the block's partial.  Blocks stride over the lane groups where the grid is
// smaller than their number.  Deterministic: lanes, lane groups and (on
// the host) blocks are summed in a fixed order, without atomics.

constexpr int RB_H = 8, RB_C = 3, RB_CH = RB_C * RB_H;
constexpr int RB_LANES = 128;     // lanes (threads) per block
constexpr int RB_CHUNK = 128;     // weight rows per staged chunk: a quad per tile thread
constexpr int RB_MAX_CHUNKS = 4;  // W <= 512, the JAX kernel's cap
constexpr int RB_RIGHT = 36;      // row stride of the right operands: dp2 (24), y (8), pad
static_assert(RB_CHUNK == RB_LANES, "4 groups x RB_LANES / 4 quads of rows");

__host__ __device__ inline int rb_round4(int W) { return (W + 3) & ~3; }

__host__ __device__ inline int rb_chunks(int W) {
  return (rb_round4(W) + RB_CHUNK - 1) / RB_CHUNK;
}

// Row stride of the left operands: the chunk's rows rounded to an odd
// multiple of 4, so that eight consecutive lanes' float4 stores fall in
// distinct banks.
__host__ __device__ inline int rb_stride(int W) {
  const int rows = rb_round4(W) < RB_CHUNK ? rb_round4(W) : RB_CHUNK;
  return 4 * ((rows / 4) | 1);
}

__host__ __device__ inline size_t rb_smem_floats(int W) {
  return (size_t)rb_round4(W) * (RB_H + RB_CH + 1) + RB_CH +
         2 * (size_t)RB_LANES * rb_stride(W) + (size_t)RB_LANES * RB_RIGHT;
}

// The block's shared memory; every offset is a multiple of 4 floats.
struct RbShared {
  float* w1;     // [W4][8]    w1t, zero rows past W
  float* w2;     // [W4][24]   w2t transposed, zero rows past W
  float* b1;     // [W4]
  float* b2;     // [24]
  float* left;   // [2][RB_LANES][S]  h1, then dp1, of the chunk's rows per lane
  float* right;  // [RB_LANES][RB_RIGHT]  dp2, y per lane
  int W4, S;
  __device__ RbShared(float* base, int W) : W4(rb_round4(W)), S(rb_stride(W)) {
    w1 = base;
    w2 = w1 + W4 * RB_H;
    b1 = w2 + W4 * RB_CH;
    b2 = b1 + W4;
    left = b2 + RB_CH;
    right = left + 2 * RB_LANES * S;
  }
};

__device__ void rb_load_field(const RbShared& s, const float* __restrict__ w1t,
                              const float* __restrict__ b1, const float* __restrict__ w2t,
                              const float* __restrict__ b2, int W) {
  for (int i = threadIdx.x; i < s.W4 * RB_H; i += blockDim.x)
    s.w1[i] = i < W * RB_H ? w1t[i] : 0.f;
  for (int i = threadIdx.x; i < s.W4 * RB_CH; i += blockDim.x) {
    const int w = i / RB_CH, q = i - w * RB_CH;
    s.w2[i] = w < W ? w2t[(size_t)q * W + w] : 0.f;
  }
  for (int i = threadIdx.x; i < s.W4; i += blockDim.x) s.b1[i] = i < W ? b1[i] : 0.f;
  for (int i = threadIdx.x; i < RB_CH; i += blockDim.x) s.b2[i] = b2[i];
}

// h1_w = relu(W1 y + b1)_w, in float32 on the CUDA cores (the forward's
// products ran on the tensor cores, rounding otherwise); a0, a1: row w of W1.
__device__ __forceinline__ float rb_hidden(const RbShared& s, int w, const float (&y)[RB_H],
                                           float4& a0, float4& a1) {
  const float4* r1 = reinterpret_cast<const float4*>(s.w1 + w * RB_H);
  a0 = r1[0];
  a1 = r1[1];
  float a = 0.f;
  a = fmaf(a0.x, y[0], a);
  a = fmaf(a0.y, y[1], a);
  a = fmaf(a0.z, y[2], a);
  a = fmaf(a0.w, y[3], a);
  a = fmaf(a1.x, y[4], a);
  a = fmaf(a1.y, y[5], a);
  a = fmaf(a1.z, y[6], a);
  a = fmaf(a1.w, y[7], a);
  a += s.b1[w];
  return (a < 0.f) ? 0.f : a;
}

// A thread's share of the block's weight gradients.
template <int R>
struct RbTile {
  float w[R][4][8];  // rows RB_CHUNK c + 4k + e; columns 8g + j of dW2 (g < 3), j of dW1 (g = 3)
  float b1[R][4];    // db1 of those rows (g = 3)
  float b2[8];       // db2 columns 8g + j (k = 0, g < 3)
};

// Adds the staged chunk's products over the block's lanes to this thread's
// tile of the chunk (and db2's columns once per VJP): summed over the lanes
// in order into a fresh partial first, so the tile's running sums take one
// addition per VJP rather than one per lane and VJP.
__device__ __forceinline__ void rb_reduce(const RbShared& s, int rows, bool bias2,
                                          float (&acc)[4][8], float (&acc_b1)[4],
                                          float (&acc_b2)[8]) {
  const int g = threadIdx.x & 3, k = threadIdx.x >> 2;
  if (4 * k >= rows) return;
  const float* lp = s.left + (g == 3 ? RB_LANES * s.S : 0) + 4 * k;
  const float* rp = s.right + 8 * g;
  const bool db1 = g == 3, db2 = bias2 && k == 0 && g < 3;
  float part[4][8], part_b1[4], part_b2[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    part_b1[e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) part[e][j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) part_b2[j] = 0.f;
#pragma unroll 2
  for (int l = 0; l < RB_LANES; ++l) {
    const float4 lv = *reinterpret_cast<const float4*>(lp + l * s.S);
    const float4 r0 = *reinterpret_cast<const float4*>(rp + l * RB_RIGHT);
    const float4 r1 = *reinterpret_cast<const float4*>(rp + l * RB_RIGHT + 4);
    const float L[4] = {lv.x, lv.y, lv.z, lv.w};
    const float Rt[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int j = 0; j < 8; ++j) part[e][j] = fmaf(L[e], Rt[j], part[e][j]);
    }
    if (db1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part_b1[e] += L[e];
    }
    if (db2) {
#pragma unroll
      for (int j = 0; j < 8; ++j) part_b2[j] += Rt[j];
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc_b1[e] += part_b1[e];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[e][j] += part[e][j];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) acc_b2[j] += part_b2[j];
}

// One evaluation k = f(y) along dx and its VJP for the cotangent u of k, for
// this thread's lane: k, dy and ddx, and the evaluation's weight gradients,
// summed over the block's lanes, added to the tiles.  Every thread of the
// block calls it (lanes past the batch with zero state and cotangent).
template <int R>
__device__ __forceinline__ void rb_vjp(const RbShared& s, const float (&u)[RB_H],
                                       const float (&y)[RB_H], const float (&dx)[RB_C],
                                       float (&k)[RB_H], float (&dy)[RB_H],
                                       float (&ddx)[RB_C], RbTile<R>& t) {
  const int tid = threadIdx.x;
  float pre2[RB_CH];
#pragma unroll
  for (int q = 0; q < RB_CH; ++q) pre2[q] = 0.f;
#pragma unroll 4
  for (int w = 0; w < s.W4; ++w) {
    float4 a0, a1;
    const float a = rb_hidden(s, w, y, a0, a1);
    const float4* r2 = reinterpret_cast<const float4*>(s.w2 + w * RB_CH);
#pragma unroll
    for (int j = 0; j < RB_CH / 4; ++j) {
      const float4 v = r2[j];
      pre2[4 * j] = fmaf(v.x, a, pre2[4 * j]);
      pre2[4 * j + 1] = fmaf(v.y, a, pre2[4 * j + 1]);
      pre2[4 * j + 2] = fmaf(v.z, a, pre2[4 * j + 2]);
      pre2[4 * j + 3] = fmaf(v.w, a, pre2[4 * j + 3]);
    }
  }
  float g[RB_CH];
#pragma unroll
  for (int q = 0; q < RB_CH; ++q) g[q] = tanhf(pre2[q] + s.b2[q]);
  contract<RB_H, RB_C>(g, dx, k);

  float dp2[RB_CH];
#pragma unroll
  for (int i = 0; i < RB_C; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int h = 0; h < RB_H; ++h) {
      const int q = i * RB_H + h;
      acc += u[h] * g[q];
      dp2[q] = (u[h] * dx[i]) * (1.f - g[q] * g[q]);
    }
    ddx[i] = acc;
  }
  float4* right = reinterpret_cast<float4*>(s.right + tid * RB_RIGHT);
#pragma unroll
  for (int j = 0; j < RB_CH / 4; ++j)
    right[j] = make_float4(dp2[4 * j], dp2[4 * j + 1], dp2[4 * j + 2], dp2[4 * j + 3]);
  right[RB_CH / 4] = make_float4(y[0], y[1], y[2], y[3]);
  right[RB_CH / 4 + 1] = make_float4(y[4], y[5], y[6], y[7]);
#pragma unroll
  for (int h = 0; h < RB_H; ++h) dy[h] = 0.f;

  float4* h1s = reinterpret_cast<float4*>(s.left + tid * s.S);
  float4* dp1s = reinterpret_cast<float4*>(s.left + (RB_LANES + tid) * s.S);
#pragma unroll
  for (int c = 0; c < R; ++c) {
    const int w0 = c * RB_CHUNK;
    const int rows = s.W4 - w0 < RB_CHUNK ? s.W4 - w0 : RB_CHUNK;
    for (int wq = 0; wq < rows; wq += 4) {
      float hq[4], pq[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int w = w0 + wq + e;
        float4 a0, a1;
        const float h = rb_hidden(s, w, y, a0, a1);
        const float4* r2 = reinterpret_cast<const float4*>(s.w2 + w * RB_CH);
        float dh = 0.f;
#pragma unroll
        for (int j = 0; j < RB_CH / 4; ++j) {
          const float4 v = r2[j];
          dh = fmaf(v.x, dp2[4 * j], dh);
          dh = fmaf(v.y, dp2[4 * j + 1], dh);
          dh = fmaf(v.z, dp2[4 * j + 2], dh);
          dh = fmaf(v.w, dp2[4 * j + 3], dh);
        }
        const float p = h > 0.f ? dh : 0.f;
        dy[0] = fmaf(a0.x, p, dy[0]);
        dy[1] = fmaf(a0.y, p, dy[1]);
        dy[2] = fmaf(a0.z, p, dy[2]);
        dy[3] = fmaf(a0.w, p, dy[3]);
        dy[4] = fmaf(a1.x, p, dy[4]);
        dy[5] = fmaf(a1.y, p, dy[5]);
        dy[6] = fmaf(a1.z, p, dy[6]);
        dy[7] = fmaf(a1.w, p, dy[7]);
        hq[e] = h;
        pq[e] = p;
      }
      h1s[wq / 4] = make_float4(hq[0], hq[1], hq[2], hq[3]);
      dp1s[wq / 4] = make_float4(pq[0], pq[1], pq[2], pq[3]);
    }
    __syncthreads();
    rb_reduce(s, rows, c == 0, t.w[c], t.b1[c], t.b2);
    __syncthreads();
  }
}

// Writes the thread's tiles into the block's slice of the partials.
template <int R>
__device__ void rb_store(const RbTile<R>& t, int W, float* __restrict__ dw1p,
                         float* __restrict__ db1p, float* __restrict__ dw2p,
                         float* __restrict__ db2p) {
  const int g = threadIdx.x & 3, k = threadIdx.x >> 2;
  const size_t blk = blockIdx.x;
#pragma unroll
  for (int c = 0; c < R; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int w = c * RB_CHUNK + 4 * k + e;
      if (w >= W) continue;
      if (g < 3) {
        float* row = dw2p + (blk * W + w) * RB_CH + 8 * g;
#pragma unroll
        for (int j = 0; j < 8; ++j) row[j] = t.w[c][e][j];
      } else {
        float* row = dw1p + (blk * W + w) * RB_H;
#pragma unroll
        for (int j = 0; j < 8; ++j) row[j] = t.w[c][e][j];
        db1p[blk * W + w] = t.b1[c][e];
      }
    }
  }
  if (k == 0 && g < 3) {
#pragma unroll
    for (int j = 0; j < 8; ++j) db2p[blk * RB_CH + 8 * g + j] = t.b2[j];
  }
}

template <int R>
__global__ void __launch_bounds__(RB_LANES)
    rev_bwd_tiles_kernel(const float* __restrict__ ct, const float* __restrict__ yres,
                         const float* __restrict__ yhres, const float* __restrict__ gy,
                         const float* __restrict__ w1t, const float* __restrict__ b1,
                         const float* __restrict__ w2t, const float* __restrict__ b2,
                         float* __restrict__ dct, float* __restrict__ dz0,
                         float* __restrict__ dw1p, float* __restrict__ db1p,
                         float* __restrict__ dw2p, float* __restrict__ db2p, int B, int n,
                         int W, int m, double dt) {
  extern __shared__ float4 rb_smem[];
  const RbShared s(reinterpret_cast<float*>(rb_smem), W);
  rb_load_field(s, w1t, b1, w2t, b2, W);
  RbTile<R> t;
#pragma unroll
  for (int c = 0; c < R; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      t.b1[c][e] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) t.w[c][e][j] = 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) t.b2[j] = 0.f;
  __syncthreads();

  const float dtf = (float)dt, hdt = (float)(0.5 * dt);
  for (int grp = blockIdx.x; grp < (B + RB_LANES - 1) / RB_LANES; grp += gridDim.x) {
    const int lane = grp * RB_LANES + threadIdx.x;
    const bool live = lane < B;
    float ay[RB_H], ayh[RB_H];
#pragma unroll
    for (int h = 0; h < RB_H; ++h) ay[h] = ayh[h] = 0.f;

    for (int jr = 0; jr < n; ++jr) {
      const int j = n - 1 - jr;
      // Knot j + 1's cotangent enters as its interval's walk starts, from
      // the state stored there (lanes past the batch walk zeros).
      float y1[RB_H], yh1[RB_H];
#pragma unroll
      for (int h = 0; h < RB_H; ++h) {
        const size_t at = ((size_t)j * RB_H + h) * B + lane;
        if (live) ay[h] += gy[at];
        y1[h] = live ? yres[at] : 0.f;
        yh1[h] = live ? yhres[at] : 0.f;
      }
      float sb[RB_C], sc[RB_C], sd[RB_C];
      load_slab<RB_H, RB_C>(ct, j, B, lane, live, sb, sc, sd);
      float acc_b[RB_C], acc_c[RB_C], acc_d[RB_C];
#pragma unroll
      for (int i = 0; i < RB_C; ++i) acc_b[i] = acc_c[i] = acc_d[i] = 0.f;

      for (int st = m - 1; st >= 0; --st) {
        const float fr1 = fraction(st + 1, dt), fr0 = fraction(st, dt);
        float dx[RB_C], ddx[RB_C], u[RB_H], v[RB_H], f1[RB_H], f0[RB_H], yh0[RB_H];
        // The step's second evaluation: f1 = f(yh1) and its VJP.
        control_derivative<RB_C>(sb, sc, sd, fr1, dx);
#pragma unroll
        for (int h = 0; h < RB_H; ++h) u[h] = hdt * ay[h];
        rb_vjp<R>(s, u, yh1, dx, f1, v, ddx, t);
#pragma unroll
        for (int i = 0; i < RB_C; ++i) {
          acc_b[i] += ddx[i];
          acc_c[i] += fr1 * ddx[i];
          acc_d[i] += (fr1 * fr1) * ddx[i];
        }
        // The inverse map's companion, then its evaluation f0 = f(yh0) and VJP.
#pragma unroll
        for (int h = 0; h < RB_H; ++h) {
          yh0[h] = 2.f * y1[h] - yh1[h] - dtf * f1[h];
          ayh[h] += v[h];
          u[h] = hdt * ay[h] + dtf * ayh[h];
        }
        control_derivative<RB_C>(sb, sc, sd, fr0, dx);
        rb_vjp<R>(s, u, yh0, dx, f0, v, ddx, t);
#pragma unroll
        for (int i = 0; i < RB_C; ++i) {
          acc_b[i] += ddx[i];
          acc_c[i] += fr0 * ddx[i];
          acc_d[i] += (fr0 * fr0) * ddx[i];
        }
#pragma unroll
        for (int h = 0; h < RB_H; ++h) {
          y1[h] = y1[h] - hdt * (f1[h] + f0[h]);
          yh1[h] = yh0[h];
          ay[h] = ay[h] + 2.f * ayh[h];
          ayh[h] = -ayh[h] + v[h];
        }
      }
      if (live) {
        float* row = dct + (size_t)j * 3 * RB_C * B + lane;
#pragma unroll
        for (int i = 0; i < RB_C; ++i) {
          row[(size_t)i * B] = acc_b[i];
          row[(size_t)(RB_C + i) * B] = acc_c[i];
          row[(size_t)(2 * RB_C + i) * B] = acc_d[i];
        }
      }
    }
    // y and yh both start at z0: both adjoints flow there.
    if (live) {
#pragma unroll
      for (int h = 0; h < RB_H; ++h) dz0[(size_t)h * B + lane] = ay[h] + ayh[h];
    }
  }
  rb_store<R>(t, W, dw1p, db1p, dw2p, db2p);
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
  return H == RB_H && C == RB_C && rb_chunks(W) <= RB_MAX_CHUNKS &&
         sizeof(float) * rb_smem_floats(W) <= MAX_SMEM;
}

int check_call(int B, int n, int H, int C, int W, int m, int variant) {
  if (B < 1 || n < 1 || H < 1 || C < 1 || W < 1 || m < 1 || m > MAX_SUBSTEPS)
    return BAD_ARGUMENT;
  if (variant != GENERIC && !(variant == SPECIALISED && specialised_fits(H, C, W)))
    return BAD_VARIANT;
  return 0;
}

using RbKernel = decltype(&rev_bwd_tiles_kernel<1>);

RbKernel rb_kernel(int W) {
  switch (rb_chunks(W)) {
    case 1: return rev_bwd_tiles_kernel<1>;
    case 2: return rev_bwd_tiles_kernel<2>;
    case 3: return rev_bwd_tiles_kernel<3>;
    default: return rev_bwd_tiles_kernel<4>;
  }
}

// The backward launch for some shapes.
struct BwdPlan {
  int variant, blocks, threads, lanes;  // lanes a block walks at once
  int resident, sms, groups;            // blocks an SM holds; SMs; lane groups
  size_t bytes;                         // shared memory of a block
  bool acc_smem;                        // generic: weight gradients in shared memory
};

// The specialised variant runs as many blocks as the SMs hold at once, at
// most one per lane group (blocks stride over the rest); the generic one a
// block per lane, capped by its partials.
int backward_plan(BwdPlan& p, int B, int H, int C, int W, int force_generic) {
  p.variant = !force_generic && specialised_fits(H, C, W) ? SPECIALISED : GENERIC;
  int dev = 0, rc = (int)cudaGetDevice(&dev);
  if (!rc) rc = (int)cudaDeviceGetAttribute(&p.sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc) return rc;
  if (p.variant == SPECIALISED) {
    p.acc_smem = false;
    p.threads = p.lanes = RB_LANES;
    p.bytes = sizeof(float) * rb_smem_floats(W);
    p.groups = (B + RB_LANES - 1) / RB_LANES;
    rc = resident_blocks(rb_kernel(W), p.threads, p.bytes, p.resident);
    if (rc) return rc;
    if (p.resident < 1) return BAD_ARGUMENT;
    p.blocks = std::min<long>(p.groups, (long)p.resident * p.sms);
    return 0;
  }
  p.threads = GEN_THREADS;
  p.lanes = 1;
  p.acc_smem = sizeof(float) * RevLayout(H, C, W, true, true).total <= MAX_SMEM;
  p.bytes = sizeof(float) * RevLayout(H, C, W, true, p.acc_smem).total;
  if (p.bytes > MAX_SMEM) return BAD_ARGUMENT;
  p.groups = B;
  p.blocks = gen_backward_blocks(B, H, C, W);
  return resident_blocks(gen_rev_bwd_kernel, p.threads, p.bytes, p.resident);
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

// The backward launch for these shapes, into out[8]: the variant, blocks
// (the leading size of the weight partials), threads per block, lanes a
// block walks at once, blocks an SM holds, SMs, lane groups, shared bytes.
int fr_backward_plan(int B, int H, int C, int W, int force_generic, long* out) {
  BwdPlan p;
  if (B < 1 || W < 1) return BAD_ARGUMENT;
  const int rc = backward_plan(p, B, H, C, W, force_generic);
  if (rc) return rc;
  const long values[] = {p.variant, p.blocks, p.threads, p.lanes,
                         p.resident, p.sms, p.groups, (long)p.bytes};
  for (int i = 0; i < 8; ++i) out[i] = values[i];
  return 0;
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
    const size_t smem = tc_smem_bytes(W);
    err = set_smem(rev_fwd_tc_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    rev_fwd_tc_kernel<<<(B + TC_BLOCK - 1) / TC_BLOCK, TC_WARPS * 32, smem, st>>>(
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

// The backward launch of fr_backward_plan's variant and blocks, which the
// caller passes and this entry checks against its own plan.
int fr_backward(const float* ct, const float* yres, const float* yhres,
                const float* gy, const float* w1t, const float* b1,
                const float* w2t, const float* b2, float* dct, float* dz0,
                float* dw1p, float* db1p, float* dw2p, float* db2p, int B,
                int n, int H, int C, int W, int m, double dt, int variant,
                int blocks, void* stream) {
  int rc = check_call(B, n, H, C, W, m, variant);
  if (rc) return rc;
  BwdPlan p;
  rc = backward_plan(p, B, H, C, W, variant == GENERIC);
  if (rc) return rc;
  if (p.variant != variant || p.blocks != blocks) return BAD_ARGUMENT;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == SPECIALISED) {
    rb_kernel(W)<<<p.blocks, p.threads, p.bytes, st>>>(
        ct, yres, yhres, gy, w1t, b1, w2t, b2, dct, dz0, dw1p, db1p, dw2p, db2p, B, n, W, m,
        dt);
    return (int)cudaGetLastError();
  }
  gen_rev_bwd_kernel<<<p.blocks, p.threads, p.bytes, st>>>(
      ct, yres, yhres, gy, GenField{w1t, b1, w2t, b2, H, C, W}, dct, dz0, dw1p,
      db1p, dw2p, db2p, B, n, m, dt, p.acc_smem);
  return (int)cudaGetLastError();
}

}  // extern "C"
