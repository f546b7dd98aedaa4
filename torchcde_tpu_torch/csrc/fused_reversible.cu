// Reversible-Heun Neural CDE solve, forward and backward, as two CUDA
// kernels for Hopper (sm_90a): the forward in this file, the backward in
// fused_reversible_bwd.cu, what they share in fused_reversible.cuh.
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
// gradients' products, 6 m n B evaluations' worth, 79.7 GFLOP; both scale
// with H.  The control rows (58 MB) and the stored states (104 MB at H 8,
// written once, read once) are below that: compute-bound, the forward on the
// tensor cores (three TF32 passes, 0.161 ms at their rate at H 8), the
// backward on the CUDA cores.
//
// One forward and one backward take every shape inside the JAX package's
// caps (W <= 512, C*H <= 512, 3*C <= 16, m <= 8), H, C and W at run time:
// C (1..5) and the few register shapes below are template arguments, picked
// by the plans.  Instances: the forward's 19 (C x one warp at 1 or 2 state
// tiles, C x the split's tiles a warp), the backward's 22 (C x groups or not
// x 1 or 2 register tiles, and C 1 at 16 state components a thread).  The
// weights stay resident in shared memory where they fit; otherwise a small
// kernel stages them once per launch in device memory, in the layout the
// main kernel reads, and the block streams them through a ring of two
// chunks with cp.async (fused_reversible.cuh).
//
// Forward ("Forward" below): a warp per 16 batch lanes, the stage products
// on the tensor cores (mma.sync m16n8k8 in TF32, three passes for float32
// accuracy), the weights staged once per block in fragment order.  H is
// padded to Hp = 8 NT (NT state tiles) with zero weights; up to two tiles
// (and resident weights) a warp carries the lane group alone, beyond that S
// warps share the 16 lanes, each owning NTW state tiles for every channel,
// and exchange the evaluated state through shared memory once per
// evaluation.  Config 5 (H 8, C 3) is the one-warp case with one tile, in
// blocks of four warps.
//
// Backward (fused_reversible_bwd.cu): G threads per lane (a power of two),
// each owning HS state components (8; 16 for C 1 past H 256) and their C
// channels' second-layer rows, H padded to Hp = G HS, in blocks of lanes that share one copy of the weights,
// as many blocks as the SMs hold at once (one resident wave), the weight
// gradients reduced over each block's lanes in register tiles, written once
// as per-block partials and summed after the launch (deterministic, no float
// atomics).  Its recompute runs the evaluations on the CUDA cores in
// float32, so it rounds otherwise than the forward did: the inverse map
// starts from each interval's stored state, so the two roundings never
// accumulate across intervals.  Config 5 (H 8, G 1) runs one thread per
// lane in blocks of 128 lanes.
//
// Layouts (all float32, batch minor):
//   ct   (n, 3, C, B)  rows b, 2c, 3d of the control's cubic per interval
//   z0t  (H, B)        w1t (W, H)  b1 (W)  w2t (C*H, W)  b2 (C*H)
//   y, yh (n, H, B)    the state and its companion after every interval
// Backward: gy (n, H, B), the cotangent of y; outputs dct (n, 3, C, B),
// dz0 (H, B) and per-block partials dw1p (blocks, W, H), db1p (blocks, W),
// dw2p (blocks, W, C*H), db2p (blocks, C*H), with blocks from
// fr_backward_plan(...).  Where the weights stream, each entry takes a
// scratch buffer for their staged copy, of fr_forward_plan's and
// fr_backward_scratch's floats.
//
// Build: 41 kernel instances and two staging kernels in two translation
// units, compiled in parallel (torchcde_tpu_torch/_build.py); PERF.md gives
// the build time on the card.

#include <algorithm>

#include "fused_reversible.cuh"

namespace {

// ---------------------------------------------------------------------------
// Forward: a warp per 16 batch lanes (or S warps sharing them), the stage
// products on the tensor cores.
//
// Replaces the TPU kernel's walk (fused_pallas.py::_rev_fwd_kernel), which
// runs these products on its matrix unit (_dot), float32 as several passes.
// What bounds it: the two products of every evaluation, 2 W H (1 + C) flops
// a lane.  As float32 on the CUDA cores, one thread a lane issues a shared
// load per few FMAs, and at config 5 the issue slots set the pace (1.14 ms
// against the FMAs' 0.40).  Here the products run as mma.sync.m16n8k8 in
// TF32: three passes, lo.hi, hi.lo and hi.hi, with each float32 operand
// split as hi = tf32(x), lo = tf32(x - hi), summed in float32, the two
// cross terms in an accumulator of their own that joins hi.hi's at the end
// (smallest terms first): the float32 products to about 2^-21, as the TPU
// kernel's multi-pass f32 dots.  Apart, the two accumulators are two
// dependent chains of MMAs where one would be three in a row, which the card
// runs slower (PERF.md).  Three times the 26.6 GFLOP at 495 TFLOP/s TF32 is
// 0.161 ms at config 5.
//
// The tile.  A lane group's 16 lanes are the M of the products; a chunk of 8
// hidden units is the N of the first product and the K of the second.  The
// state is NT tiles of 8 components: the first product takes one k-step a
// tile, the second has C NT n-tiles (NT for each channel).  Thread (g =
// lane / 4, t = lane % 4) holds, in the accumulator layout, rows g and g + 8
// (two batch lanes) at columns 2t and 2t + 1 of each tile.  An accumulator
// fragment read as an A fragment with k-index t standing for column 2t and
// t + 4 for 2t + 1 (as_a) needs no shuffle: the state (the first product's
// A), each chunk's h1 (the first product's C, the second's A) and g (the
// second's C) all stay in the registers that hold them, and dX/dt . g and
// the step are thread-local.  The contraction index is permuted to match
// when the block stages the weights: W1's columns and W2's rows within a
// chunk, both in B-fragment order, split into hi and lo once per block
// (tc_frag).  W is padded with zero weights to a multiple of 8, H to 8 NT
// (zero columns of W1 and zero rows of W2 keep the padded components at
// zero, exactly).  Lanes past B run on zeros and are not written.
//
// Two kernels.  rev_fwd_kernel<C, NT>: one warp a lane group, one or two
// tiles (H <= 16), the weights resident.  At config 5 a lane group's chain
// of dependent MMAs sets the pace (1024 warps, under 8 an SM), so its chunk
// loop carries no barrier and no copy, and its walk keeps the launch's
// scalars and the stores' offsets in registers.  rev_fwd_split_kernel<C,
// NTW>: every other shape.
//
// The split.  A thread holds 8 accumulators (G and the cross terms X) for
// each n-tile of the second product; with many tiles they outgrow it.  Past
// two tiles (H > 16) a lane group runs on S warps, each owning NTW tiles of
// the state for all C channels, so the contraction stays in the warp.  Each
// warp needs the whole state as the first product's A: before an evaluation
// every warp writes its tiles' A fragments (hi, lo) to a slot of shared
// memory, one barrier, and every warp reads all NT k-steps from there; two
// slots alternate, so one barrier an evaluation suffices (one slot and two
// barriers where two do not fit).  Every warp computes the whole h1: the
// first product, 1 / (1 + C) of the work, runs S times.  NTW: 2, or 4 or 8
// where C is small and H large (at most 8 warps a lane group), from the
// registers: 8 C NTW accumulators a thread.
//
// Blocks: LG lane groups (4 one-warp groups, or 8 / S split groups) share
// one copy of the weights: 8 W Hp (1 + C) bytes in fragment order, 32 KB at
// H 8, C 3, W 128, 131 KB at H 32.  Past a block's shared memory (W 512 at
// H 16, C 5, or the caps), the split kernel takes the shape (S may be 1), the
// fragments are staged once per launch in device memory (stage_frags_kernel)
// and each block streams them a chunk of 8 hidden units at a time through
// the ring, one barrier a chunk.

constexpr int TC_LANES = 16;   // batch lanes a lane group: the M of a product
constexpr int TC_K = 8;        // hidden units a chunk
constexpr int ONE_WARPS = 4;   // warps (lane groups) a block of the one-warp forward
constexpr int SPLIT_THREADS = 256;
constexpr int SPLIT_WARPS = SPLIT_THREADS / 32;  // most warps a block of the split forward

__host__ __device__ inline int tc_chunks(int W) { return (W + TC_K - 1) / TC_K; }

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

// Element e of the weights in fragment order, F = NT (1 + C) fragments of
// 32 float4s a chunk of 8 hidden units: fragment j < NT of chunk c is W1's
// k-step j (B[k][n] = w1t[8c + n][8j + perm k]), fragment NT + i NT + s is
// channel i's W2 for state tile s (B[k][n] = w2t[i H + 8s + n][8c + perm
// k]), with perm t = 2t, perm t + 4 = 2t + 1, thread (g, t) holding (b0, b1)
// = (B[t][g], B[t + 4][g]) as (hi0, hi1, lo0, lo1); zero past W and past H.
__device__ __forceinline__ float4 tc_frag(const float* __restrict__ w1t, const float* __restrict__ w2t, int H,
                          int C, int W, int NT, int e) {
  const int F = NT * (1 + C);
  const int lane = e & 31, j = (e >> 5) % F, c = (e >> 5) / F;
  const int g = lane >> 2, t = lane & 3;
  float v0 = 0.f, v1 = 0.f;
  if (j < NT) {
    const int w = c * TC_K + g, k = 8 * j + 2 * t;
    if (w < W) {
      if (k < H) v0 = w1t[(size_t)w * H + k];
      if (k + 1 < H) v1 = w1t[(size_t)w * H + k + 1];
    }
  } else {
    const int i = (j - NT) / NT, k = 8 * ((j - NT) % NT) + g, w = c * TC_K + 2 * t;
    if (k < H) {
      const float* row = w2t + (size_t)(i * H + k) * W;
      if (w < W) v0 = row[w];
      if (w + 1 < W) v1 = row[w + 1];
    }
  }
  uint32_t hi0, lo0, hi1, lo1;
  tf32_split(v0, hi0, lo0);
  tf32_split(v1, hi1, lo1);
  return make_float4(__uint_as_float(hi0), __uint_as_float(hi1), __uint_as_float(lo0),
                     __uint_as_float(lo1));
}

// The fragments of every chunk into device memory, for the blocks to stream.
__global__ void stage_frags_kernel(const float* __restrict__ w1t, const float* __restrict__ w2t,
                                   int H, int C, int W, int NT, float4* __restrict__ out) {
  const int total = tc_chunks(W) * NT * (1 + C) * 32;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += gridDim.x * blockDim.x)
    out[e] = tc_frag(w1t, w2t, H, C, W, NT, e);
}

// Byte offsets of the forward's shared memory: the fragments (every chunk,
// or the ring's two), the exchanged state's A fragments (split only: slots
// x LG x NT k-steps x 32 threads x hi, lo), b1 (chunks x 8), b2 (C x Hp).
struct FwdLayout {
  size_t frag, ybuf, b1s, b2s, bytes;
  __host__ __device__ FwdLayout(int C, int W, int NT, int LG, bool split, bool streamed,
                                bool ysingle) {
    const size_t F = (size_t)NT * (1 + C);
    frag = 0;
    ybuf = frag + 16 * F * 32 * (streamed ? 2 : tc_chunks(W));
    b1s = ybuf + (split ? (size_t)(ysingle ? 1 : 2) * LG * NT * 32 * 32 : 0);
    b2s = b1s + 4 * (size_t)tc_chunks(W) * TC_K;
    bytes = b2s + 4 * (size_t)C * 8 * NT;
  }
};

// The block's copy of the weights: the fragments (unless streamed), b1
// padded to whole chunks, b2 padded to C x 8 NT.
template <int C>
__device__ void tc_load_field(float4* frag, float* b1s, float* b2s,
                              const float* __restrict__ w1t, const float* __restrict__ b1,
                              const float* __restrict__ w2t, const float* __restrict__ b2,
                              int H, int W, int NT, bool streamed) {
  const int chunks = tc_chunks(W);
  if (!streamed) {
#pragma unroll 4
    for (int e = threadIdx.x; e < chunks * NT * (1 + C) * 32; e += blockDim.x)
      frag[e] = tc_frag(w1t, w2t, H, C, W, NT, e);
  }
  for (int i = threadIdx.x; i < chunks * TC_K; i += blockDim.x) b1s[i] = i < W ? b1[i] : 0.f;
  for (int i = threadIdx.x; i < C * 8 * NT; i += blockDim.x) {
    const int ch = i / (8 * NT), k = i - ch * 8 * NT;
    b2s[i] = k < H ? b2[ch * H + k] : 0.f;
  }
}

// The second product's accumulators for this warp's tiles (from tile nt0):
// hi.hi from b2, the cross terms from zero.
template <int C, int NTW>
__device__ __forceinline__ void tc_start(const float* b2s, int NT, int nt0, float (&G)[C][NTW][4],
                                         float (&X)[C][NTW][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const float2 bias = *reinterpret_cast<const float2*>(b2s + (i * NT + nt0 + nt) * 8 + 2 * t);
      G[i][nt][0] = G[i][nt][2] = bias.x;
      G[i][nt][1] = G[i][nt][3] = bias.y;
#pragma unroll
      for (int r = 0; r < 4; ++r) X[i][nt][r] = 0.f;
    }
  }
}

// One chunk of 8 hidden units: h1 = relu(y W1 + b1) from the state's NT
// k-steps (A fragments from a(kt, hi, lo)), then this warp's tiles of the
// second product; f: this thread's fragments of the chunk, b1c: its pair
// of b1 (columns 2t, 2t + 1 of the chunk).
template <int C, int NTW, typename AFrag>
__device__ __forceinline__ void tc_chunk(const float4* f, const float* b1c, int NT, int nt0,
                                         AFrag a, float (&G)[C][NTW][4],
                                         float (&X)[C][NTW][4]) {
  const float2 bias = *reinterpret_cast<const float2*>(b1c);
  float h[4] = {bias.x, bias.y, bias.x, bias.y}, hx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    uint32_t ahi[4], alo[4];
    a(kt, ahi, alo);
    mma3(h, hx, ahi, alo, f[kt * 32]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    h[r] += hx[r];
    h[r] = (h[r] < 0.f) ? 0.f : h[r];
  }
  uint32_t hhi[4], hlo[4];
  as_a(h, hhi, hlo);
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
      mma3(G[i][nt], X[i][nt], hhi, hlo, f[(NT + i * NT + nt0 + nt) * 32]);
  }
}

// k = sum_i tanh(G_i + X_i) dx_i at this thread's positions.
template <int C, int NTW>
__device__ __forceinline__ void tc_contract(const float (&G)[C][NTW][4],
                                            const float (&X)[C][NTW][4],
                                            const float (&dx)[2][C], float (&k)[NTW][4]) {
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float(&d)[C] = dx[r >> 1];
      float acc = tanhf(G[0][nt][r] + X[0][nt][r]) * d[0];
#pragma unroll
      for (int i = 1; i < C; ++i) acc += tanhf(G[i][nt][r] + X[i][nt][r]) * d[i];
      k[nt][r] = acc;
    }
  }
}

// k = f(y) along dx for one warp's 16 lanes, all NT tiles its own, the
// weights resident: this thread's y and k at positions [tile][r] (r / 2:
// lane g or g + 8; r % 2: component 2t or 2t + 1), dx of its two lanes.
template <int C, int NT>
__device__ __forceinline__ void tc_field_one(const float4* __restrict__ frag,
                                             const float* __restrict__ b1s,
                                             const float* __restrict__ b2s, int chunks,
                                             const float (&y)[NT][4], const float (&dx)[2][C],
                                             float (&k)[NT][4]) {
  uint32_t yhi[NT][4], ylo[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) as_a(y[nt], yhi[nt], ylo[nt]);
  auto a = [&](int kt, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      hi[r] = yhi[kt][r];
      lo[r] = ylo[kt][r];
    }
  };
  float G[C][NT][4], X[C][NT][4];
  tc_start<C, NT>(b2s, NT, 0, G, X);
  const float4* f = frag + (threadIdx.x & 31);
  const float* b1t = b1s + 2 * (threadIdx.x & 3);
#pragma unroll 4
  for (int c = 0; c < chunks; ++c, f += NT * (1 + C) * 32)
    tc_chunk<C, NT>(f, b1t + c * TC_K, NT, 0, a, G, X);
  tc_contract<C, NT>(G, X, dx, k);
}

// What a warp of the split forward needs besides its registers.
struct SplitCtx {
  float4* frag;  // resident fragments, or the ring's slots
  uint4* ybuf;   // the exchanged state
  const float* b1s;
  const float* b2s;
  int chunks, NT, LG, lg, s, ysingle, streamed, ev;
};

// The same for S warps sharing the lane group, this warp's NTW tiles from
// tile s NTW, every tile's A fragments exchanged through shared memory.
template <int C, int NTW>
__device__ __forceinline__ void tc_field_split(SplitCtx& x, Ring& ring, const float (&y)[NTW][4],
                                               const float (&dx)[2][C], float (&k)[NTW][4]) {
  const int lane = threadIdx.x & 31, NT = x.NT, F = NT * (1 + C), nt0 = x.s * NTW;
  const int slot = x.ysingle ? 0 : (x.ev++ & 1);
  if (x.ysingle) __syncthreads();  // every warp done with the last evaluation's state
  uint4* mine = x.ybuf + (size_t)(slot * x.LG + x.lg) * NT * 64;
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    uint32_t hi[4], lo[4];
    as_a(y[nt], hi, lo);
    mine[(nt0 + nt) * 64 + lane] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    mine[(nt0 + nt) * 64 + 32 + lane] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  __syncthreads();
  const uint4* yb = mine + lane;
  auto a = [&](int kt, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    const uint4 h = yb[kt * 64], l = yb[kt * 64 + 32];
    hi[0] = h.x, hi[1] = h.y, hi[2] = h.z, hi[3] = h.w;
    lo[0] = l.x, lo[1] = l.y, lo[2] = l.z, lo[3] = l.w;
  };
  float G[C][NTW][4], X[C][NTW][4];
  tc_start<C, NTW>(x.b2s, NT, nt0, G, X);
  const float* b1t = x.b1s + 2 * (lane & 3);
  if (x.streamed) {
    for (int c = 0; c < x.chunks; ++c)
      tc_chunk<C, NTW>(ring.step(c) + lane, b1t + c * TC_K, NT, nt0, a, G, X);
  } else {
    for (int c = 0; c < x.chunks; ++c)
      tc_chunk<C, NTW>(x.frag + (size_t)c * F * 32 + lane, b1t + c * TC_K, NT, nt0, a, G, X);
  }
  tc_contract<C, NTW>(G, X, dx, k);
}

// The walk over the intervals for this thread's two lanes and NTW tiles
// (from tile nt0) of the lane group from lane lbase, field(y, dx, k)
// evaluating f.  Scalars by value: the compiler keeps them in registers.
template <int C, int NTW, typename Field>
__device__ __forceinline__ void tc_walk(const float* __restrict__ ct,
                                        const float* __restrict__ z0t,
                                        float* __restrict__ yres, float* __restrict__ yhres,
                                        int B, int n, int H, int m, double dt, int lbase,
                                        int nt0, Field field) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int row[2] = {lbase + g, lbase + g + 8};
  const bool live[2] = {row[0] < B, row[1] < B};
  const float dtf = (float)dt, hdt = (float)(0.5 * dt);
  // Position [tile][r] is component 8 (nt0 + tile) + 2t + r % 2 of lane
  // row[r / 2]: its offset in an (H, B) plane, and whether it is stored.
  const size_t base = (size_t)(8 * nt0 + 2 * t) * B + row[0];
  bool ok[NTW][4];
  float y[NTW][4], yh[NTW][4];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      ok[nt][r] = live[r >> 1] && 8 * (nt0 + nt) + 2 * t + (r & 1) < H;
      const size_t at = base + (size_t)(8 * nt + (r & 1)) * B + 8 * (r >> 1);
      y[nt][r] = yh[nt][r] = ok[nt][r] ? z0t[at] : 0.f;
    }
  }
  for (int j = 0; j < n; ++j) {
    float sb[2][C], sc[2][C], sd[2][C], dx[2][C], f[NTW][4];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      load_slab<1, C>(ct, j, B, row[p], live[p], sb[p], sc[p], sd[p]);
      control_derivative<C>(sb[p], sc[p], sd[p], 0.f, dx[p]);
    }
    field(yh, dx, f);
    for (int s = 0; s < m; ++s) {
      float yn[NTW][4], f1[NTW][4];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) yn[nt][r] = 2.f * y[nt][r] - yh[nt][r] + dtf * f[nt][r];
      }
#pragma unroll
      for (int p = 0; p < 2; ++p)
        control_derivative<C>(sb[p], sc[p], sd[p], fraction(s + 1, dt), dx[p]);
      field(yn, dx, f1);
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          y[nt][r] = y[nt][r] + hdt * (f[nt][r] + f1[nt][r]);
          yh[nt][r] = yn[nt][r];
          f[nt][r] = f1[nt][r];
        }
      }
    }
    float* yj = yres + (size_t)j * H * B;
    float* yhj = yhres + (size_t)j * H * B;
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const size_t at = base + (size_t)(8 * nt + (r & 1)) * B + 8 * (r >> 1);
        if (ok[nt][r]) {
          yj[at] = y[nt][r];
          yhj[at] = yh[nt][r];
        }
      }
    }
  }
}

// A warp per lane group of 16, NT (1 or 2) state tiles, the weights
// resident: blocks of ONE_WARPS lane groups.
template <int C, int NT>
__global__ void __launch_bounds__(ONE_WARPS * 32)
    rev_fwd_kernel(const float* __restrict__ ct, const float* __restrict__ z0t,
                   const float* __restrict__ w1t, const float* __restrict__ b1,
                   const float* __restrict__ w2t, const float* __restrict__ b2,
                   float* __restrict__ yres, float* __restrict__ yhres, int B, int n, int H,
                   int W, int m, double dt) {
  extern __shared__ float4 fwd_smem[];
  const FwdLayout L(C, W, NT, ONE_WARPS, false, false, false);
  char* base = reinterpret_cast<char*>(fwd_smem);
  float4* frag = reinterpret_cast<float4*>(base + L.frag);
  float* b1s = reinterpret_cast<float*>(base + L.b1s);
  float* b2s = reinterpret_cast<float*>(base + L.b2s);
  tc_load_field<C>(frag, b1s, b2s, w1t, b1, w2t, b2, H, W, NT, false);
  __syncthreads();
  const int lbase = (int)blockIdx.x * ONE_WARPS * TC_LANES + (threadIdx.x >> 5) * TC_LANES;
  if (lbase >= B) return;  // the whole warp: mma.sync needs all
  const int chunks = tc_chunks(W);
  tc_walk<C, NT>(ct, z0t, yres, yhres, B, n, H, m, dt, lbase, 0,
                 [&](const float (&y)[NT][4], const float (&dx)[2][C], float (&k)[NT][4]) {
                   tc_field_one<C, NT>(frag, b1s, b2s, chunks, y, dx, k);
                 });
}

// S warps per lane group, NTW tiles a warp, LG lane groups a block, the
// weights resident or streamed.  Every warp walks every evaluation, lanes
// past B on zeros: the barriers of the exchange and of the ring need all.
template <int C, int NTW>
__global__ void __launch_bounds__(SPLIT_THREADS)
    rev_fwd_split_kernel(const float* __restrict__ ct, const float* __restrict__ z0t,
                         const float* __restrict__ w1t, const float* __restrict__ b1,
                         const float* __restrict__ w2t, const float* __restrict__ b2,
                         const float4* __restrict__ staged, float* __restrict__ yres,
                         float* __restrict__ yhres, int B, int n, int H, int W, int m, double dt,
                         int NT, int LG, int S, int streamed, int ysingle) {
  extern __shared__ float4 fwd_smem[];
  const FwdLayout L(C, W, NT, LG, true, streamed, ysingle);
  char* base = reinterpret_cast<char*>(fwd_smem);
  const int warp = threadIdx.x >> 5;
  SplitCtx x{reinterpret_cast<float4*>(base + L.frag), reinterpret_cast<uint4*>(base + L.ybuf),
             reinterpret_cast<float*>(base + L.b1s), reinterpret_cast<float*>(base + L.b2s),
             tc_chunks(W), NT, LG, warp / S, warp % S, ysingle, streamed, 0};
  Ring ring(x.frag, staged, streamed ? NT * (1 + C) * 32 : 0, x.chunks);
  tc_load_field<C>(x.frag, reinterpret_cast<float*>(base + L.b1s),
                   reinterpret_cast<float*>(base + L.b2s), w1t, b1, w2t, b2, H, W, NT, streamed);
  __syncthreads();
  tc_walk<C, NTW>(ct, z0t, yres, yhres, B, n, H, m, dt, ((int)blockIdx.x * LG + x.lg) * TC_LANES,
                  x.s * NTW,
                  [&](const float (&y)[NTW][4], const float (&dx)[2][C], float (&k)[NTW][4]) {
                    tc_field_split<C, NTW>(x, ring, y, dx, k);
                  });
  copy_wait();
}

using FwdKernel = decltype(&rev_fwd_kernel<1, 1>);
using SplitKernel = decltype(&rev_fwd_split_kernel<1, 2>);

// The instances: one warp at one or two tiles for every C; the split at two
// tiles a warp for every C, at four for C <= 3 and at eight for C 1.
FwdKernel fwd_kernel(int C, int NT) {
#define K8_FWD(c, nt) \
  if (C == c && NT == nt) return rev_fwd_kernel<c, nt>;
  K8_FWD(1, 1) K8_FWD(2, 1) K8_FWD(3, 1) K8_FWD(4, 1) K8_FWD(5, 1)
  K8_FWD(1, 2) K8_FWD(2, 2) K8_FWD(3, 2) K8_FWD(4, 2) K8_FWD(5, 2)
#undef K8_FWD
  return nullptr;
}

SplitKernel split_kernel(int C, int NTW) {
#define K8_SPLIT(c, ntw) \
  if (C == c && NTW == ntw) return rev_fwd_split_kernel<c, ntw>;
  K8_SPLIT(1, 2) K8_SPLIT(2, 2) K8_SPLIT(3, 2) K8_SPLIT(4, 2) K8_SPLIT(5, 2)
  K8_SPLIT(1, 4) K8_SPLIT(2, 4) K8_SPLIT(3, 4) K8_SPLIT(1, 8)
#undef K8_SPLIT
  return nullptr;
}

// One forward launch, as forward_plan sets it.
struct FwdPlan {
  int NT;        // state tiles: Hp / 8
  int NTW, S;    // tiles a warp; warps a lane group
  int LG;        // lane groups a block
  int split;     // the split kernel (else one warp a lane group)
  int streamed;  // split: the weights through the ring (else resident)
  int ysingle;   // split: one slot of exchanged state (else two)
  int blocks, threads;
  size_t bytes, scratch;  // shared bytes a block; floats of staged fragments
};

// The forward launch for these shapes: one warp a lane group where the
// state is one or two tiles and the weights fit; otherwise the split, the
// weights resident or streamed (then a smaller block where needed, and one
// slot of exchanged state as a last resort).
int forward_plan(FwdPlan& p, int B, int H, int C, int W) {
  const int tiles = (H + 7) / 8;
  p.streamed = 0;
  p.ysingle = 0;
  p.split = tiles > 2 ||
            FwdLayout(C, W, tiles, ONE_WARPS, false, false, false).bytes > MAX_SMEM;
  if (!p.split) {
    p.NTW = p.NT = tiles;
    p.S = 1;
    p.LG = ONE_WARPS;
  } else {
    p.NTW = 2;
    while ((tiles + p.NTW - 1) / p.NTW > SPLIT_WARPS) p.NTW *= 2;
    p.S = (tiles + p.NTW - 1) / p.NTW;
    p.NT = p.S * p.NTW;
    p.LG = std::max(1, SPLIT_WARPS / p.S);
  }
  if (p.split ? !split_kernel(C, p.NTW) : !fwd_kernel(C, p.NT)) return BAD_ARGUMENT;
  auto bytes = [&] {
    return FwdLayout(C, W, p.NT, p.LG, p.split, p.streamed, p.ysingle).bytes;
  };
  if (bytes() > MAX_SMEM) p.streamed = 1;
  while (bytes() > MAX_SMEM && p.LG > 1) --p.LG;
  if (bytes() > MAX_SMEM) p.ysingle = 1;
  p.bytes = bytes();
  if (p.bytes > MAX_SMEM) return BAD_ARGUMENT;
  p.scratch = p.streamed ? (size_t)tc_chunks(W) * p.NT * (1 + C) * 32 * 4 : 0;
  p.threads = p.LG * p.S * 32;
  const int groups = (B + TC_LANES - 1) / TC_LANES;
  p.blocks = (groups + p.LG - 1) / p.LG;
  return 0;
}

}  // namespace

extern "C" {

const char* fr_error_string(int code) {
  if (code == BAD_ARGUMENT) return "invalid argument";
  return cudaGetErrorString((cudaError_t)code);
}

// The forward launch for these shapes, into out[8]: the weights' path (0
// resident in shared memory, 1 streamed), blocks, threads a block, lanes a
// block, warps a lane group, the padded hidden size, shared bytes a block,
// and the floats of scratch fr_forward needs (0 when resident).
int fr_forward_plan(int B, int H, int C, int W, long* out) {
  FwdPlan p;
  int rc = check_call(B, 1, H, C, W, 1);
  if (!rc) rc = forward_plan(p, B, H, C, W);
  if (rc) return rc;
  const long values[] = {p.streamed, p.blocks, p.threads, (long)p.LG * TC_LANES,
                         p.S, 8L * p.NT, (long)p.bytes, (long)p.scratch};
  for (int i = 0; i < 8; ++i) out[i] = values[i];
  return 0;
}

int fr_forward(const float* ct, const float* z0t, const float* w1t, const float* b1,
               const float* w2t, const float* b2, float* yres, float* yhres, float* scratch,
               int B, int n, int H, int C, int W, int m, double dt, void* stream) {
  FwdPlan p;
  int rc = check_call(B, n, H, C, W, m);
  if (!rc) rc = forward_plan(p, B, H, C, W);
  if (rc) return rc;
  if (p.scratch && !scratch) return BAD_ARGUMENT;
  cudaStream_t st = (cudaStream_t)stream;
  float4* staged = reinterpret_cast<float4*>(scratch);
  if (p.streamed) {
    const int total = (int)(p.scratch / 4);
    stage_frags_kernel<<<std::min((total + 255) / 256, 1024), 256, 0, st>>>(w1t, w2t, H, C, W,
                                                                          p.NT, staged);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err;
  if (p.split) {
    const SplitKernel kernel = split_kernel(C, p.NTW);
    err = set_smem(kernel, p.bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<p.blocks, p.threads, p.bytes, st>>>(ct, z0t, w1t, b1, w2t, b2, staged, yres, yhres,
                                                  B, n, H, W, m, dt, p.NT, p.LG, p.S,
                                                  p.streamed, p.ysingle);
  } else {
    const FwdKernel kernel = fwd_kernel(C, p.NT);
    err = set_smem(kernel, p.bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<p.blocks, p.threads, p.bytes, st>>>(ct, z0t, w1t, b1, w2t, b2, yres, yhres, B, n, H,
                                                  W, m, dt);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
