// Backward of the reversible-Heun Neural CDE solve (K8) on Hopper (sm_90a):
// the kernel that walks the intervals in reverse, and its entries.  What it
// computes, what bounds it and how it relates to the forward: the notes at
// the top of fused_reversible.cu.
//
// Replaces torchcde_tpu/solvers/fused_pallas.py::_rev_bwd_kernel, which
// walks a tile of lanes per program and accumulates the tile's weight
// gradients across all intervals as products over the tile's lanes
// (dw1_acc ... db2_acc).  Here a block's lanes are the tile, and the block
// holds one copy of the weights in shared memory: per row w of the hidden
// layer one record of W1's row, W2's column and b1 (rec_value), the state
// index padded to Hp with zero weights.
//
// A group of G threads per lane (G = Hp / HS, a power of two, at most a
// warp): rank r owns the HS state components r HS .. r HS + HS - 1 and, for
// every channel i, the second layer's rows i Hp + r HS ..: its slice of y,
// u, the cotangents, the recomputed states, pre2, g and dp2 in registers,
// about what one thread per lane held at H 8 (HS 8; HS 16 for C 1 at H >
// 256; HS 4, twice the threads a lane, where the lane groups are fewer than
// half the SMs).  Per VJP every rank walks every row w of the weights:
//   * h1_w = relu(W1[w] . y + b1_w): its slice's dot product, summed over the
//     group by a butterfly of shuffles (every rank gets the same bits), and
//     pre2 += W2[., w] h1_w on its own rows of the second layer;
//   * then g = tanh(pre2 + b2), k, dp2 and the rank's part of ddx (summed by
//     a butterfly) on its own rows;
//   * a second walk recomputes h1_w, sums dh_w = W2[., w] . dp2 over the
//     group the same way, and adds W1[w]^T p_w (p = dh where h1 > 0) to its
//     slice of dy.
// So the H-long and C H-long dot products are split over the group and
// summed with shuffles in a fixed order; the W-long ones stay in one thread.
// At H 8 (G 1) no shuffle runs: one thread per lane, blocks of 128 lanes.
//
// The weight gradients.  The second walk stages, per lane, h1 and dp1 of a
// chunk of rows (the left operands; left_stride keeps eight lanes' float4
// stores in distinct banks), dp2 and y (the right ones).  Then the block
// reduces the chunk over its lanes as a product: a unit of 4 rows x 8
// columns, of dW2 (left h1, columns of dp2) or of dW1 (left dp1, columns of
// y), with db1 and db2 beside, is summed over the lanes in order into a fresh
// partial, which is added to the unit's running sum once per VJP.  Unit u of
// a chunk (row quad u / NB, column block u % NB, NB = (1 + C) Hp / 8 blocks)
// belongs to thread u % T, the first NREG (1 or 2) of a thread's units in
// registers for the whole walk and written once, as the block's partial;
// the rest in the block's own slice of the partials, read and written once
// per VJP.  Blocks stride over the lane groups where the grid is smaller
// than their number.  Deterministic: lanes, lane groups and (on the host)
// blocks are summed in a fixed order, without atomics.
//
// Weights that do not fit: a small kernel stages the records in device
// memory, and each walk streams them a chunk of CR rows at a time through
// the ring (cde_stream.cuh), CR as large as the shared memory allows.
//
// The kernel's instances for 4 and 5 channels are compiled apart:
// fused_reversible_bwd_wide.cu includes this source with K8_BWD_WIDE
// defined and gives them to bwd_kernel (fr_backward_kernel_wide), so that
// nvcc builds the two halves side by side (all in one source led the build).

#include <algorithm>

#include "fused_reversible.cuh"

namespace {

constexpr int BW_THREADS = 256;  // most threads a block
constexpr int BW_LANES = 128;    // lanes a block at G 1
constexpr int ROW_CHUNK = 128;   // rows a chunk of the reduction (resident weights)
constexpr int MAX_GROUP = 32;    // threads a lane: a group lies in one warp
constexpr int SMALL_HS = 4;      // components a thread at small batches (group path)

__host__ __device__ inline int round4(int W) { return (W + 3) & ~3; }

// Row stride of the left operands: rows rounded to an odd multiple of 4, so
// that eight consecutive lanes' float4 stores fall in distinct banks.
__host__ __device__ inline int left_stride(int rows) { return 4 * ((round4(rows) / 4) | 1); }

// One backward launch's shapes, as backward_plan sets them.
struct BwdArgs {
  int B, n, H, W, m;
  double dt;
  int Hp, G, LB;        // padded hidden size, threads a lane, lanes a block
  int W4, CR, R, UPC;   // rows to a multiple of 4; rows a chunk; chunks; units a thread a chunk
  int streamed;         // the records through the ring (else resident)
};

// Offsets, in floats, of the backward's shared memory: the records (every
// row, or the ring's two chunks), b2 (C Hp), left [2][LB][S] (h1, then dp1,
// of a chunk's rows per lane), right [LB][RR] (dp2, y per lane).
struct BwdLayout {
  int RS, S, RR;
  size_t rec, b2s, left, right, total;
  __host__ __device__ BwdLayout(int C, const BwdArgs& a) {
    RS = record_floats(C, a.Hp);
    S = left_stride(a.W4 < a.CR ? a.W4 : a.CR);
    RR = (1 + C) * a.Hp + 4;
    rec = 0;
    b2s = rec + (size_t)(a.streamed ? 2 * a.CR : a.W4) * RS;
    left = b2s + (size_t)C * a.Hp;
    right = left + 2 * (size_t)a.LB * S;
    total = right + (size_t)a.LB * RR;
  }
};

// A thread's share of the block's weight gradients held in registers.
template <int NREG>
struct Tiles {
  float w[NREG][4][8];  // rows 4k + e of its units; 8 columns of dW2 or dW1
  float b1[NREG][4];    // db1 of those rows (units of the first dW1 block)
  float b2[8];          // db2, 8 columns (units of the first row quad)
};

// The block's partials (the slice of this block) and where a unit goes.
struct Partials {
  float *dw1, *db1, *dw2, *db2;
  int H, C, W, Hp, CR;

  // Stores (or adds) unit (chunk c, row quad k, column block b) of the
  // block's gradients: 4 rows x 8 columns and db1 of the rows, columns past H
  // and rows past W dropped.
  __device__ void unit(int c, int k, int b, const float (&v)[4][8], const float (&vb1)[4],
                       bool add) const {
    const int NBQ = C * Hp / 8;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int w = c * CR + 4 * k + e;
      if (w >= W) continue;
      float* row;
      int h0;
      if (b >= NBQ) {
        h0 = 8 * (b - NBQ);
        row = dw1 + (size_t)w * H;
        if (b == NBQ) db1[w] = add ? db1[w] + vb1[e] : vb1[e];
      } else {
        const int i = 8 * b / Hp;
        h0 = 8 * b - i * Hp;
        row = dw2 + (size_t)w * C * H + i * H;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (h0 + j < H) row[h0 + j] = add ? row[h0 + j] + v[e][j] : v[e][j];
      }
    }
  }
};

// What a thread of the backward needs besides its registers.
struct BwdCtx {
  const float* rec;  // resident records
  const float* b2s;
  float* left;
  float* right;
  int RS, S, RR, Hp, G, LB, W4, CR, R, UPC, NB, NBQ, streamed, l, r, hoff;
};

template <bool GROUP>
__device__ __forceinline__ float group_sum(float a, int G) {
  if constexpr (GROUP) {
    for (int o = 1; o < G; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  }
  return a;
}

// p[0..HS) . v, in order.
template <int HS>
__device__ __forceinline__ float dot_slice(const float* p, const float (&v)[HS]) {
  const float4* q = reinterpret_cast<const float4*>(p);
  float a = 0.f;
#pragma unroll
  for (int j = 0; j < HS / 4; ++j) {
    const float4 c = q[j];
    a = fmaf(c.x, v[4 * j], a);
    a = fmaf(c.y, v[4 * j + 1], a);
    a = fmaf(c.z, v[4 * j + 2], a);
    a = fmaf(c.w, v[4 * j + 3], a);
  }
  return a;
}

// The records of chunk c: resident, or the ring's next.
__device__ __forceinline__ const float* chunk_rows(const BwdCtx& x, Ring& ring, int c) {
  return x.streamed ? reinterpret_cast<const float*>(ring.step(c))
                    : x.rec + (size_t)c * x.CR * x.RS;
}

// h1_w = relu(W1[w] . y + b1_w) from row w's record, y the rank's slice.
template <int C, int HS, bool GROUP>
__device__ __forceinline__ float bw_hidden(const BwdCtx& x, const float* row,
                                           const float (&y)[HS]) {
  const float a = GROUP ? group_sum<GROUP>(dot_slice<HS>(row + x.hoff, y), x.G) +
                              row[(1 + C) * x.Hp]
                        : dot_slice<HS>(row, y) + row[(1 + C) * HS];
  return (a < 0.f) ? 0.f : a;
}

// Adds the staged chunk's products over the block's lanes to this thread's
// units of the chunk (and db2's columns once per VJP): summed over the
// lanes in order into a fresh partial first, so a unit's running sum takes
// one addition per VJP rather than one per lane and VJP.
template <int C, int HS, bool GROUP, int NREG>
__device__ __forceinline__ void bw_reduce(const BwdCtx& x, const Partials& part, int c,
                                          int rows, Tiles<NREG>& t) {
  const int LB = GROUP ? x.LB : BW_LANES, RR = GROUP ? x.RR : (1 + C) * HS + 4;
  const int NB = GROUP ? x.NB : 1 + C, NBQ = GROUP ? x.NBQ : C;
  for (int jj = 0; jj < x.UPC; ++jj) {
    const int u = threadIdx.x + jj * blockDim.x;
    const int k = u / NB, b = u - k * NB;
    if (4 * k >= rows) continue;
    const bool w1blk = b >= NBQ, db1 = b == NBQ, db2 = c == 0 && k == 0 && !w1blk;
    const float* lp = x.left + (w1blk ? LB * x.S : 0) + 4 * k;
    const float* rp = x.right + 8 * b;
    float sum[4][8], sum_b1[4], sum_b2[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sum_b1[e] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum[e][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) sum_b2[j] = 0.f;
#pragma unroll 2
    for (int l = 0; l < LB; ++l) {
      const float4 lv = *reinterpret_cast<const float4*>(lp + l * x.S);
      const float4 r0 = *reinterpret_cast<const float4*>(rp + l * RR);
      const float4 r1 = *reinterpret_cast<const float4*>(rp + l * RR + 4);
      const float L[4] = {lv.x, lv.y, lv.z, lv.w};
      const float Rt[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int j = 0; j < 8; ++j) sum[e][j] = fmaf(L[e], Rt[j], sum[e][j]);
      }
      if (db1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sum_b1[e] += L[e];
      }
      if (db2) {
#pragma unroll
        for (int j = 0; j < 8; ++j) sum_b2[j] += Rt[j];
      }
    }
    const int us = c * x.UPC + jj;
    if (us < NREG) {
#pragma unroll
      for (int q = 0; q < NREG; ++q) {
        if (q != us) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          t.b1[q][e] += sum_b1[e];
#pragma unroll
          for (int j = 0; j < 8; ++j) t.w[q][e][j] += sum[e][j];
        }
      }
    } else {
      part.unit(c, k, b, sum, sum_b1, true);
    }
    if (db2) {
#pragma unroll
      for (int j = 0; j < 8; ++j) t.b2[j] += sum_b2[j];
    }
  }
}

// One evaluation k = f(y) along dx and its VJP for the cotangent u of k, for
// this thread's lane and slice: k, dy and ddx (whole, in every rank), and
// the evaluation's weight gradients, summed over the block's lanes, added to
// the units.  Every thread of the block calls it (lanes past the batch with
// zero state and cotangent).
template <int C, int HS, bool GROUP, int NREG>
__device__ __forceinline__ void bw_vjp(const BwdCtx& x, const Partials& part, Ring& ring,
                                       const float (&u)[HS], const float (&y)[HS],
                                       const float (&dx)[C], float (&k)[HS], float (&dy)[HS],
                                       float (&ddx)[C], Tiles<NREG>& t) {
  // One thread a lane: every stride and offset known at compile time.
  const int Hp = GROUP ? x.Hp : HS, hoff = GROUP ? x.hoff : 0;
  const int RS = GROUP ? x.RS : (1 + C) * HS + 4;
  float pre2[C][HS];
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = 0; j < HS; ++j) pre2[i][j] = 0.f;
  }
  for (int c = 0; c < x.R; ++c) {
    const float* rc = chunk_rows(x, ring, c);
    const int rows = x.W4 - c * x.CR < x.CR ? x.W4 - c * x.CR : x.CR;
#pragma unroll 4
    for (int w = 0; w < rows; ++w) {
      const float* row = rc + (size_t)w * RS;
      const float a = bw_hidden<C, HS, GROUP>(x, row, y);
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const float4* r2 = reinterpret_cast<const float4*>(row + (1 + i) * Hp + hoff);
#pragma unroll
        for (int j = 0; j < HS / 4; ++j) {
          const float4 v = r2[j];
          pre2[i][4 * j] = fmaf(v.x, a, pre2[i][4 * j]);
          pre2[i][4 * j + 1] = fmaf(v.y, a, pre2[i][4 * j + 1]);
          pre2[i][4 * j + 2] = fmaf(v.z, a, pre2[i][4 * j + 2]);
          pre2[i][4 * j + 3] = fmaf(v.w, a, pre2[i][4 * j + 3]);
        }
      }
    }
  }
  float g[C][HS];
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = 0; j < HS; ++j) g[i][j] = tanhf(pre2[i][j] + x.b2s[i * Hp + hoff + j]);
  }
#pragma unroll
  for (int j = 0; j < HS; ++j) {
    float acc = g[0][j] * dx[0];
#pragma unroll
    for (int i = 1; i < C; ++i) acc += g[i][j] * dx[i];
    k[j] = acc;
  }
  float dp2[C][HS];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < HS; ++j) {
      acc += u[j] * g[i][j];
      dp2[i][j] = (u[j] * dx[i]) * (1.f - g[i][j] * g[i][j]);
    }
    ddx[i] = group_sum<GROUP>(acc, x.G);
  }
  float* right = x.right + x.l * (GROUP ? x.RR : (1 + C) * HS + 4);
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = 0; j < HS / 4; ++j)
      reinterpret_cast<float4*>(right + i * Hp + hoff)[j] =
          make_float4(dp2[i][4 * j], dp2[i][4 * j + 1], dp2[i][4 * j + 2], dp2[i][4 * j + 3]);
  }
#pragma unroll
  for (int j = 0; j < HS / 4; ++j)
    reinterpret_cast<float4*>(right + C * Hp + hoff)[j] =
        make_float4(y[4 * j], y[4 * j + 1], y[4 * j + 2], y[4 * j + 3]);
#pragma unroll
  for (int j = 0; j < HS; ++j) dy[j] = 0.f;

  float4* h1s = reinterpret_cast<float4*>(x.left + x.l * x.S);
  float4* dp1s = reinterpret_cast<float4*>(x.left + (x.LB + x.l) * x.S);
  for (int c = 0; c < x.R; ++c) {
    const float* rc = chunk_rows(x, ring, c);
    const int rows = x.W4 - c * x.CR < x.CR ? x.W4 - c * x.CR : x.CR;
    for (int wq = 0; wq < rows; wq += 4) {
      float hq[4], pq[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* row = rc + (size_t)(wq + e) * RS;
        const float h = bw_hidden<C, HS, GROUP>(x, row, y);
        float dh = 0.f;
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const float4* r2 = reinterpret_cast<const float4*>(row + (1 + i) * Hp + hoff);
#pragma unroll
          for (int j = 0; j < HS / 4; ++j) {
            const float4 v = r2[j];
            dh = fmaf(v.x, dp2[i][4 * j], dh);
            dh = fmaf(v.y, dp2[i][4 * j + 1], dh);
            dh = fmaf(v.z, dp2[i][4 * j + 2], dh);
            dh = fmaf(v.w, dp2[i][4 * j + 3], dh);
          }
        }
        dh = group_sum<GROUP>(dh, x.G);
        const float p = h > 0.f ? dh : 0.f;
        const float4* r1 = reinterpret_cast<const float4*>(row + hoff);
#pragma unroll
        for (int j = 0; j < HS / 4; ++j) {
          const float4 v = r1[j];
          dy[4 * j] = fmaf(v.x, p, dy[4 * j]);
          dy[4 * j + 1] = fmaf(v.y, p, dy[4 * j + 1]);
          dy[4 * j + 2] = fmaf(v.z, p, dy[4 * j + 2]);
          dy[4 * j + 3] = fmaf(v.w, p, dy[4 * j + 3]);
        }
        hq[e] = h;
        pq[e] = p;
      }
      if (!GROUP || x.r == ((wq >> 2) & (x.G - 1))) {
        h1s[wq / 4] = make_float4(hq[0], hq[1], hq[2], hq[3]);
        dp1s[wq / 4] = make_float4(pq[0], pq[1], pq[2], pq[3]);
      }
    }
    __syncthreads();
    bw_reduce<C, HS, GROUP, NREG>(x, part, c, rows, t);
    __syncthreads();
  }
}

template <int C, int HS, bool GROUP, int NREG>
__global__ void __launch_bounds__(GROUP ? BW_THREADS : BW_LANES)
    rev_bwd_kernel(const float* __restrict__ ct, const float* __restrict__ yres,
                   const float* __restrict__ yhres, const float* __restrict__ gy,
                   const float* __restrict__ w1t, const float* __restrict__ b1,
                   const float* __restrict__ w2t, const float* __restrict__ b2,
                   const float4* __restrict__ staged, float* __restrict__ dct,
                   float* __restrict__ dz0, float* __restrict__ dw1p, float* __restrict__ db1p,
                   float* __restrict__ dw2p, float* __restrict__ db2p, BwdArgs a) {
  extern __shared__ float4 bw_smem[];
  const int H = a.H, B = a.B, W = a.W, Hp = a.Hp;
  const BwdLayout L(C, a);
  float* sm = reinterpret_cast<float*>(bw_smem);
  const int r = GROUP ? (int)threadIdx.x & (a.G - 1) : 0;
  const BwdCtx x{sm + L.rec, sm + L.b2s, sm + L.left, sm + L.right, L.RS, L.S, L.RR, Hp,
                 a.G, a.LB, a.W4, a.CR, a.R, a.UPC, (1 + C) * Hp / 8, C * Hp / 8,
                 a.streamed, (int)threadIdx.x / a.G, r, r * HS};
  const size_t blk = blockIdx.x;
  const Partials part{dw1p + blk * W * H, db1p + blk * W, dw2p + blk * W * C * H,
                      db2p + blk * C * H, H, C, W, Hp, a.CR};
  Ring ring(reinterpret_cast<float4*>(sm + L.rec), staged,
            a.streamed ? a.CR * L.RS / 4 : 0, a.R);
  if (!a.streamed) {
    for (int e = threadIdx.x; e < a.W4 * L.RS; e += blockDim.x)
      sm[L.rec + e] = rec_value(w1t, b1, w2t, H, C, W, Hp, e);
  }
  for (int i = threadIdx.x; i < C * Hp; i += blockDim.x) {
    const int ch = i / Hp, k = i - ch * Hp;
    sm[L.b2s + i] = k < H ? b2[ch * H + k] : 0.f;
  }
  Tiles<NREG> t;
#pragma unroll
  for (int q = 0; q < NREG; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      t.b1[q][e] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) t.w[q][e][j] = 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) t.b2[j] = 0.f;
  // The units past the registers sum in the block's slice of the partials.
  for (int c = 0; c < a.R; ++c) {
    for (int jj = 0; jj < a.UPC; ++jj) {
      const int u = threadIdx.x + jj * blockDim.x, k = u / x.NB;
      if (c * a.UPC + jj >= NREG && 4 * k < a.CR)
        part.unit(c, k, u - k * x.NB, t.w[0], t.b1[0], false);  // zeros
    }
  }
  __syncthreads();

  const float dtf = (float)a.dt, hdt = (float)(0.5 * a.dt);
  for (int grp = blockIdx.x; grp < (B + a.LB - 1) / a.LB; grp += gridDim.x) {
    const int lane = grp * a.LB + x.l;
    const bool live = lane < B;
    float ay[HS], ayh[HS];
#pragma unroll
    for (int j = 0; j < HS; ++j) ay[j] = ayh[j] = 0.f;

    for (int jr = 0; jr < a.n; ++jr) {
      const int j = a.n - 1 - jr;
      // Knot j + 1's cotangent enters as its interval's walk starts, from
      // the state stored there (lanes past the batch walk zeros).
      float y1[HS], yh1[HS];
#pragma unroll
      for (int jj = 0; jj < HS; ++jj) {
        const int h = x.hoff + jj;
        const bool ok = live && h < H;
        const size_t at = ((size_t)j * H + h) * B + lane;
        if (ok) ay[jj] += gy[at];
        y1[jj] = ok ? yres[at] : 0.f;
        yh1[jj] = ok ? yhres[at] : 0.f;
      }
      float sb[C], sc[C], sd[C];
      load_slab<HS, C>(ct, j, B, lane, live, sb, sc, sd);
      float acc_b[C], acc_c[C], acc_d[C];
#pragma unroll
      for (int i = 0; i < C; ++i) acc_b[i] = acc_c[i] = acc_d[i] = 0.f;

      for (int st = a.m - 1; st >= 0; --st) {
        const float fr1 = fraction(st + 1, a.dt), fr0 = fraction(st, a.dt);
        float dx[C], ddx[C], u[HS], v[HS], f1[HS], f0[HS], yh0[HS];
        // The step's second evaluation: f1 = f(yh1) and its VJP.
        control_derivative<C>(sb, sc, sd, fr1, dx);
#pragma unroll
        for (int jj = 0; jj < HS; ++jj) u[jj] = hdt * ay[jj];
        bw_vjp<C, HS, GROUP, NREG>(x, part, ring, u, yh1, dx, f1, v, ddx, t);
#pragma unroll
        for (int i = 0; i < C; ++i) {
          acc_b[i] += ddx[i];
          acc_c[i] += fr1 * ddx[i];
          acc_d[i] += (fr1 * fr1) * ddx[i];
        }
        // The inverse map's companion, then its evaluation f0 = f(yh0) and VJP.
#pragma unroll
        for (int jj = 0; jj < HS; ++jj) {
          yh0[jj] = 2.f * y1[jj] - yh1[jj] - dtf * f1[jj];
          ayh[jj] += v[jj];
          u[jj] = hdt * ay[jj] + dtf * ayh[jj];
        }
        control_derivative<C>(sb, sc, sd, fr0, dx);
        bw_vjp<C, HS, GROUP, NREG>(x, part, ring, u, yh0, dx, f0, v, ddx, t);
#pragma unroll
        for (int i = 0; i < C; ++i) {
          acc_b[i] += ddx[i];
          acc_c[i] += fr0 * ddx[i];
          acc_d[i] += (fr0 * fr0) * ddx[i];
        }
#pragma unroll
        for (int jj = 0; jj < HS; ++jj) {
          y1[jj] = y1[jj] - hdt * (f1[jj] + f0[jj]);
          yh1[jj] = yh0[jj];
          ay[jj] = ay[jj] + 2.f * ayh[jj];
          ayh[jj] = -ayh[jj] + v[jj];
        }
      }
      if (live && x.r == 0) {
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
#pragma unroll
    for (int jj = 0; jj < HS; ++jj) {
      const int h = x.hoff + jj;
      if (live && h < H) dz0[(size_t)h * B + lane] = ay[jj] + ayh[jj];
    }
  }
  copy_wait();
  // The units held in registers, written once as the block's partial.
#pragma unroll
  for (int q = 0; q < NREG; ++q) {
    const int c = q / a.UPC, jj = q - c * a.UPC;
    const int u = threadIdx.x + jj * blockDim.x, k = u / x.NB;
    if (c < a.R && 4 * k < a.CR) part.unit(c, k, u - k * x.NB, t.w[q], t.b1[q], false);
  }
  if ((int)threadIdx.x < x.NBQ) {
    const int i = 8 * (int)threadIdx.x / Hp, h0 = 8 * (int)threadIdx.x - i * Hp;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (h0 + j < H) part.db2[i * H + h0 + j] = t.b2[j];
    }
  }
}

using BwdKernel = decltype(&rev_bwd_kernel<1, 8, false, 1>);

// The instances: every C, one thread a lane (H <= 8) or a group, one or two
// units in registers; C 1 at 16 components a thread (H > 256); every C at 4
// components a thread (small batches), two units in registers.  C 4 and 5
// in fused_reversible_bwd_wide.cu.
#define K8_BWD(c, hs, gr) \
  if (C == c && HS == hs && group == gr) \
    return nreg == 1 ? rev_bwd_kernel<c, hs, gr, 1> : rev_bwd_kernel<c, hs, gr, 2>;
#define K8_BWD_SMALL(c) \
  if (C == c && HS == SMALL_HS && group) return rev_bwd_kernel<c, SMALL_HS, true, 2>;
#ifdef K8_BWD_WIDE
BwdKernel wide_kernel(int C, int HS, bool group, int nreg) {
  K8_BWD(4, 8, false) K8_BWD(5, 8, false) K8_BWD(4, 8, true) K8_BWD(5, 8, true)
  K8_BWD_SMALL(4) K8_BWD_SMALL(5)
  return nullptr;
}

}  // namespace

extern "C" void* fr_backward_kernel_wide(int C, int HS, bool group, int nreg) {
  return reinterpret_cast<void*>(wide_kernel(C, HS, group, nreg));
}
#else
}  // namespace

extern "C" void* fr_backward_kernel_wide(int C, int HS, bool group, int nreg);

namespace {

BwdKernel bwd_kernel(int C, int HS, bool group, int nreg) {
  K8_BWD(1, 8, false) K8_BWD(2, 8, false) K8_BWD(3, 8, false) K8_BWD(1, 8, true)
  K8_BWD(2, 8, true) K8_BWD(3, 8, true) K8_BWD(1, 16, true)
  K8_BWD_SMALL(1) K8_BWD_SMALL(2) K8_BWD_SMALL(3)
  return reinterpret_cast<BwdKernel>(fr_backward_kernel_wide(C, HS, group, nreg));
}
#undef K8_BWD_SMALL
#undef K8_BWD

struct BwdPlan {
  BwdArgs a;
  int HS, group, nreg, blocks, threads, resident, sms, groups;
  size_t bytes, scratch;  // shared bytes a block; floats of staged records
};

// The backward launch for these shapes: the group, the block, the chunk of
// rows (128 with resident weights; streamed, as many as fit), the units, and
// as many blocks as the SMs hold at once, at most one per lane group.  On
// the group path, where the lane groups are fewer than half the SMs, each
// lane takes twice the threads, slices of 4 components (SMALL_HS): a lane's
// serial chain, not the SMs' occupancy, bounds a small batch, and fewer
// lanes a block spread the same warps over more SMs without shortening it
// (PERF.md, PR 22).  The one-thread path (H <= 8) keeps its 128 lanes.
int backward_plan(BwdPlan& p, int B, int H, int C, int W) {
  p.HS = (C == 1 && H > 8 * MAX_GROUP) ? 16 : 8;
  p.a.G = 1;
  while (p.a.G * p.HS < H) p.a.G *= 2;
  if (p.a.G > MAX_GROUP) return BAD_ARGUMENT;
  p.group = p.a.G > 1;
  p.a.Hp = p.a.G * p.HS;
  int dev = 0, rc = (int)cudaGetDevice(&dev);
  if (!rc) rc = (int)cudaDeviceGetAttribute(&p.sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc) return rc;
  if (p.group && p.HS == 8 && 2 * p.a.G <= MAX_GROUP &&
      2 * ((B + BW_THREADS / p.a.G - 1) / (BW_THREADS / p.a.G)) < p.sms) {
    p.HS = SMALL_HS;
    p.a.G = p.a.Hp / SMALL_HS;
  }
  p.a.LB = p.group ? BW_THREADS / p.a.G : BW_LANES;
  p.threads = p.a.LB * p.a.G;
  p.a.B = B;
  p.a.H = H;
  p.a.W = W;
  p.a.W4 = round4(W);
  p.a.streamed = 0;
  p.a.CR = ROW_CHUNK;
  auto bytes = [&] { return sizeof(float) * BwdLayout(C, p.a).total; };
  if (bytes() > MAX_SMEM) {
    p.a.streamed = 1;
    while (p.a.CR > 4 && bytes() > MAX_SMEM) p.a.CR -= 4;
  }
  p.bytes = bytes();
  if (p.bytes > MAX_SMEM) return BAD_ARGUMENT;
  const int NB = (1 + C) * p.a.Hp / 8;
  p.a.R = (p.a.W4 + p.a.CR - 1) / p.a.CR;
  p.a.UPC = (p.a.CR / 4 * NB + p.threads - 1) / p.threads;
  p.nreg = p.a.R * p.a.UPC >= 2 ? 2 : 1;
  p.scratch = p.a.streamed ? (size_t)p.a.R * p.a.CR * record_floats(C, p.a.Hp) : 0;
  const BwdKernel kernel = bwd_kernel(C, p.HS, p.group, p.nreg);
  if (!kernel) return BAD_ARGUMENT;
  rc = resident_blocks(kernel, p.threads, p.bytes, p.resident);
  if (rc) return rc;
  if (p.resident < 1) return BAD_ARGUMENT;
  p.groups = (B + p.a.LB - 1) / p.a.LB;
  p.blocks = std::min<long>(p.groups, (long)p.resident * p.sms);
  return 0;
}

}  // namespace

extern "C" {

// The backward launch for these shapes, into out[8]: the weights' path (0
// resident in shared memory, 1 streamed), blocks (the leading size of the
// weight partials), threads a block, lanes a block, blocks an SM holds,
// SMs, lane groups (blocks stride over them), shared bytes a block.
int fr_backward_plan(int B, int H, int C, int W, long* out) {
  BwdPlan p;
  int rc = check_call(B, 1, H, C, W, 1);
  if (!rc) rc = backward_plan(p, B, H, C, W);
  if (rc) return rc;
  const long values[] = {p.a.streamed, p.blocks, p.threads, p.a.LB,
                         p.resident, p.sms, p.groups, (long)p.bytes};
  for (int i = 0; i < 8; ++i) out[i] = values[i];
  return 0;
}

// The floats of scratch fr_backward needs for these shapes (0 when the
// weights are resident), into out: its plan's chunks of rows, which hang on
// the lanes a block and so on the batch.
int fr_backward_scratch(int B, int H, int C, int W, long* out) {
  BwdPlan p;
  int rc = check_call(B, 1, H, C, W, 1);
  if (!rc) rc = backward_plan(p, B, H, C, W);
  if (rc) return rc;
  *out = (long)p.scratch;
  return 0;
}

// The backward launch of fr_backward_plan's blocks, which the caller passes
// and this entry checks against its own plan.
int fr_backward(const float* ct, const float* yres, const float* yhres, const float* gy,
                const float* w1t, const float* b1, const float* w2t, const float* b2,
                float* dct, float* dz0, float* dw1p, float* db1p, float* dw2p, float* db2p,
                float* scratch, int B, int n, int H, int C, int W, int m, double dt,
                int blocks, void* stream) {
  BwdPlan p;
  int rc = check_call(B, n, H, C, W, m);
  if (!rc) rc = backward_plan(p, B, H, C, W);
  if (rc) return rc;
  if (p.blocks != blocks || (p.scratch && !scratch)) return BAD_ARGUMENT;
  p.a.n = n;
  p.a.m = m;
  p.a.dt = dt;
  cudaStream_t st = (cudaStream_t)stream;
  if (p.a.streamed) {
    rc = stage_records(w1t, b1, w2t, H, C, W, p.a.Hp, p.a.R * p.a.CR, scratch, st);
    if (rc) return rc;
  }
  bwd_kernel(C, p.HS, p.group, p.nreg)<<<p.blocks, p.threads, p.bytes, st>>>(
      ct, yres, yhres, gy, w1t, b1, w2t, b2, reinterpret_cast<const float4*>(scratch), dct,
      dz0, dw1p, db1p, dw2p, db2p, p.a);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif  // K8_BWD_WIDE
