// Backward of the fixed-step Neural CDE solve (K1) on Hopper (sm_90a): the
// kernel that walks the intervals in reverse, its plan and its launch, for
// either mode; fused_fixed_bwd.cu builds the float32 mode and the entries,
// fused_fixed_bwd_bf16.cu the bfloat16 mode (two sources, so that nvcc
// builds the modes in parallel).  What it computes, what bounds it and how
// it relates to the forward: the notes at the top of fused_fixed.cu; the
// lane group's evaluation: fused_fixed.cuh.
//
// Replaces torchcde_tpu/solvers/fused_pallas.py::_bwd_kernel, which walks a
// tile of lanes per program and sums the tile's weight gradients over every
// interval as products over its lanes.  Here a block's lanes are the tile.
// Per interval the lane's group recomputes the substep chain from the stored
// knot state, then walks the substeps and stages in reverse; per VJP:
//   * the evaluation (lane_eval), staging each row's h1 for the lane in
//     shared memory (the left operands, beside dp1 of the same rows);
//   * dp2 on the slice's rows and the slice's part of ddx, summed over the
//     slices by a butterfly (every thread gets the same bits);
//   * the right operands (dp2 and y as the products take them, and in the
//     bfloat16 mode the unrounded dp2 for db2) into the lane's row in shared
//     memory;
//   * a second walk of the thread's rows: dh_w = W2[., w] . dp2 summed over
//     the slices, p = dh where h1 > 0 (dp1, staged), and W1[w]^T p added to
//     the slice's dy, summed over the slice's row threads at the end.
// Then the block reduces the staged products over its lanes as a product: a
// unit of 4 rows x 4 columns, of dW2 (left h1, columns of dp2) or of dW1
// (left dp1, columns of y), with db1 and db2 beside, is summed over the lanes
// in order into a fresh partial, which is added to the unit's running sum
// once per VJP.  Unit u of a chunk of 128 rows (row quad u / NB, column
// block u % NB, NB = (1 + C) Hp / 4 blocks) belongs to thread u % T; the
// first NREG (1 or 2) of a thread's units sit in registers for the whole
// walk and are written once, as the block's partial, the rest in the block's
// own slice of the partials, read and written once per VJP, never per lane.
// At the flagship (H 8, C 3, W 128, 32 lanes a block) thread (lane k, r)
// owns exactly unit (quad k, block r): one register tile.  Every sum runs in
// a fixed order, without atomics: two launches give the same bits.
//
// Mixed precision (MX): the operands of each product are rounded to
// bfloat16 where the JAX kernel's _stage_forward and _stage_backward (_dg)
// feed bfloat16 to its matrix unit: y and h1 in the evaluation, dp2 in dh1
// and dW2, h1 in dW2, dp1 in dy and dW1, y in dW1; db1 and db2 sum the
// unrounded dp1 and dp2 (a lane's unrounded dp2 is staged beside the
// rounded one); where H % 8 != 0 also u and dx in dp2 and round(u) g in ddx
// (the padded layout's selection products).

#pragma once

#include "fused_fixed.cuh"

namespace {

constexpr int RED_ROWS = 128;  // rows a chunk of the reduction: 32 row quads

// Row stride of the staged h1 and dp1: the rows rounded up to 8 (mod 32), so
// that the stores of a warp's lanes fall in distinct banks.
__host__ __device__ inline int left_stride(int rows) {
  return rows + ((8 - rows) % 32 + 32) % 32;
}

// Floats of a lane's right operands: dp2 (C Hp) and y (Hp) as the products
// take them, the unrounded dp2 (C Hp, the bfloat16 mode's db2), pad.
__host__ __device__ inline int right_floats(int C, int Hp) { return (1 + 2 * C) * Hp + 4; }

// A thread's share of the block's weight gradients held in registers.
template <int NREG>
struct Tiles {
  float w[NREG][4][4];  // rows 4k + e, columns 4b + j of its units
  float b1[NREG][4];    // db1 of those rows (units of the first dW1 block)
  float b2[NREG][4];    // db2 of those columns (chunk 0's first row quad, dW2)
};

// The block's partials (the slice of this block) and where a unit goes.
struct Partials {
  float *dw1, *db1, *dw2, *db2;
  int H, C, W, Hp, NBQ;

  // Stores (or adds) unit (chunk c, row quad k, column block b) of the
  // block's gradients: 4 rows x 4 columns, db1 of the rows and db2 of the
  // columns with them, columns past H and rows past W dropped.
  __device__ void unit(int c, int k, int b, const float (&v)[4][4], const float (&vb1)[4],
                       const float (&vb2)[4], bool add) const {
    int i = 0, h0;
    if (b >= NBQ) {
      h0 = 4 * (b - NBQ);
    } else {
      i = 4 * b / Hp;
      h0 = 4 * b - i * Hp;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int w = c * RED_ROWS + 4 * k + e;
      if (w >= W) continue;
      float* row = b >= NBQ ? dw1 + (size_t)w * H : dw2 + (size_t)w * C * H + i * H;
      if (b == NBQ) db1[w] = add ? db1[w] + vb1[e] : vb1[e];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (h0 + j < H) row[h0 + j] = add ? row[h0 + j] + v[e][j] : v[e][j];
      }
    }
    if (c == 0 && k == 0 && b < NBQ) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (h0 + j < H) db2[i * H + h0 + j] = add ? db2[i * H + h0 + j] + vb2[j] : vb2[j];
      }
    }
  }
};

// What a thread of the backward needs besides its lane's evaluation.
struct BwdLane : Lane {
  float* h1;     // [LB][S] the lanes' h1 ...
  float* dp1;    // [LB][S] ... and dp1, 16 floats (half the banks) further on
  float* right;  // [LB][RR]
  int S, RR, NB, NBQ, UPC, RCH;  // strides; column blocks (all, dW2's); units a thread a chunk; chunks
};

// Adds chunk c of the staged products over the block's lanes to this
// thread's units of the chunk: summed over the lanes in order into a fresh
// partial first, so a unit's running sum takes one addition per VJP rather
// than one per lane and VJP.
template <class K, int NREG, bool MX>
__device__ __forceinline__ void slice_reduce(const BwdLane& x, const Partials& part, int c,
                                             Tiles<NREG>& t) {
  const int NB = K::SLICED ? x.NB : (1 + K::C) * K::HS / 4;
  const int NBQ = K::SLICED ? x.NBQ : K::C * K::HS / 4;
  const int DP2 = (1 + K::C) * lane_hp<K>(x), LB = blockDim.x / (K::SLICED ? x.G : K::GW);
  for (int jj = 0; jj < x.UPC; ++jj) {
    const int u = threadIdx.x + jj * blockDim.x;
    const int k = u / NB, b = u - k * NB;
    const int row0 = c * RED_ROWS + 4 * k;
    if (4 * k >= RED_ROWS || row0 >= x.rows) continue;
    const bool w1blk = b >= NBQ, db1 = b == NBQ, db2 = c == 0 && k == 0 && !w1blk;
    const float* lp = (w1blk ? x.dp1 : x.h1) + row0;
    const float* rp = x.right + 4 * b;
    float sum[4][4], sum_b1[4], sum_b2[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sum_b1[e] = sum_b2[e] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum[e][j] = 0.f;
    }
#pragma unroll 2
    for (int l = 0; l < LB; ++l) {
      const float4 lv = *reinterpret_cast<const float4*>(lp + l * x.S);
      const float4 rv = *reinterpret_cast<const float4*>(rp + l * x.RR);
      const float L[4] = {lv.x, lv.y, lv.z, lv.w};
      const float Rt[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float le = mx_round<MX>(L[e]);
#pragma unroll
        for (int j = 0; j < 4; ++j) sum[e][j] = fmaf(le, Rt[j], sum[e][j]);
      }
      if (db1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sum_b1[e] += L[e];
      }
      if (db2) {
        const float4 v = MX ? *reinterpret_cast<const float4*>(rp + l * x.RR + DP2) : rv;
        sum_b2[0] += v.x;
        sum_b2[1] += v.y;
        sum_b2[2] += v.z;
        sum_b2[3] += v.w;
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
          t.b2[q][e] += sum_b2[e];
#pragma unroll
          for (int j = 0; j < 4; ++j) t.w[q][e][j] += sum[e][j];
        }
      }
    } else {
      part.unit(c, k, b, sum, sum_b1, sum_b2, true);
    }
  }
}

// VJP of one evaluation k = contract(mlp(y), dx) for the cotangent u of k,
// for lane l by its group: dy (the slice's, the same bits in each of the
// slice's threads), ddx (whole, in every thread of the group), and the
// evaluation's weight gradients, summed over the block's lanes, added to the
// units.  Every thread of the block calls it (lanes past the batch with zero
// state and cotangent).
template <class K, int NREG, bool MX>
__device__ __forceinline__ void slice_vjp(const BwdLane& x, const Partials& part, Ring* ring,
                                          int l, const float (&u)[K::HS],
                                          const float (&y)[K::HS], const float (&dx)[K::C],
                                          float (&dy)[K::HS], float (&ddx)[K::C],
                                          Tiles<NREG>& t) {
  constexpr int C = K::C, HS = K::HS, GW = K::GW, N = K::N;
  const int Hp = lane_hp<K>(x), RS = lane_rs<K>(x), hoff = lane_hoff<K>(x);
  float g[N];
  lane_eval<K, MX, true>(x, ring, x.h1 + l * x.S, y, g);
  // With the padded layout's selection products (bfloat16, H % 8 != 0), u
  // and dx enter dp2 rounded and each term of ddx is round(round(u) g).
  const bool rsel = MX && x.sel;
  float dp2[N];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const float dxi = rsel ? mx_round<true>(dx[i]) : dx[i];
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < HS; ++j) {
      const int q = i * HS + j;
      const float uj = rsel ? mx_round<true>(u[j]) : u[j];
      acc += rsel ? mx_round<true>(uj * g[q]) : uj * g[q];
      dp2[q] = (uj * dxi) * (1.f - g[q] * g[q]);
    }
    ddx[i] = slice_sum<K>(acc, x);
  }
  // The slice's float4s of the lane's right operands, float4 f of them by
  // row thread f % GW: dp2 and y rounded as the products take them, and
  // (MX) the unrounded dp2.
  float* right = x.right + l * x.RR;
  if (MX) {
#pragma unroll
    for (int i = 0; i < C; ++i) {
#pragma unroll
      for (int j = 0; j < HS / 4; ++j) {
        const int at = (1 + C) * Hp + i * Hp + hoff + 4 * j;
        if ((at / 4) % GW == x.rw)
          *reinterpret_cast<float4*>(right + at) =
              make_float4(dp2[i * HS + 4 * j], dp2[i * HS + 4 * j + 1], dp2[i * HS + 4 * j + 2],
                          dp2[i * HS + 4 * j + 3]);
      }
    }
#pragma unroll
    for (int q = 0; q < N; ++q) dp2[q] = mx_round<MX>(dp2[q]);
  }
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = 0; j < HS / 4; ++j) {
      const int at = i * Hp + hoff + 4 * j;
      if ((at / 4) % GW == x.rw)
        *reinterpret_cast<float4*>(right + at) =
            make_float4(dp2[i * HS + 4 * j], dp2[i * HS + 4 * j + 1], dp2[i * HS + 4 * j + 2],
                        dp2[i * HS + 4 * j + 3]);
    }
  }
#pragma unroll
  for (int j = 0; j < HS / 4; ++j) {
    const int at = C * Hp + hoff + 4 * j;
    if ((at / 4) % GW == x.rw)
      *reinterpret_cast<float4*>(right + at) =
          make_float4(mx_round<MX>(y[4 * j]), mx_round<MX>(y[4 * j + 1]),
                      mx_round<MX>(y[4 * j + 2]), mx_round<MX>(y[4 * j + 3]));
  }
#pragma unroll
  for (int h = 0; h < HS; ++h) dy[h] = 0.f;
  const float* h1 = x.h1 + l * x.S;
  float* dp1 = x.dp1 + l * x.S;
  if (K::SLICED) __syncwarp();  // h1 was staged by the lane's first slice
  const int R = K::SLICED ? x.R : 1;
  for (int c = 0; c < R; ++c) {
    const float* rc = chunk_rows<K>(x, ring, c);
    const int rows = K::SLICED ? min(x.CR, x.rows - c * x.CR) : x.rows;
    const int base = K::SLICED ? c * x.CR : 0;
#pragma unroll 2
    for (int w = x.rw; w < rows; w += GW) {
      const float* rec = rc + w * RS;
      float dh = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const float4* r2 = reinterpret_cast<const float4*>(rec + (1 + i) * Hp + hoff);
#pragma unroll
        for (int j = 0; j < HS / 4; ++j) {
          const float4 v = r2[j];
          dh = fmaf(v.x, dp2[i * HS + 4 * j], dh);
          dh = fmaf(v.y, dp2[i * HS + 4 * j + 1], dh);
          dh = fmaf(v.z, dp2[i * HS + 4 * j + 2], dh);
          dh = fmaf(v.w, dp2[i * HS + 4 * j + 3], dh);
        }
      }
      dh = slice_sum<K>(dh, x);
      const float p = h1[base + w] > 0.f ? dh : 0.f;
      if (!K::SLICED || x.s == 0) dp1[base + w] = p;
      const float pr = mx_round<MX>(p);
      const float4* r1 = reinterpret_cast<const float4*>(rec + hoff);
#pragma unroll
      for (int j = 0; j < HS / 4; ++j) {
        const float4 v = r1[j];
        dy[4 * j] = fmaf(v.x, pr, dy[4 * j]);
        dy[4 * j + 1] = fmaf(v.y, pr, dy[4 * j + 1]);
        dy[4 * j + 2] = fmaf(v.z, pr, dy[4 * j + 2]);
        dy[4 * j + 3] = fmaf(v.w, pr, dy[4 * j + 3]);
      }
    }
  }
  row_sum<GW>(dy);
  __syncthreads();
  for (int c = 0; c < x.RCH; ++c) slice_reduce<K, NREG, MX>(x, part, c, t);
  __syncthreads();
}

// The reverse walk of the lane groups this block strides over.
template <class K, int NREG, typename T, bool MX>
__device__ __forceinline__ void backward_lanes(const BwdLane& x, const Partials& part, Ring* ring,
                                               Tiles<NREG>& t, const T* __restrict__ ct,
                                               const float* __restrict__ zres,
                                               const float* __restrict__ z0t,
                                               const float* __restrict__ gz,
                                               const int* __restrict__ slot,
                                               T* __restrict__ dct, float* __restrict__ dz0,
                                               int B, int n, int H, int m, double dt,
                                               const Tableau& tab) {
  constexpr int C = K::C, HS = K::HS;
  const int G = K::SLICED ? x.G : K::GW, hoff = lane_hoff<K>(x);
  const int l = threadIdx.x / G, LB = blockDim.x / G, r = threadIdx.x % G;
  const int S = tab.n_stages;
  for (int grp = blockIdx.x; grp < (B + LB - 1) / LB; grp += gridDim.x) {
    const int lane = grp * LB + l;
    const bool live = lane < B;
    float lam[HS];
#pragma unroll
    for (int h = 0; h < HS; ++h) lam[h] = 0.f;
    float zs[MAX_SUBSTEPS][HS];

    for (int jr = 0; jr < n; ++jr) {
      const int j = n - 1 - jr;
      // Fold in the cotangent of a requested knot at this interval's end.
      const int sl = slot[j];
      if (live && sl >= 0) {
#pragma unroll
        for (int h = 0; h < HS; ++h) {
          if (hoff + h < H) lam[h] += gz[((size_t)sl * H + hoff + h) * B + lane];
        }
      }
      float sb[C], sc[C], sd[C];
      load_slab<HS, C, T>(ct, j, B, lane, live, sb, sc, sd);
      // Interval j starts from knot j: z0 or the residual of interval j - 1.
#pragma unroll
      for (int h = 0; h < HS; ++h) {
        float v = 0.f;
        if (live && hoff + h < H)
          v = j == 0 ? z0t[(size_t)(hoff + h) * B + lane]
                     : zres[((size_t)(j - 1) * H + hoff + h) * B + lane];
        zs[0][h] = v;
      }
      // Recompute the substep chain z_0 .. z_{m-1}.
      for (int step = 0; step + 1 < m; ++step) {
        float z[HS];
#pragma unroll
        for (int h = 0; h < HS; ++h) z[h] = zs[step][h];
        slice_substep<K, MX>(x, ring, tab, step, dt, sb, sc, sd, z, nullptr);
#pragma unroll
        for (int h = 0; h < HS; ++h) zs[step + 1][h] = z[h];
      }

      float acc_b[C], acc_c[C], acc_d[C];
#pragma unroll
      for (int i = 0; i < C; ++i) acc_b[i] = acc_c[i] = acc_d[i] = 0.f;
      for (int step = m - 1; step >= 0; --step) {
        float ys[MAX_STAGES][HS];
        {
          float z[HS];
#pragma unroll
          for (int h = 0; h < HS; ++h) z[h] = zs[step][h];
          slice_substep<K, MX>(x, ring, tab, step, dt, sb, sc, sd, z, ys);
        }
        float v[MAX_STAGES][HS];
        for (int st = S - 1; st >= 0; --st) {
          float u[HS], y[HS], dy[HS], dx[C], ddx[C];
#pragma unroll
          for (int h = 0; h < HS; ++h) {
            float uh = tab.c_dt[st] != 0.f ? tab.c_dt[st] * lam[h] : 0.f;
            if (st + 1 < S) uh += tab.a_dt[st + 1] * v[st + 1][h];
            u[h] = uh;
            y[h] = ys[st][h];
          }
          const float fr = stage_fraction(tab, step, st, dt);
          control_derivative<C>(sb, sc, sd, fr, dx);
          slice_vjp<K, NREG, MX>(x, part, ring, l, u, y, dx, dy, ddx, t);
#pragma unroll
          for (int i = 0; i < C; ++i) {
            acc_b[i] += ddx[i];
            acc_c[i] += fr * ddx[i];
            acc_d[i] += (fr * fr) * ddx[i];
          }
#pragma unroll
          for (int h = 0; h < HS; ++h) v[st][h] = dy[h];
        }
        for (int st = 0; st < S; ++st) {
#pragma unroll
          for (int h = 0; h < HS; ++h) lam[h] += v[st][h];
        }
      }
      if (live && r == 0) {
        T* row = dct + (size_t)j * 3 * C * B + lane;
#pragma unroll
        for (int i = 0; i < C; ++i) {
          store_as(row + (size_t)i * B, acc_b[i]);
          store_as(row + (size_t)(C + i) * B, acc_c[i]);
          store_as(row + (size_t)(2 * C + i) * B, acc_d[i]);
        }
      }
    }
    if (live && x.rw == 0) {
#pragma unroll
      for (int h = 0; h < HS; ++h) {
        if (hoff + h < H) dz0[(size_t)(hoff + h) * B + lane] = lam[h];
      }
    }
  }
}

template <int C, int HS, int GW, bool SLICED, int NREG, typename T, bool MX>
__global__ void __launch_bounds__(FB_THREADS)
    bwd_slice_kernel(const T* __restrict__ ct, const float* __restrict__ zres,
                     const float* __restrict__ z0t, const float* __restrict__ gz,
                     const float* __restrict__ w1t, const float* __restrict__ b1,
                     const float* __restrict__ w2t, const float* __restrict__ b2,
                     const float4* __restrict__ staged, const int* __restrict__ slot,
                     T* __restrict__ dct, float* __restrict__ dz0, float* __restrict__ dw1p,
                     float* __restrict__ db1p, float* __restrict__ dw2p,
                     float* __restrict__ db2p, int B, int n, int H, int W, int m, double dt,
                     Tableau tab, Cut cut) {
  using K = Shape<C, HS, GW, SLICED>;
  extern __shared__ float4 fb_smem[];
  float* sm = reinterpret_cast<float*>(fb_smem);
  const int Hp = SLICED ? cut.Hp : HS, G = SLICED ? cut.G : GW;
  const int rows = walk_rows(W), RS = record_floats(C, Hp);
  const int S = left_stride(rows), RR = right_floats(C, Hp), LB = blockDim.x / G;
  const bool streamed = SLICED && cut.streamed;
  // Shared memory: the records (every row, or the ring's two chunks), b2 by
  // slice, h1 and dp1 of every row per lane, the lanes' right operands.
  float* b2s = sm + (size_t)(streamed ? 2 * cut.CR : rows) * RS;
  float* h1s = b2s + C * Hp;
  float* dp1s = h1s + LB * S + 16;
  float* rights = dp1s + LB * S;
  if (!streamed) load_records(sm, w1t, b1, w2t, H, C, W, Hp, rows);
  load_b2(b2s, b2, H, C, Hp);
  const int r = threadIdx.x % G, s = r / GW;
  const int NB = (1 + C) * Hp / 4, NBQ = C * Hp / 4;
  const int UPC = (RED_ROWS / 4 * NB + blockDim.x - 1) / blockDim.x;
  const int RCH = (rows + RED_ROWS - 1) / RED_ROWS;
  const BwdLane x{{sm, b2s, Hp, RS, G, rows, streamed ? cut.CR : rows, streamed ? cut.R : 1, s,
                   r % GW, s * HS, streamed, H % 8 != 0},
                  h1s, dp1s, rights, S, RR, NB, NBQ, UPC, RCH};
  const size_t blk = blockIdx.x;
  const Partials part{dw1p + blk * W * H, db1p + blk * W, dw2p + blk * W * C * H,
                      db2p + blk * C * H, H, C, W, Hp, NBQ};
  Tiles<NREG> t;
#pragma unroll
  for (int q = 0; q < NREG; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      t.b1[q][e] = t.b2[q][e] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) t.w[q][e][j] = 0.f;
    }
  }
  // The units past the registers sum in the block's slice of the partials.
  for (int c = 0; c < RCH; ++c) {
    for (int jj = 0; jj < UPC; ++jj) {
      const int u = threadIdx.x + jj * blockDim.x, k = u / NB;
      if (c * UPC + jj >= NREG && 4 * k < RED_ROWS && c * RED_ROWS + 4 * k < rows)
        part.unit(c, k, u - k * NB, t.w[0], t.b1[0], t.b2[0], false);  // zeros
    }
  }
  if constexpr (SLICED) {
    Ring ring(fb_smem, staged, streamed ? cut.CR * RS / 4 : 0, cut.R);
    __syncthreads();
    backward_lanes<K, NREG, T, MX>(x, part, &ring, t, ct, zres, z0t, gz, slot, dct, dz0, B, n,
                                   H, m, dt, tab);
    copy_wait();
  } else {
    __syncthreads();
    backward_lanes<K, NREG, T, MX>(x, part, nullptr, t, ct, zres, z0t, gz, slot, dct, dz0, B,
                                   n, H, m, dt, tab);
  }
  // The units held in registers, written once as the block's partial.
#pragma unroll
  for (int q = 0; q < NREG; ++q) {
    const int c = q / UPC, jj = q - c * UPC;
    const int u = threadIdx.x + jj * blockDim.x, k = u / NB;
    if (c < RCH && 4 * k < RED_ROWS && c * RED_ROWS + 4 * k < rows)
      part.unit(c, k, u - k * NB, t.w[q], t.b1[q], t.b2[q], false);
  }
}

template <typename T, bool MX>
using BwdKernel = decltype(&bwd_slice_kernel<1, 8, 8, false, 1, T, MX>);

// The register units of an instance whose threads have one unit in all: one
// for the flagship's (one slice, C 3), else the two-unit instance.
constexpr int one_unit(int C, bool sliced) { return sliced || C != 3 ? 2 : 1; }

template <typename T, bool MX>
BwdKernel<T, MX> backward_kernel(const Slicing& sl, int C, int nreg) {
#define K1_BWD(c, hs, gw, sliced)                                         \
  (nreg == 1 ? bwd_slice_kernel<c, hs, gw, sliced, one_unit(c, sliced), T, MX> \
             : bwd_slice_kernel<c, hs, gw, sliced, 2, T, MX>)
  K1_INSTANCES(K1_BWD)
#undef K1_BWD
  return nullptr;
}

// Floats of the backward's shared memory with `recs` floats of records.
inline size_t backward_floats(int C, int Hp, int rows, int lanes, size_t recs) {
  return recs + (size_t)C * Hp + 2 * (size_t)lanes * left_stride(rows) + 16 +
         (size_t)lanes * right_floats(C, Hp);
}

// The backward launch for these shapes: the group; the lanes a block (the
// small-batch rule while every unit of a thread stays in registers, then
// fewer while the resident weights and the staged products do not fit,
// down to one warp); the weights resident, or else streamed in chunks as
// large as fit beside the small-batch rule's lanes; the register units; as
// many blocks as the SMs hold at once, at most one per lane group.
template <typename T, bool MX>
int backward_plan(LaunchPlan& p, int B, int H, int C, int W) {
  p.sl = slicing(H, C);
  if (p.sl.G > MAX_GROUP) return BAD_ARGUMENT;
  int rc = card_sms(p.sms);
  if (rc) return rc;
  const int Hp = p.sl.Hp, RS = record_floats(C, Hp);
  const size_t most = MAX_SMEM / sizeof(float);
  p.rows = walk_rows(W);
  const int NB = (1 + C) * Hp / 4, chunks = (p.rows + RED_ROWS - 1) / RED_ROWS;
  const auto units = [&](int lanes) {  // a thread's units of the weight gradients
    const int threads = lanes * p.sl.G;
    return chunks * ((RED_ROWS / 4 * NB + threads - 1) / threads);
  };
  const int lanes = small_batch_lanes(FB_THREADS / p.sl.G, p.sl.G, B, p.sms, 32,
                                      [&](int l) { return units(l) <= 2; });
  p.lanes = lanes;
  const size_t resident = (size_t)p.rows * RS;
  while (backward_floats(C, Hp, p.rows, p.lanes, resident) > most && p.lanes * p.sl.G > 32)
    p.lanes /= 2;
  p.streamed = backward_floats(C, Hp, p.rows, p.lanes, resident) > most;
  p.CR = p.rows;
  p.R = 1;
  p.scratch = 0;
  if (p.streamed) {
    if (p.sl.GS == 1) return BAD_LAUNCH;  // one slice: its records always fit
    p.lanes = lanes;
    const size_t fixed = backward_floats(C, Hp, p.rows, p.lanes, 0);
    if (fixed >= most) return BAD_LAUNCH;
    rc = stream_chunk(p, RS, most - fixed);
    if (rc) return rc;
  }
  p.threads = p.lanes * p.sl.G;
  p.bytes = sizeof(float) *
            backward_floats(C, Hp, p.rows, p.lanes, p.streamed ? 2 * (size_t)p.CR * RS : resident);
  p.nreg = units(p.lanes) >= 2 ? 2 : 1;
  const BwdKernel<T, MX> kernel = backward_kernel<T, MX>(p.sl, C, p.nreg);
  if (!kernel) return BAD_ARGUMENT;
  rc = resident_blocks(kernel, p.threads, p.bytes, p.resident);
  if (rc) return rc;
  if (p.resident < 1) return BAD_LAUNCH;
  p.groups = (B + p.lanes - 1) / p.lanes;
  p.blocks = std::min<long>(p.groups, (long)p.resident * p.sms);
  return 0;
}

// The backward launch of one mode, as backward_plan plans it.
template <typename T, bool MX>
int backward_mode(const void* ct, const float* zres, const float* z0t, const float* gz,
                  const float* w1t, const float* b1, const float* w2t, const float* b2,
                  const int* slot, void* dct, float* dz0, float* dw1p, float* db1p, float* dw2p,
                  float* db2p, float* scratch, int B, int n, int H, int C, int W, int m,
                  double dt, const Tableau& tab, int blocks, cudaStream_t st) {
  LaunchPlan p;
  int rc = backward_plan<T, MX>(p, B, H, C, W);
  if (rc) return rc;
  if (p.blocks != blocks || (p.scratch && !scratch)) return BAD_ARGUMENT;
  if (p.streamed) {
    rc = stage_records(w1t, b1, w2t, H, C, W, p.sl.Hp, p.R * p.CR, scratch, st);
    if (rc) return rc;
  }
  backward_kernel<T, MX>(p.sl, C, p.nreg)<<<p.blocks, p.threads, p.bytes, st>>>(
      static_cast<const T*>(ct), zres, z0t, gz, w1t, b1, w2t, b2,
      reinterpret_cast<const float4*>(scratch), slot, static_cast<T*>(dct), dz0, dw1p, db1p,
      dw2p, db2p, B, n, H, W, m, dt, tab, cut_of(p));
  return (int)cudaGetLastError();
}

}  // namespace
