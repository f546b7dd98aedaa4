// The whole NaN-masked natural cubic spline fit in one launch (K6 and K7),
// as a CUDA kernel for Hopper (sm_90a).
//
// Replaces torchcde_tpu/ops/masked_cubic_pallas.py (the streaming kernels
// _prep_kernel / _prep_kernel_bm, _assemble_fwd_kernel, _subst_kernel,
// _rebase_kernel, entries masked_natural_cubic_full and
// masked_natural_cubic_pallas) and ops/masked_cubic_resident.py
// (_resident_kernel, entry masked_natural_cubic_resident).  The TPU split
// between the streaming and the resident kernel follows VMEM's size; here
// one launch serves all three entries, in one of two variants (below).
// From raw values x (n, k) with NaNs and the times t (k) it computes the
// coefficients (a, b, two_c, three_d), each (n, k - 1), of
// interpolation/cubic.py's masked pipeline applied to the
// endpoint-imputed values (version 0: a missing first or last entry takes
// the nearest observation; version 1: the values before the first and after
// the last observation do).  Rows without any observation come out as
// zeros; the caller masks them as the JAX package does.
//
// What bounds it.  The function reads x once and writes four coefficient
// arrays: at 8192 x 4096 float32, 671 MB, 0.20 ms at 3.35 TB/s; ~40 flops
// per position (1.3 GFLOP in all) are nothing.  The five phases are
// sequential recurrences along each row, two of them in reverse, and pass
// per-row intermediates between them (the reference recurrences,
// torchcde_tpu/interpolation/cubic.py:_masked_coeffs_xla after
// _impute_endpoints):
//  0. the first and last observed positions;
//  1. reverse: endpoint imputation, the next-observed (value, time) carry,
//     and the interval quantities hr = 1 / h, sph = 6 dx hr, pds = sph hr / 2
//     (zero where no later observation follows);
//  2. forward: the previous-observed (hr, pds) carry, the diagonal and
//     right-hand side, and the gappy Thomas forward elimination;
//  3. reverse: back substitution with the spline algebra, kd at the next
//     observed knot being the substitution's carry;
//  4. forward: the last-observed polynomial carry, re-based onto every grid
//     interval.
//
// Three variants; the wrapper's fit_plan picks one from k.
//
// Resident variant (k <= RES_MAX = 4096): each row stays on chip from x to
// the outputs, so x is read once and the four outputs written once.  A row
// belongs to a power of two of threads (threads_per_row, as few as hold it
// at RP = 16 positions a thread; short rows share a block of RT = 256
// threads), and each thread holds RP consecutive positions in registers
// through all five phases.  Every phase becomes a chunk-local recurrence
// joined by a scan across the row's threads, as the TPU kernels run them
// (masked_cubic_pallas.py:16-27, :227-330): each thread composes its
// chunk's operator, the operators are scanned across the row (warp shuffles,
// then, for rows of more than one warp, one pass over the warps' totals in
// shared memory, in order), and each thread runs its chunk from its
// carry-in with the reference arithmetic:
//  0. a min/max reduction;
//  1. a select-carry suffix scan (the next observation's value and time);
//  2. a select-carry scan (the previous observation's hr, pds); the
//     diagonal by a scan of its Moebius maps d -> dg - hp^2 / d as 2 x 2
//     matrices, each product divided by the power of two at or below its
//     largest entry (the map is unchanged, and a float32 product over a long
//     observed run would overflow; _rescale2, masked_cubic_pallas.py:209);
//     the right-hand side by an affine scan; unobserved positions are the
//     identity;
//  3. an affine suffix scan of kd in kd at the next observed knot;
//  4. a select-carry scan of the last observed knot's polynomial.
// x is staged through shared memory with coalesced loads (rows start at
// row * k, outputs at row * (k - 1): not 16-byte aligned for most k): the
// block's rows are one contiguous range of x, staged as they lie, with a
// float of padding after every RP, so that a warp's reads of its chunks fall
// in distinct banks; each output leaves the same way, laid out as in its
// own array (rows k - 1 apart).  Every scan runs in a
// fixed order without atomics: two launches give the same bits.
//
// Cluster variant (RES_MAX < k <= CLUSTER_MAX * RES_MAX): the same kernel
// over a thread block cluster a row (row_scan.cuh: cluster_shape_ok,
// cluster_scan).  Each of the cluster's cs = ceil(k / RES_MAX) blocks holds
// one segment of the row in its RT threads as a resident block holds a row,
// and each of the five phases' scans gains the cluster level: the blocks'
// totals composed in rank order through distributed shared memory, one
// exchange each (the span, the next observation, the previous observation,
// the diagonal, the right-hand side, the substitution, the polynomial), so
// the row stays on chip from x to the four outputs.  The values at the
// first and last observed positions come from x in device memory.
//
// Long-row variant (k > CLUSTER_MAX * RES_MAX): one thread per row runs the reference
// recurrences phase by phase, each a loop over the row:
//  0. scanning in from each end;
//  1-4. as above, with the carries in registers.
// The per-row intermediates live in seven scratch arrays from PyTorch's
// allocator, reused in place as the TPU kernel reuses its VMEM slabs: phase
// 3 writes b0, c0, d0 over pds, nd, nb: 14 reads and 14 writes of (n, k)
// arrays in all.
//
// The scratch is tiled: the row is cut into tiles of TILE = 16 positions,
// and tile q of row r is 16 contiguous elements at (q * n + r) * 16.  A
// thread loads or stores a whole tile with four 16-byte vector accesses,
// and the 32 threads of a warp touch 2 KB of contiguous memory: the loads
// of a tile do not depend on the recurrence, so all of them are in flight
// at once, and every DRAM access is a long contiguous burst.  Blocks are
// one warp, so the rows spread over every SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row_scan.cuh"

namespace {

constexpr int THREADS = 32;  // long rows: one warp per block, the rows spread over every SM
constexpr int TILE = 16;     // positions per scratch tile
constexpr int BAD_ARGUMENT = -2;
constexpr int RESIDENT = 0, LONG_ROWS = 1;  // the variants

struct Scratch {  // tiled: position j of row r at ((j / TILE) * n + r) * TILE + j % TILE
  float* __restrict__ xs;     // observed values, 0 where missing (a0)
  uint8_t* __restrict__ obs;  // observed after imputation
  float* __restrict__ hr;
  float* __restrict__ pds;    // then b0
  float* __restrict__ sph;
  float* __restrict__ nd;     // then c0
  float* __restrict__ nb;     // then d0
};

__device__ __forceinline__ void load_tile(const float* p, float (&v)[TILE]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < TILE / 4; ++i) {
    const float4 f = q[i];
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}

__device__ __forceinline__ void store_tile(float* p, const float (&v)[TILE]) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int i = 0; i < TILE / 4; ++i)
    q[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

__device__ __forceinline__ void load_tile(const uint8_t* p, bool (&v)[TILE]) {
  const uint4 f = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
  for (int i = 0; i < TILE; ++i) v[i] = (w[i / 4] >> (8 * (i % 4))) & 0xffu;
}

__device__ __forceinline__ void store_tile(uint8_t* p, const bool (&v)[TILE]) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < TILE; ++i) w[i / 4] |= (unsigned)v[i] << (8 * (i % 4));
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(THREADS)
    long_fit_kernel(const float* __restrict__ x, const float* __restrict__ t,
                      float* __restrict__ a, float* __restrict__ b,
                      float* __restrict__ c, float* __restrict__ d, Scratch s,
                      long long n, int k, int version) {
  const long long row = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (row >= n) return;
  const float* xr = x + (size_t)row * (size_t)k;
  const int tiles = (k + TILE - 1) / TILE;
  // Offset of the row's tile q in a scratch array.
  auto at = [n, row](int q) { return ((long long)q * n + row) * TILE; };

  // Phase 0: first and last observed positions (argmax semantics for a row
  // with none: 0 and k - 1, whose values are NaN and impute nothing).
  int first = 0;
  while (first < k && isnan(xr[first])) ++first;
  int last = k - 1;
  if (first == k) {
    first = 0;
  } else {
    while (isnan(xr[last])) --last;
  }
  const float v_first = xr[first], v_last = xr[last];

  // Phase 1 (reverse): imputation, next-observed carry, interval quantities.
  // Positions past k in the last tile are stored as missing.
  bool later = false;
  float cx = 0.f, ct = 0.f;
  for (int q = tiles - 1; q >= 0; --q) {
    float xv[TILE], tv[TILE];
#pragma unroll
    for (int u = 0; u < TILE; ++u) {
      const int j = q * TILE + u;
      xv[u] = j < k ? xr[j] : NAN;
      tv[u] = j < k ? t[j] : 0.f;
    }
    float xs[TILE], hr[TILE], pds[TILE], sph[TILE];
    bool ob[TILE];
#pragma unroll
    for (int u = TILE - 1; u >= 0; --u) {
      const int j = q * TILE + u;
      float v = xv[u];
      if (isnan(v) && j < k) {
        if (version == 0) {
          if (j == 0) v = v_first;
          else if (j == k - 1) v = v_last;
        } else {
          if (j < first) v = v_first;
          else if (j > last) v = v_last;
        }
      }
      const bool o = !isnan(v);
      ob[u] = o;
      xs[u] = o ? v : 0.f;
      hr[u] = sph[u] = pds[u] = 0.f;
      if (o && later) {
        hr[u] = 1.f / (ct - tv[u]);
        sph[u] = 6.f * (cx - xs[u]) * hr[u];
        pds[u] = 0.5f * sph[u] * hr[u];
      }
      if (o) {
        cx = xs[u];
        ct = tv[u];
        later = true;
      }
    }
    const long long p = at(q);
    store_tile(s.xs + p, xs);
    store_tile(s.obs + p, ob);
    store_tile(s.hr + p, hr);
    store_tile(s.pds + p, pds);
    store_tile(s.sph + p, sph);
  }

  // Phase 2 (forward): previous-observed carry, assembly, forward sweep.
  float hp = 0.f, pp = 0.f, prev_d = 1.f, prev_b = 0.f;
  for (int q = 0; q < tiles; ++q) {
    const long long p = at(q);
    float hv[TILE], pv[TILE], ndv[TILE], nbv[TILE];
    bool ov[TILE];
    load_tile(s.obs + p, ov);
    load_tile(s.hr + p, hv);
    load_tile(s.pds + p, pv);
#pragma unroll
    for (int u = 0; u < TILE; ++u) {
      ndv[u] = 1.f;
      nbv[u] = 0.f;
      if (ov[u]) {
        float dg = 2.f * (hp + hv[u]);
        if (!(dg > 0.f)) dg = 1.f;
        const float r = pp + pv[u];
        const float w = hp / prev_d;
        prev_d = dg - w * hp;
        prev_b = r - w * prev_b;
        ndv[u] = prev_d;
        nbv[u] = prev_b;
        hp = hv[u];
        pp = pv[u];
      }
    }
    store_tile(s.nd + p, ndv);
    store_tile(s.nb + p, nbv);
  }

  // Phase 3 (reverse): back substitution and the spline algebra; kdn, the
  // knot derivative at the next observed knot, is the substitution carry.
  float kdn = 0.f;
  for (int q = tiles - 1; q >= 0; --q) {
    const long long p = at(q);
    float hv[TILE], sv[TILE], dv[TILE], bv[TILE], kdv[TILE];
    bool ov[TILE];
    load_tile(s.obs + p, ov);
    load_tile(s.hr + p, hv);
    load_tile(s.sph + p, sv);
    load_tile(s.nd + p, dv);
    load_tile(s.nb + p, bv);
#pragma unroll
    for (int u = TILE - 1; u >= 0; --u) {
      const float hr = hv[u], sph = sv[u];
      float kd = 0.f;
      if (ov[u]) kd = (bv[u] - hr * kdn) / dv[u];
      kdv[u] = kd;
      dv[u] = (sph - 4.f * kd - 2.f * kdn) * hr;
      bv[u] = (-sph + 3.f * (kd + kdn)) * hr * hr;
      if (ov[u]) kdn = kd;
    }
    store_tile(s.pds + p, kdv);
    store_tile(s.nd + p, dv);
    store_tile(s.nb + p, bv);
  }

  // Phase 4 (forward): the polynomial of the last observed knot at or
  // before each interval (position 0's before any), re-based onto it.
  float ca = 0.f, cb = 0.f, cc = 0.f, cd = 0.f, cto = 0.f;
  const size_t out_base = (size_t)row * (size_t)(k - 1);
  for (int q = 0; q < tiles; ++q) {
    const long long p = at(q);
    float av[TILE], bv[TILE], cv[TILE], dv[TILE];
    bool ov[TILE];
    load_tile(s.obs + p, ov);
    load_tile(s.xs + p, av);
    load_tile(s.pds + p, bv);
    load_tile(s.nd + p, cv);
    load_tile(s.nb + p, dv);
#pragma unroll
    for (int u = 0; u < TILE; ++u) {
      const int j = q * TILE + u;
      if (j >= k - 1) break;
      const float tj = t[j];
      if (j == 0 || ov[u]) {
        ca = av[u];
        cb = bv[u];
        cc = cv[u];
        cd = dv[u];
        cto = tj;
      }
      const float off = cto - tj;
      a[out_base + j] = ca + ((0.5f * cc - cd * off / 3.f) * off - cb) * off;
      b[out_base + j] = cb + (cd * off - cc) * off;
      c[out_base + j] = cc - 2.f * cd * off;
      d[out_base + j] = cd;
    }
  }
}


// ---------------------------------------------------------------------------
// Resident variant: a row's RP-position chunks in the registers of
// threads_per_row (tpr) consecutive threads, the five phases joined by
// scans across them (row_scan.cuh).

constexpr size_t RES_SMEM = sizeof(float) * (2 * RES_BUF + RT / 32 * SCAN_SLOT);
constexpr size_t CLUSTER_SMEM = RES_SMEM + sizeof(float) * CLUSTER_SLOTS * SCAN_SLOT;
constexpr float NO_POSITION = 1e30f;        // phase 0's identity for the first position

// Select-carry: v[0] != 0 marks a present value; the later one wins.
template <int N>
struct SelectOp {
  static __device__ __forceinline__ Vec<N> identity() {
    Vec<N> r;
#pragma unroll
    for (int i = 0; i < N; ++i) r.v[i] = 0.f;
    return r;
  }
  static __device__ __forceinline__ Vec<N> compose(const Vec<N>& f, const Vec<N>& s) {
    return s.v[0] != 0.f ? s : f;
  }
};

// First and last observed positions (as floats, exact below 2^24).
struct SpanOp {
  static __device__ __forceinline__ Vec<2> identity() { return {{NO_POSITION, -1.f}}; }
  static __device__ __forceinline__ Vec<2> compose(const Vec<2>& f, const Vec<2>& s) {
    return {{fminf(f.v[0], s.v[0]), fmaxf(f.v[1], s.v[1])}};
  }
};

// The row's first and last observed positions in every thread of the row.
__device__ __forceinline__ Vec<2> row_span(Vec<2> v, int tpr, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int width = tpr < 32 ? tpr : 32;
  for (int m = 1; m < width; m <<= 1) {
    Vec<2> o;
    o.v[0] = __shfl_xor_sync(0xffffffffu, v.v[0], m, width);
    o.v[1] = __shfl_xor_sync(0xffffffffu, v.v[1], m, width);
    v = SpanOp::compose(v, o);
  }
  if (tpr > 32) {
    if (lane == 0) {
      scratch[warp * SCAN_SLOT] = v.v[0];
      scratch[warp * SCAN_SLOT + 1] = v.v[1];
    }
    __syncthreads();
    const int wpr = tpr >> 5, first = warp - (warp & (wpr - 1));
    v = SpanOp::identity();
    for (int w = 0; w < wpr; ++w)
      v = SpanOp::compose(v, {{scratch[(first + w) * SCAN_SLOT],
                               scratch[(first + w) * SCAN_SLOT + 1]}});
    __syncthreads();
  }
  return v;
}

// The span over the cluster's blocks, each holding its segment's in every
// thread (row_span), in rank order.
__device__ __forceinline__ Vec<2> cluster_span(Vec<2> v, float* slot) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) {
    slot[0] = v.v[0];
    slot[1] = v.v[1];
  }
  cluster.sync();
  v = SpanOp::identity();
  for (int q = 0; q < (int)cluster.dim_blocks().x; ++q) {
    const float* remote = cluster.map_shared_rank(slot, q);
    v = SpanOp::compose(v, {{remote[0], remote[1]}});
  }
  return v;
}

// RT / tpr rows a block, or, over a cluster (CLUSTER), one segment of a
// row a block: the thread's positions are g0 + u of its row, j0 + u of the
// block's part of it.  Three blocks an SM: the cap of 80 registers a
// thread costs ~400 bytes of spills to L1, and on an H100 at config 3 it
// ran 5 % faster than two blocks without spills (PERF.md).
template <bool CLUSTER>
__global__ void __launch_bounds__(RT, 3)
    resident_fit_kernel(const float* __restrict__ x, const float* __restrict__ t,
                        float* __restrict__ a, float* __restrict__ b,
                        float* __restrict__ c, float* __restrict__ d, long long n, int k,
                        int tpr, int seg, int version) {
  extern __shared__ float mc_smem[];
  float* buf = mc_smem;             // [RES_BUF] the block's rows of x, then of each output
  float* tb = buf + RES_BUF;        // [RES_BUF] t, shared by the rows
  float* scratch = tb + RES_BUF;    // [RT / 32][SCAN_SLOT] the scans' warp totals
  float* slots = scratch + RT / 32 * SCAN_SLOT;  // [7][SCAN_SLOT] a cluster's exchanges
  const RowPart p = row_part<CLUSTER>(n, k, tpr, seg);
  const long long row0 = p.row0;
  const int rows = p.rows, rb = p.rb, len = p.len;
  const int tid = threadIdx.x;
  const bool live = p.live;
  const int j0 = p.j0;              // the thread's first position in its part of the row
  const int g0 = p.seg0 + j0;       // and in the row
  const int to = j0 / RP * (RP + 1);  // its chunk in tb
  // The outputs' positions (k - 1 a row) in the block's part.
  const int len_out = CLUSTER ? max(0, min(len, k - 1 - p.seg0)) : k - 1;
#define IN(u) (live && j0 + (u) < len)

  // Stage t and the block's rows of x (one contiguous range), coalesced.
  for (int i = tid; i < len; i += RT) tb[staged(i)] = t[p.seg0 + i];
  const float* xb = x + row0 * k + p.seg0;
  for (int i = tid; i < rows * len; i += RT) buf[staged(i)] = xb[i];
  __syncthreads();
  float xs[RP];
#pragma unroll
  for (int u = 0; u < RP; ++u)
    xs[u] = IN(u) ? buf[staged(rb * len + j0 + u)] : NAN;

  // Phase 0: first and last observed positions (argmax semantics for a row
  // with none: 0 and k - 1, whose values are NaN and impute nothing).
  Vec<2> sp = SpanOp::identity();
#pragma unroll
  for (int u = RP - 1; u >= 0; --u) {
    if (!isnan(xs[u])) {
      sp.v[0] = (float)(g0 + u);
      if (sp.v[1] < 0.f) sp.v[1] = (float)(g0 + u);
    }
  }
  sp = row_span(sp, tpr, scratch);
  if (CLUSTER) sp = cluster_span(sp, slots);
  int first = 0, last = k - 1;
  if (sp.v[0] < NO_POSITION) {
    first = (int)sp.v[0];
    last = (int)sp.v[1];
  }
  float v_first, v_last;
  if (CLUSTER) {  // the row's own positions, perhaps in another block's segment
    v_first = x[row0 * k + first];
    v_last = x[row0 * k + last];
  } else {
    v_first = live ? buf[staged(rb * k + first)] : NAN;
    v_last = live ? buf[staged(rb * k + last)] : NAN;
  }

  // Imputation: the observed positions (a bit each) and values (0 where missing).
  unsigned obs = 0u;
#pragma unroll
  for (int u = 0; u < RP; ++u) {
    const int j = g0 + u;
    float v = xs[u];
    if (isnan(v) && IN(u)) {
      if (version == 0) {
        if (j == 0) v = v_first;
        else if (j == k - 1) v = v_last;
      } else {
        if (j < first) v = v_first;
        else if (j > last) v = v_last;
      }
    }
    const bool o = !isnan(v);
    obs |= (unsigned)o << u;
    xs[u] = o ? v : 0.f;
  }
#define OBS(u) ((obs >> (u)) & 1u)

  // Phase 1 (reverse): the next observed (value, time) after the chunk, then
  // the interval quantities.
  Vec<3> e3 = SelectOp<3>::identity();
#pragma unroll
  for (int u = RP - 1; u >= 0; --u) {
    if (OBS(u)) e3 = {{1.f, xs[u], tb[to + u]}};
  }
  e3 = full_scan<SelectOp<3>, true, CLUSTER>(e3, tpr, scratch, slots + SCAN_SLOT);
  bool later = e3.v[0] != 0.f;
  float cx = e3.v[1], ct = e3.v[2];
  float hr[RP], sph[RP], pds[RP];
#pragma unroll
  for (int u = RP - 1; u >= 0; --u) {
    const float tj = tb[to + u];
    hr[u] = sph[u] = pds[u] = 0.f;
    if (OBS(u) && later) {
      hr[u] = 1.f / (ct - tj);
      sph[u] = 6.f * (cx - xs[u]) * hr[u];
      pds[u] = 0.5f * sph[u] * hr[u];
    }
    if (OBS(u)) {
      cx = xs[u];
      ct = tj;
      later = true;
    }
  }

  // Phase 2: the previous observed (hr, pds) before the chunk; the Thomas
  // diagonal's carry-in by the Moebius scan; the diagonal in the chunk and
  // the right-hand side's affine maps (nb holds each w until the carry-in
  // of the right-hand side is known); the right-hand side.
  e3 = SelectOp<3>::identity();
#pragma unroll
  for (int u = 0; u < RP; ++u) {
    if (OBS(u)) e3 = {{1.f, hr[u], pds[u]}};
  }
  e3 = full_scan<SelectOp<3>, false, CLUSTER>(e3, tpr, scratch, slots + 2 * SCAN_SLOT);
  const float hp0 = e3.v[1], pp0 = e3.v[2];  // 0 with none (the identity)
  Vec<4> mob = MoebiusOp::identity();
  float hp = hp0;
#pragma unroll
  for (int u = 0; u < RP; ++u) {
    if (OBS(u)) {
      float dg = 2.f * (hp + hr[u]);
      if (!(dg > 0.f)) dg = 1.f;
      mob = MoebiusOp::compose(mob, {{dg, -hp * hp, 1.f, 0.f}});
      hp = hr[u];
    }
  }
  mob = full_scan<MoebiusOp, false, CLUSTER>(mob, tpr, scratch, slots + 3 * SCAN_SLOT);
  const float d_in = (mob.v[0] + mob.v[1]) / (mob.v[2] + mob.v[3]);  // applied to d = 1
  float nd[RP], nb[RP];
  Vec<2> aff = AffineOp::identity();
  float prev_d = d_in, pp = pp0;
  hp = hp0;
#pragma unroll
  for (int u = 0; u < RP; ++u) {
    nd[u] = 1.f;
    nb[u] = 0.f;
    if (OBS(u)) {
      float dg = 2.f * (hp + hr[u]);
      if (!(dg > 0.f)) dg = 1.f;
      const float r = pp + pds[u];
      const float w = hp / prev_d;
      prev_d = dg - w * hp;
      aff = AffineOp::compose(aff, {{-w, r}});
      nd[u] = prev_d;
      nb[u] = w;
      hp = hr[u];
      pp = pds[u];
    }
  }
  aff = full_scan<AffineOp, false, CLUSTER>(aff, tpr, scratch, slots + 4 * SCAN_SLOT);
  float prev_b = aff.v[1];  // applied to b = 0
  pp = pp0;
#pragma unroll
  for (int u = 0; u < RP; ++u) {
    if (OBS(u)) {
      const float r = pp + pds[u];
      prev_b = r - nb[u] * prev_b;
      nb[u] = prev_b;
      pp = pds[u];
    }
  }

  // Phase 3 (reverse): back substitution; kdn, the knot derivative at the
  // next observed knot, is the substitution's carry.  kd, two_c0 and
  // three_d0 take the places of nd, sph and nb.
  aff = AffineOp::identity();
#pragma unroll
  for (int u = RP - 1; u >= 0; --u) {
    if (OBS(u)) {
      const float inv = 1.f / nd[u];
      aff = AffineOp::compose(aff, {{-hr[u] * inv, nb[u] * inv}});
    }
  }
  aff = full_scan<AffineOp, true, CLUSTER>(aff, tpr, scratch, slots + 5 * SCAN_SLOT);
  float kdn = aff.v[1];  // applied to kd = 0
#pragma unroll
  for (int u = RP - 1; u >= 0; --u) {
    const float h = hr[u], s6 = sph[u];
    float kd = 0.f;
    if (OBS(u)) kd = (nb[u] - h * kdn) / nd[u];
    nd[u] = kd;
    sph[u] = (s6 - 4.f * kd - 2.f * kdn) * h;
    nb[u] = (-s6 + 3.f * (kd + kdn)) * h * h;
    if (OBS(u)) kdn = kd;
  }
  const float(&kd)[RP] = nd;
  const float(&c0)[RP] = sph;
  const float(&d0)[RP] = nb;

  // Phase 4: the polynomial of the last observed knot at or before each
  // interval (position 0's before any), re-based onto it; each output
  // leaves through buf in turn.
  Vec<6> e6 = SelectOp<6>::identity();
#pragma unroll
  for (int u = 0; u < RP; ++u) {
    if (OBS(u) || g0 + u == 0) e6 = {{1.f, xs[u], kd[u], c0[u], d0[u], tb[to + u]}};
  }
  e6 = full_scan<SelectOp<6>, false, CLUSTER>(e6, tpr, scratch, slots + 6 * SCAN_SLOT);
  __syncthreads();  // every read of x in buf is done
  const long long out0 = row0 * (k - 1) + p.seg0;
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    float ca = e6.v[1], cb = e6.v[2], cc = e6.v[3], cd = e6.v[4], cto = e6.v[5];
#pragma unroll
    for (int u = 0; u < RP; ++u) {
      const float tj = tb[to + u];
      if (OBS(u) || g0 + u == 0) {
        ca = xs[u];
        cb = kd[u];
        cc = c0[u];
        cd = d0[u];
        cto = tj;
      }
      const float off = cto - tj;
      float v;
      if (o == 0) v = ca + ((0.5f * cc - cd * off / 3.f) * off - cb) * off;
      else if (o == 1) v = cb + (cd * off - cc) * off;
      else if (o == 2) v = cc - 2.f * cd * off;
      else v = cd;
      if (live && j0 + u < len_out) buf[staged(rb * len_out + j0 + u)] = v;
    }
    __syncthreads();
    float* dst = (o == 0 ? a : o == 1 ? b : o == 2 ? c : d) + out0;
    for (int i = tid; i < rows * len_out; i += RT) dst[i] = buf[staged(i)];
    __syncthreads();
  }
#undef OBS
#undef IN
  if (CLUSTER) cluster_done();
}

}  // namespace

extern "C" {

const char* mc_error_string(int code) {
  if (code == BAD_ARGUMENT) return "invalid argument";
  return cudaGetErrorString((cudaError_t)code);
}

// The resident variant's shape, into out[4]: positions a thread holds,
// threads per block, the longest row it takes, and the most blocks a row's
// cluster spans.
void mc_resident_shape(int* out) {
  out[0] = RP;
  out[1] = RT;
  out[2] = RES_MAX;
  out[3] = CLUSTER_MAX;
}

// The resident and cluster variants: x (n, k) and t (k) float32
// contiguous; a, b, c, d (n, k - 1).  Resident (cs 1): k <= RES_MAX, tpr
// threads per row, a power of two with tpr * RP >= k, RT / tpr rows per
// block.  Cluster: cs blocks a row of seg positions each (cluster_shape_ok;
// tpr = RT).  The wrapper's fit_plan gives both.
int mc_fit_resident(const float* x, const float* t, float* a, float* b, float* c, float* d,
                    long long n, int k, int tpr, int cs, int seg, int version, void* stream) {
  if (n <= 0 || k < 2 || (version != 0 && version != 1) || !x || !t || !a || !b || !c || !d)
    return BAD_ARGUMENT;
  cudaStream_t st = (cudaStream_t)stream;
  if (cs == 1) {
    if (k > RES_MAX || tpr < 1 || tpr > RT || (tpr & (tpr - 1)) || (long long)tpr * RP < k)
      return BAD_ARGUMENT;
    const long long rpb = RT / tpr, blocks = (n + rpb - 1) / rpb;
    if (blocks > 0x7fffffffLL) return BAD_ARGUMENT;
    resident_fit_kernel<false><<<(unsigned)blocks, RT, RES_SMEM, st>>>(x, t, a, b, c, d, n, k,
                                                                        tpr, 0, version);
    return (int)cudaGetLastError();
  }
  if (!cluster_shape_ok(k, cs, seg) || tpr != RT || n * cs > 0x7fffffffLL) return BAD_ARGUMENT;
  cudaError_t err = launch_clusters(resident_fit_kernel<true>, n * cs, cs, CLUSTER_SMEM, st, x,
                                    t, a, b, c, d, n, k, (int)RT, seg, version);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The positions of a scratch array per row: k rounded up to whole tiles.
int mc_scratch_positions(int k) { return (k + TILE - 1) / TILE * TILE; }

// The long-row variant: x (n, k) and t (k) float32 contiguous; a, b, c, d
// (n, k - 1); scratch: six float32 arrays (xs, hr, pds, sph, nd, nb) and one
// byte array (obs) of n * mc_scratch_positions(k) elements each, 16-byte
// aligned.
int mc_fit(const float* x, const float* t, float* a, float* b, float* c,
           float* d, float* xs, uint8_t* obs, float* hr, float* pds,
           float* sph, float* nd, float* nb, long long n, int k, int version,
           void* stream) {
  if (n <= 0 || k < 2 || (version != 0 && version != 1) || !x || !t || !a ||
      !b || !c || !d || !xs || !obs || !hr || !pds || !sph || !nd || !nb ||
      (n + THREADS - 1) / THREADS > 0x7fffffffLL)
    return BAD_ARGUMENT;
  Scratch s = {xs, obs, hr, pds, sph, nd, nb};
  const long long blocks = (n + THREADS - 1) / THREADS;
  long_fit_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, t, a, b, c, d, s, n, k, version);
  return (int)cudaGetLastError();
}

}  // extern "C"
