// The whole NaN-masked natural cubic spline fit in one launch (K6 and K7),
// as a CUDA kernel for Hopper (sm_90a).
//
// Replaces torchcde_tpu/ops/masked_cubic_pallas.py (the streaming kernels
// _prep_kernel / _prep_kernel_bm, _assemble_fwd_kernel, _subst_kernel,
// _rebase_kernel, entries masked_natural_cubic_full and
// masked_natural_cubic_pallas) and ops/masked_cubic_resident.py
// (_resident_kernel, entry masked_natural_cubic_resident).  The TPU split
// between the streaming and the resident kernel follows VMEM's size; one
// kernel serves both here.  From raw values x (n, k) with NaNs and the
// times t (k) it computes the coefficients (a, b, two_c, three_d), each
// (n, k - 1), of interpolation/cubic.py's masked pipeline applied to the
// endpoint-imputed values (version 0: a missing first or last entry takes
// the nearest observation; version 1: the values before the first and after
// the last observation do).  Rows without any observation come out as
// zeros; the caller masks them as the JAX package does.
//
// What bounds it.  The function reads x once and writes four coefficient
// arrays: at 8192 x 4096 float32, 671 MB, 0.20 ms at 3.35 TB/s; ~40 flops
// per position (1.3 GFLOP in all) are nothing.  The five phases are
// sequential recurrences along each row, two of them in reverse, and pass
// per-row intermediates between them: 14 reads and 14 writes of (n, k)
// arrays in all.  With one thread per row (8192 rows are 256 warps) the
// scratch traffic and the memory parallelism of few warps bind.
//
// Design.  One thread per row runs the reference recurrences
// (torchcde_tpu/interpolation/cubic.py:_masked_coeffs_xla after
// _impute_endpoints), phase by phase, each a loop over the row:
//  0. the first and last observed positions, found by scanning in from each
//     end (the TPU kernel reduces over the whole row);
//  1. reverse: endpoint imputation, the next-observed (value, time) carry,
//     and the interval quantities hr = 1 / h, sph = 6 dx hr, pds = sph hr / 2
//     (zero where no later observation follows);
//  2. forward: the previous-observed (hr, pds) carry, the diagonal and
//     right-hand side, and the gappy Thomas forward elimination;
//  3. reverse: back substitution with the spline algebra, kd at the next
//     observed knot being the substitution's carry;
//  4. forward: the last-observed polynomial carry, re-based onto every grid
//     interval.
// The TPU's Hillis-Steele and Moebius prefix scans exist only because its
// grid is sequential and its lanes must be full; here each recurrence runs
// as written, with its carry in registers.  The per-row intermediates live
// in seven scratch arrays from PyTorch's allocator, reused in place as the
// TPU kernel reuses its VMEM slabs: phase 3 writes b0, c0, d0 over pds, nd,
// nb.  Nothing is sized to VMEM or shared memory.
//
// The scratch is tiled: the row is cut into tiles of TILE = 16 positions,
// and tile q of row r is 16 contiguous elements at (q * n + r) * 16.  A
// thread loads or stores a whole tile with four 16-byte vector accesses,
// and the 32 threads of a warp touch 2 KB of contiguous memory: the loads
// of a tile do not depend on the recurrence, so all of them are in flight
// at once, and every DRAM access is a long contiguous burst.  (Scratch laid
// out length-major instead, one 128-byte line per warp and position,
// measured 8.6 ms at config 3 against 0.3 ms per array pass here.)  Blocks
// are one warp, so the rows spread over every SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;  // one warp per block: the rows spread over every SM
constexpr int TILE = 16;     // positions per scratch tile
constexpr int BAD_ARGUMENT = -2;

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
    masked_fit_kernel(const float* __restrict__ x, const float* __restrict__ t,
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

}  // namespace

extern "C" {

const char* mc_error_string(int code) {
  if (code == BAD_ARGUMENT) return "invalid argument";
  return cudaGetErrorString((cudaError_t)code);
}

// The positions of a scratch array per row: k rounded up to whole tiles.
int mc_scratch_positions(int k) { return (k + TILE - 1) / TILE * TILE; }

// x (n, k) and t (k) float32 contiguous; a, b, c, d (n, k - 1); scratch:
// six float32 arrays (xs, hr, pds, sph, nd, nb) and one byte array (obs) of
// n * mc_scratch_positions(k) elements each, 16-byte aligned.
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
  masked_fit_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, t, a, b, c, d, s, n, k, version);
  return (int)cudaGetLastError();
}

}  // extern "C"
