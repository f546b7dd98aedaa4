// Scans across a row held in the registers of a power of two of threads,
// shared by the resident kernels of the natural cubic fit: K6/K7's
// resident_fit_kernel (masked_cubic.cu), K4's shared-band solve
// (tridiagonal.cu) and K5's resident_gappy_kernel (masked_tridiagonal.cu).
//
// A row of k <= RES_MAX positions belongs to threads_per_row (tpr)
// consecutive threads of a block of RT, tpr the least power of two with
// tpr * RP >= k, each thread holding RP consecutive positions in registers;
// RT / tpr rows share a block.  A sequential recurrence along the row
// becomes a chunk-local pass joined by an exclusive scan of the chunks'
// composed operators across the row's threads (row_scan): warp shuffles,
// then, for rows of more than one warp, one pass over the warps' totals in
// shared memory, in order.  Every scan runs in a fixed order without
// atomics, so two launches give the same bits.  A block stages its rows
// through shared memory with coalesced accesses, a float of padding after
// every RP (staged), so that a warp's reads of its chunks fall in distinct
// banks.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int RP = 16;                      // positions a thread holds
constexpr int RT = 256;                     // threads per block
constexpr int RES_MAX = RP * RT;            // longest resident row
constexpr int RES_BUF = RES_MAX / RP * (RP + 1);  // staging floats: a pad after every RP
constexpr int SCAN_SLOT = 8;                // floats per warp total in the scan scratch

// Staging index of element i of the block's range: a pad after every RP.
__device__ __forceinline__ int staged(int i) { return i + i / RP; }

template <int N>
struct Vec {
  float v[N];
};

template <int N>
__device__ __forceinline__ Vec<N> shfl_up(const Vec<N>& a, int d, int width) {
  Vec<N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = __shfl_up_sync(0xffffffffu, a.v[i], d, width);
  return r;
}

template <int N>
__device__ __forceinline__ Vec<N> shfl_down(const Vec<N>& a, int d, int width) {
  Vec<N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = __shfl_down_sync(0xffffffffu, a.v[i], d, width);
  return r;
}

// The scans' operators: compose(first, second) is first, then second in
// the scan's direction; identity() composes to no change.

// x -> v[0] x + v[1].
struct AffineOp {
  static __device__ __forceinline__ Vec<2> identity() { return {{1.f, 0.f}}; }
  static __device__ __forceinline__ Vec<2> compose(const Vec<2>& f, const Vec<2>& s) {
    return {{s.v[0] * f.v[0], s.v[0] * f.v[1] + s.v[1]}};
  }
};

// The Moebius map d -> (v[0] d + v[1]) / (v[2] d + v[3]) as a 2 x 2 matrix,
// products divided by the power of two at or below their largest entry (an
// exact scaling, by the exponent bits: the largest entry lands in [1, 2)).
struct MoebiusOp {
  static __device__ __forceinline__ Vec<4> identity() { return {{1.f, 0.f, 0.f, 1.f}}; }
  static __device__ __forceinline__ Vec<4> compose(const Vec<4>& f, const Vec<4>& s) {
    Vec<4> m = {{s.v[0] * f.v[0] + s.v[1] * f.v[2], s.v[0] * f.v[1] + s.v[1] * f.v[3],
                 s.v[2] * f.v[0] + s.v[3] * f.v[2], s.v[2] * f.v[1] + s.v[3] * f.v[3]}};
    const float big = fmaxf(fmaxf(fabsf(m.v[0]), fabsf(m.v[1])),
                            fmaxf(fabsf(m.v[2]), fabsf(m.v[3])));
    const int e = (__float_as_int(big) >> 23) & 0xff;  // biased exponent
    if (e > 0 && e < 254) {  // normal and finite: scale by 2^(127 - e)
      const float scale = __int_as_float((254 - e) << 23);
#pragma unroll
      for (int i = 0; i < 4; ++i) m.v[i] *= scale;
    }
    return m;
  }
};

// The composition of the row's chunks before this thread's in the scan's
// direction (after it when REV), this thread's chunk element being mine:
// an exclusive scan over the row's tpr threads, by shuffles within a warp
// and, for rows of several warps, over the warps' totals in order.  Every
// thread of the block calls it (tpr is the same for all).
template <class Op, bool REV, int N>
__device__ __forceinline__ Vec<N> row_scan(const Vec<N>& mine, int tpr, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int width = tpr < 32 ? tpr : 32;
  const int li = lane & (width - 1);
  Vec<N> incl = mine;
  for (int d = 1; d < width; d <<= 1) {
    const Vec<N> o = REV ? shfl_down(incl, d, width) : shfl_up(incl, d, width);
    if (REV ? li + d < width : li >= d) incl = Op::compose(o, incl);
  }
  const Vec<N> prev = REV ? shfl_down(incl, 1, width) : shfl_up(incl, 1, width);
  Vec<N> excl = (REV ? li + 1 < width : li >= 1) ? prev : Op::identity();
  if (tpr > 32) {
    if (lane == (REV ? 0 : 31)) {
#pragma unroll
      for (int i = 0; i < N; ++i) scratch[warp * SCAN_SLOT + i] = incl.v[i];
    }
    __syncthreads();
    const int wpr = tpr >> 5, wr = warp & (wpr - 1), first = warp - wr;
    Vec<N> carry = Op::identity();
    for (int i = 0; i < wpr; ++i) {
      const int w = REV ? wpr - 1 - i : i;
      if (REV ? w <= wr : w >= wr) break;
      Vec<N> total;
#pragma unroll
      for (int e = 0; e < N; ++e) total.v[e] = scratch[(first + w) * SCAN_SLOT + e];
      carry = Op::compose(carry, total);
    }
    excl = Op::compose(carry, excl);
    __syncthreads();
  }
  return excl;
}

}  // namespace
