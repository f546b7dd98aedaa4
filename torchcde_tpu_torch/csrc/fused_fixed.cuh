// What the fixed-step kernels (K1) share: the forward in fused_fixed.cu, the
// backward in fused_fixed_bwd.cu.  The design notes of both are at the top
// of fused_fixed.cu.
//
// A lane's group.  G threads (a power of two, one warp at most) run one
// batch lane: GS state slices of HS components each (H padded to Hp = GS HS
// with zero weights, exact in float32), every slice split over GW row
// threads.  Thread r of the group is slice s = r / GW, row thread
// rw = r % GW; it holds its slice of the lane's chain (the state, the stage
// inputs and cotangents, the second layer's C HS rows of the slice) in
// registers, the same bits in each of the slice's GW threads.  One
// evaluation g = tanh(W2 relu(W1 y + b1) + b2), for the rows w = rw
// (mod GW):
//   * h1_w: the slice's HS-long part of W1[w] . y, summed over the GS
//     slices by a butterfly of shuffles (every slice gets the same bits);
//   * the slice's C HS partial pre-activations W2[., w] h1_w, summed over the
//     slice's GW threads by a butterfly that scatters them (each thread keeps
//     C HS / GW sums and takes their tanh), then gathered back.
// The flagship's H 8 is the case GS 1, GW 8 (no slice sums); its kernels are
// instances of the same templates with every size known at compile time.
//
// The weights are records (cde_stream.cuh): resident in shared memory where
// they fit, else streamed a chunk of rows at a time through the ring.

#pragma once

#include <stddef.h>

#include <algorithm>

#include "cde_stage.cuh"
#include "cde_stream.cuh"

namespace {

constexpr int MAX_STAGES = 4;
constexpr int MAX_SUBSTEPS = 8;
constexpr int MAX_GROUP = 32;    // threads a lane: a group lies in one warp
constexpr int FF_LANES = 8;      // lanes a forward block before the small-batch rule
constexpr int FB_THREADS = 256;  // threads a backward block before the small-batch rule
constexpr int BAD_LAUNCH = -3;

// An explicit RK tableau whose stage s reads only stage s - 1 (euler,
// midpoint, heun, rk4): y_s = z + a_dt[s] * k_{s-1}.
struct Tableau {
  int n_stages;
  double alpha_dt[MAX_STAGES];  // alpha_s * dt_sub, the stage's time offset
  float a_dt[MAX_STAGES];       // dt_sub * A[s][s-1]
  float c_dt[MAX_STAGES];       // dt_sub * b_s
};

__device__ __forceinline__ float stage_fraction(const Tableau& tab, int s, int st, double dt) {
  return (float)((double)s * dt + tab.alpha_dt[st]);
}

inline int make_tableau(int n_stages, const double* alpha, const double* a, const double* c,
                        double dt, Tableau* tab) {
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

// The shapes the kernels take: every one inside the JAX package's caps
// (W <= 512, C*H <= 512, 3*C <= 16, m <= 8).
inline bool shapes_ok(int B, int H, int C, int W, int m, int n_stages, int mode) {
  return B >= 1 && H >= 1 && C >= 1 && W >= 1 && m >= 1 && m <= MAX_SUBSTEPS && W <= 512 &&
         C * H <= 512 && 3 * C <= 16 && n_stages >= 1 && n_stages <= MAX_STAGES &&
         (mode == 0 || mode == 1);
}

// A lane's group for H and C (see the top of this file): slices of 8
// components (16 for C 1 past H 256, so that a group stays in a warp), 8 row
// threads a slice up to Hp 32 and one beyond.
struct Slicing {
  int HS, GS, GW, G, Hp;
};

inline Slicing slicing(int H, int C) {
  Slicing s;
  s.HS = (C == 1 && H > 8 * MAX_GROUP) ? 16 : 8;
  s.GS = 1;
  while (s.GS * s.HS < H) s.GS *= 2;
  s.Hp = s.GS * s.HS;
  s.GW = s.Hp <= 32 ? 8 : 1;
  s.G = s.GS * s.GW;
  return s;
}

// Rows the groups walk: W rounded up to a multiple of 8 (of GW and of 4).
__host__ __device__ inline int walk_rows(int W) { return (W + 7) / 8 * 8; }

// Lanes a block at small batches: halved while the lane groups are fewer
// than half the SMs, a block keeps at least `least` threads and fits(lanes)
// holds for the halved count.  The forward keeps two warps a block (smaller
// blocks each stage a whole copy of the weights with fewer threads); the
// backward halves only while each thread's weight-gradient units stay in its
// registers (PERF.md, PR 22: past that, the units' device-memory traffic
// costs more than the spread gains).
template <class Fits>
inline int small_batch_lanes(int lanes, int G, int B, int sms, int least, Fits fits) {
  while (2 * ((B + lanes - 1) / lanes) < sms && lanes * G / 2 >= least && fits(lanes / 2))
    lanes /= 2;
  return lanes;
}

inline int card_sms(int& sms) {
  int dev = 0, rc = (int)cudaGetDevice(&dev);
  if (!rc) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return rc;
}

// The sizes of a kernel instance: C channels, slices of HS components, GW row
// threads a slice; SLICED false is one slice (GS 1, Hp = HS), every size
// then known at compile time.
template <int C_, int HS_, int GW_, bool SLICED_>
struct Shape {
  static constexpr int C = C_, HS = HS_, GW = GW_, N = C_ * HS_;
  static constexpr bool SLICED = SLICED_;
};

// The sizes a launch passes its sliced instances (ignored by the others).
struct Cut {
  int Hp, G, CR, R, streamed;  // padded H; threads a lane; rows a chunk; chunks; weights streamed
};

// What a thread needs to evaluate its lane's field: the block's weights and
// its place in the lane's group.
struct Lane {
  const float* rec;  // the records, resident (rows x RS)
  const float* b2s;  // b2 by slice, [C][Hp], zero past H
  int Hp, RS, G, rows, CR, R;  // padded H; record floats; threads a lane; rows; rows a chunk; chunks
  int s, rw, hoff;             // the slice, the row thread, the slice's first component
  bool streamed, sel;          // the weights through the ring; H % 8 != 0 (bfloat16's selection)
};

template <class K>
__device__ __forceinline__ int lane_hp(const Lane& x) { return K::SLICED ? x.Hp : K::HS; }
template <class K>
__device__ __forceinline__ int lane_rs(const Lane& x) {
  return K::SLICED ? x.RS : (1 + K::C) * K::HS + 4;
}
template <class K>
__device__ __forceinline__ int lane_hoff(const Lane& x) { return K::SLICED ? x.hoff : 0; }

// a summed over the lane's GS slices, the same bits in each (a butterfly:
// at every step both partners add the same two values).
template <class K>
__device__ __forceinline__ float slice_sum(float a, const Lane& x) {
  if constexpr (K::SLICED) {
    for (int o = K::GW; o < x.G; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  }
  return a;
}

// v summed over the slice's GW row threads, the same bits in each.
template <int GW, int N>
__device__ __forceinline__ void row_sum(float (&v)[N]) {
#pragma unroll
  for (int m = 1; m < GW; m *= 2) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], m);
  }
}

// The sums of v over the slice's row threads, scattered: a butterfly of
// shuffles from the highest bit of rw down, each step keeping half of the
// live entries, leaves row thread rw the sums of entries [rw N/GW,
// (rw+1) N/GW) in v[0 .. N/GW).
template <int M, int N, int LIVE>
struct Scatter {
  static __device__ __forceinline__ void run(float (&v)[N], int rw) {
    if constexpr (M > 0) {
      constexpr int HALF = LIVE / 2;
      const bool hi = rw & M;
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const float keep = hi ? v[HALF + i] : v[i];
        const float send = hi ? v[i] : v[HALF + i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      Scatter<M / 2, N, HALF>::run(v, rw);
    }
  }
};

// The inverse: row thread rw's block v[0 .. N/GW) of entries [rw N/GW, ...)
// gathered from the slice into v[0 .. N) of each of its threads, each entry a
// copy of its one owner's.
template <int GW, int M, int N, int LIVE>
struct Gather {
  static __device__ __forceinline__ void run(float (&v)[N], int rw) {
    if constexpr (M < GW) {
      const bool hi = rw & M;
#pragma unroll
      for (int i = 0; i < LIVE; ++i) {
        const float mine = v[i];
        const float other = __shfl_xor_sync(0xffffffffu, mine, M);
        v[i] = hi ? other : mine;
        v[LIVE + i] = hi ? mine : other;
      }
      Gather<GW, 2 * M, N, 2 * LIVE>::run(v, rw);
    }
  }
};

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
template <class K>
__device__ __forceinline__ const float* chunk_rows(const Lane& x, Ring* ring, int c) {
  if constexpr (K::SLICED) {
    if (x.streamed) return reinterpret_cast<const float*>(ring->step(c));
    return x.rec + (size_t)c * x.CR * x.RS;
  }
  return x.rec;
}

// g = tanh(W2 relu(W1 y + b1) + b2) on the thread's slice (g[i HS + j] is
// row i Hp + hoff + j of the second layer), for one lane, by its group; row
// thread rw walks rows rw, rw + GW, ..., each row's sums in order.  With
// STAGE, each row's h1 goes to the lane's row h1 (in shared memory), by the
// first slice.  MX rounds y and h1 where the products take them.
template <class K, bool MX, bool STAGE>
__device__ __forceinline__ void lane_eval(const Lane& x, Ring* ring, float* h1,
                                          const float (&y)[K::HS], float (&g)[K::N]) {
  constexpr int C = K::C, HS = K::HS, GW = K::GW, N = K::N;
  const int Hp = lane_hp<K>(x), RS = lane_rs<K>(x), hoff = lane_hoff<K>(x);
  float yr[HS];
#pragma unroll
  for (int h = 0; h < HS; ++h) yr[h] = mx_round<MX>(y[h]);
#pragma unroll
  for (int q = 0; q < N; ++q) g[q] = 0.f;
  const int R = K::SLICED ? x.R : 1;
  for (int c = 0; c < R; ++c) {
    const float* rc = chunk_rows<K>(x, ring, c);
    const int rows = K::SLICED ? min(x.CR, x.rows - c * x.CR) : x.rows;
    float* h1c = STAGE ? h1 + (K::SLICED ? c * x.CR : 0) : nullptr;
#pragma unroll 2
    for (int w = x.rw; w < rows; w += GW) {
      const float* rec = rc + w * RS;
      float a = slice_sum<K>(dot_slice<HS>(rec + hoff, yr), x);
      a += rec[(1 + C) * Hp];
      a = (a < 0.f) ? 0.f : a;
      if (STAGE && (!K::SLICED || x.s == 0)) h1c[w] = a;
      const float ar = mx_round<MX>(a);
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const float4* r2 = reinterpret_cast<const float4*>(rec + (1 + i) * Hp + hoff);
#pragma unroll
        for (int j = 0; j < HS / 4; ++j) {
          const float4 v = r2[j];
          const int q = i * HS + 4 * j;
          g[q] = fmaf(v.x, ar, g[q]);
          g[q + 1] = fmaf(v.y, ar, g[q + 1]);
          g[q + 2] = fmaf(v.z, ar, g[q + 2]);
          g[q + 3] = fmaf(v.w, ar, g[q + 3]);
        }
      }
    }
  }
  Scatter<GW / 2, N, N>::run(g, x.rw);
  constexpr int OWN = N / GW;
#pragma unroll
  for (int j = 0; j < OWN; ++j) {
    const int e = x.rw * OWN + j, i = e / HS;
    g[j] = tanhf(g[j] + x.b2s[K::SLICED ? i * Hp + hoff + (e - i * HS) : e]);
  }
  Gather<GW, 1, N, OWN>::run(g, x.rw);
}

// k_j = sum_i g[i HS + j] dx_i on the slice.  With MX and the padded layout
// (H % 8 != 0), the sum of round(g round(dx_i)), as the TPU kernel's
// selection product sel (g (rep dx)) rounds it.
template <class K, bool MX>
__device__ __forceinline__ void stage_k(const Lane& x, const float (&g)[K::N],
                                        const float (&dx)[K::C], float (&k)[K::HS]) {
  constexpr int C = K::C, HS = K::HS;
  if (MX && x.sel) {
#pragma unroll
    for (int j = 0; j < HS; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) acc += mx_round<true>(g[i * HS + j] * mx_round<true>(dx[i]));
      k[j] = acc;
    }
  } else {
    contract<HS, C>(g, dx, k);
  }
}

// One substep from z (the thread's slice), all stages, in place, by the
// lane's group; with ys, only the stage inputs ys[0 .. S-1] (the last stage
// is not evaluated) and z is left as it was.
template <class K, bool MX>
__device__ __forceinline__ void slice_substep(const Lane& x, Ring* ring, const Tableau& tab,
                                              int step, double dt, const float (&sb)[K::C],
                                              const float (&sc)[K::C], const float (&sd)[K::C],
                                              float (&z)[K::HS], float (*ys)[K::HS]) {
  constexpr int C = K::C, HS = K::HS;
  float znew[HS], k[HS];
#pragma unroll
  for (int h = 0; h < HS; ++h) {
    znew[h] = z[h];
    k[h] = 0.f;
  }
  for (int st = 0; st < tab.n_stages; ++st) {
    float y[HS];
#pragma unroll
    for (int h = 0; h < HS; ++h) y[h] = st ? z[h] + tab.a_dt[st] * k[h] : z[h];
    if (ys) {
#pragma unroll
      for (int h = 0; h < HS; ++h) ys[st][h] = y[h];
      if (st + 1 == tab.n_stages) break;
    }
    float dx[C], g[K::N];
    control_derivative<C>(sb, sc, sd, stage_fraction(tab, step, st, dt), dx);
    lane_eval<K, MX, false>(x, ring, nullptr, y, g);
    stage_k<K, MX>(x, g, dx, k);
    if (tab.c_dt[st] != 0.f) {
#pragma unroll
      for (int h = 0; h < HS; ++h) znew[h] += tab.c_dt[st] * k[h];
    }
  }
  if (!ys) {
#pragma unroll
    for (int h = 0; h < HS; ++h) z[h] = znew[h];
  }
}

// The block's resident records (rows of them) and b2 by slice.
__device__ __forceinline__ void load_records(float* rec, const float* __restrict__ w1t,
                                             const float* __restrict__ b1,
                                             const float* __restrict__ w2t, int H, int C, int W,
                                             int Hp, int rows) {
  const int total = rows * record_floats(C, Hp);
  for (int e = threadIdx.x; e < total; e += blockDim.x)
    rec[e] = rec_value(w1t, b1, w2t, H, C, W, Hp, e);
}

__device__ __forceinline__ void load_b2(float* b2s, const float* __restrict__ b2, int H, int C,
                                        int Hp) {
  for (int i = threadIdx.x; i < C * Hp; i += blockDim.x) {
    const int ch = i / Hp, k = i - ch * Hp;
    b2s[i] = k < H ? b2[ch * H + k] : 0.f;
  }
}

// A launch's plan, as ff_forward_plan and ff_backward_plan report it.
struct LaunchPlan {
  Slicing sl;
  int streamed, blocks, threads, lanes, resident, sms, groups;
  int rows, CR, R;   // rows walked; rows a chunk of streamed weights; chunks
  int nreg;          // backward: units of a thread's weight gradients in registers
  size_t bytes, scratch;  // shared bytes a block; floats of staged records
};

inline void write_plan(const LaunchPlan& p, long* out) {
  const long values[] = {p.streamed, p.blocks, p.threads,   p.lanes,       p.sl.G,
                         p.sl.GS,    p.resident, p.sms,   (long)p.bytes, (long)p.scratch};
  for (int i = 0; i < 10; ++i) out[i] = values[i];
}

// The chunk of streamed rows (a multiple of 8, as many as fit `room` floats
// in the ring's two slots) and the chunks; 0 if none fits.
inline int stream_chunk(LaunchPlan& p, int RS, size_t room) {
  p.CR = 0;
  for (int cr = 8; cr <= p.rows && 2 * (size_t)cr * RS <= room; cr += 8) p.CR = cr;
  if (!p.CR) return BAD_LAUNCH;
  p.R = (p.rows + p.CR - 1) / p.CR;
  p.scratch = (size_t)p.R * p.CR * RS;
  return 0;
}

inline Cut cut_of(const LaunchPlan& p) {
  return Cut{p.sl.Hp, p.sl.G, p.CR, p.R, p.streamed};
}

// The instance for these sizes: I(C, HS, GW, SLICED) for every C of the caps,
// one slice (H <= 8), 8 row threads (Hp 16, 32), one row thread (Hp >= 64),
// and C 1 at 16 components a slice (H > 256).
#define K1_INSTANCES(I)                                                                      \
  if (sl.GS == 1) {                                                                          \
    if (C == 1) return I(1, 8, 8, false);                                                    \
    if (C == 2) return I(2, 8, 8, false);                                                    \
    if (C == 3) return I(3, 8, 8, false);                                                    \
    if (C == 4) return I(4, 8, 8, false);                                                    \
    if (C == 5) return I(5, 8, 8, false);                                                    \
  } else if (sl.GW == 8) {                                                                   \
    if (C == 1) return I(1, 8, 8, true);                                                     \
    if (C == 2) return I(2, 8, 8, true);                                                     \
    if (C == 3) return I(3, 8, 8, true);                                                     \
    if (C == 4) return I(4, 8, 8, true);                                                     \
    if (C == 5) return I(5, 8, 8, true);                                                     \
  } else if (sl.HS == 8) {                                                                   \
    if (C == 1) return I(1, 8, 1, true);                                                     \
    if (C == 2) return I(2, 8, 1, true);                                                     \
    if (C == 3) return I(3, 8, 1, true);                                                     \
    if (C == 4) return I(4, 8, 1, true);                                                     \
    if (C == 5) return I(5, 8, 1, true);                                                     \
  } else if (C == 1) {                                                                       \
    return I(1, 16, 1, true);                                                                \
  }

}  // namespace
