// Fixed-step Neural CDE solve, forward (this file) and backward
// (fused_fixed_bwd.cu), as two CUDA kernels for Hopper (sm_90a); what both
// share is in fused_fixed.cuh.
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
// Slab and residual traffic is ~65 MB: latency- and compute-bound on the
// CUDA cores, not memory-bound.
//
// The kernels drop the TPU padding (the batch to 128 lanes, 16 slab rows per
// interval): operands are packed (feature, batch) without padding; H is
// padded only inside the kernels, to whole state slices of zero weights.
// No --use_fast_math: tanhf stays the accurate version.
//
// Two modes, as the TPU kernels have (their mx and ct_dtype): float32, and
// bfloat16 for bfloat16 models (mode 1).  In the bfloat16 mode the slab
// table ct and its cotangent dct are bfloat16: slabs are upcast on load and
// dct is summed in float32 and stored rounded, which halves the slab bytes.
// The state, the weights and every sum stay float32, and the operands of the
// stage products are rounded to bfloat16 where the TPU kernel feeds its
// matrix unit bfloat16 operands (cde_stage.cuh), and, where H % 8 != 0, so
// are the selection products of the TPU kernel's padded layout (stage_k,
// slice_vjp).  Each rounding is two conversions; the products stay on the
// CUDA cores.  Both modes have the same bound.
//
// One forward and one backward take every shape inside the JAX package's
// caps (W <= 512, C*H <= 512, 3*C <= 16, m <= 8), H, C and W at run time.
// Both run a group of G threads per batch lane (fused_fixed.cuh): GS slices
// of 8 state components, each split over GW threads by hidden rows, the
// lane's chain replicated in the slice's registers and its sums taken by
// shuffle butterflies.  Up to Hp 32 a slice has 8 row threads (G 8, 16, 32
// at H 8, 16, 32); past it one (G = GS: 8, 16, 32 at Hp 64, 128, 256; C 1
// past H 256 takes slices of 16).  Blocks of lanes share one copy of the
// weights, as records of (1 + C) Hp + 4 floats a row (cde_stream.cuh):
// resident in shared memory where they fit, streamed a chunk of rows at a
// time through a two-slot cp.async ring from a copy staged once per launch
// where they do not.  As many blocks run as the SMs hold at once, at most
// one per lane group, striding over the groups beyond that; where the lane
// groups are fewer than half the SMs, a block takes half the lanes while that
// costs nothing else (small_batch_lanes), so small batches spread over more
// of the card.
//  * The forward (below): blocks of FF_LANES lanes; its shared memory is the
//    weights and b2 alone.  This replaces the TPU's sequential grid axis and
//    its VMEM carry of z.
//  * The backward (fused_fixed_bwd.cu) recomputes each interval's substeps
//    and stages from the stored knot state, as the TPU kernel does, in blocks
//    of FB_THREADS threads, and reduces the weight gradients over its block's
//    lanes in units of 4 rows x 4 columns, the first one or two of a
//    thread's in registers for the whole walk, the rest in the block's own
//    slice of the partials; the blocks' partials are summed after the
//    launch, as the JAX package sums its per-tile partials: deterministic, no
//    float atomics.
//
// The instances (K1_INSTANCES): every C of the caps at one slice (H <= 8:
// the flagship's, every size at compile time), at slices of 8 row threads
// (Hp 16, 32) and of one (Hp >= 64), and C 1 at slices of 16 components;
// the backward's with two register units, and with one for the flagship's
// C 3 at one slice.  In both modes: 32 forward kernels (this source) and 34
// backward ones (fused_fixed_bwd.cu and fused_fixed_bwd_bf16.cu, a mode
// each), built by one nvcc process per source, all in parallel (each
// source's seconds: chip_smoke.py's build phase; PERF.md).
//
// Layouts (all float32, batch minor):
//   ct   (n, 3, C, B)  rows b, 2c, 3d of the control's cubic per interval
//                      (float32, or bfloat16 in the bfloat16 mode, as dct)
//   z0t  (H, B)        w1t (W, H)  b1 (W)  w2t (C*H, W)  b2 (C*H)
//   w2t/b2 rows are in the kernel order q = i*H + h (the model's h*C + i,
//   permuted by the wrapper).
//   slot (n) int32     output slot of knot j + 1, or -1
//   out  (n_out, H, B) zres (n, H, B): the state after every interval
//   scratch            the staged records where the weights stream (the
//                      plan's scratch floats), else unused
// Backward outputs: dct (n, 3, C, B), dz0 (H, B) and per-block partials
//   dw1p (blocks, W, H), db1p (blocks, W), dw2p (blocks, W, C*H),
//   db2p (blocks, C*H), with the blocks of ff_backward_plan(...).

#include "fused_fixed.cuh"

namespace {

// ---------------------------------------------------------------------------
// The forward: a group of G threads per lane (its slice of the chain in
// registers, each evaluation lane_eval, so every thread of a slice holds the
// same bits of g and of the state, and the forward's stage values are the
// backward's recompute's), blocks of FF_LANES lanes (fewer at small
// batches).  In the bfloat16 mode y and each thread's own h1 are rounded
// where lane_eval rounds them, off the lane's serial chain.  Row thread rw
// of a slice writes the slice's state components j = rw (mod GW) of zres and
// of the requested outputs; the slab rows are read by every thread of the
// group (one address a group, served by L1).
//
// 8-lane blocks at H 8: on an H100 at the flagship, 32-lane blocks took 1.30x
// as long and 16-lane ones up to 2 % longer; 4 threads a lane in 8-, 16- or
// 32-lane blocks gained nothing (PERF.md).

template <class K, typename T, bool MX>
__device__ __forceinline__ void forward_lanes(const Lane& x, Ring* ring, const T* __restrict__ ct,
                                              const float* __restrict__ z0t,
                                              const int* __restrict__ slot,
                                              float* __restrict__ out, float* __restrict__ zres,
                                              int B, int n, int H, int m, double dt,
                                              const Tableau& tab) {
  constexpr int C = K::C, HS = K::HS, GW = K::GW;
  const int G = K::SLICED ? x.G : GW, hoff = lane_hoff<K>(x);
  const int l = threadIdx.x / G, LB = blockDim.x / G;
  for (int grp = blockIdx.x; grp < (B + LB - 1) / LB; grp += gridDim.x) {
    const int lane = grp * LB + l;
    const bool live = lane < B;
    float z[HS];
#pragma unroll
    for (int j = 0; j < HS; ++j) {
      const int h = hoff + j;
      z[j] = live && h < H ? z0t[(size_t)h * B + lane] : 0.f;
    }
    for (int j = 0; j < n; ++j) {
      float sb[C], sc[C], sd[C];
      load_slab<HS, C, T>(ct, j, B, lane, live, sb, sc, sd);
      for (int step = 0; step < m; ++step)
        slice_substep<K, MX>(x, ring, tab, step, dt, sb, sc, sd, z, nullptr);
      if (!live) continue;
      const int sl = slot[j];
#pragma unroll
      for (int jj = 0; jj < HS; ++jj) {
        const int h = hoff + jj;
        if (jj % GW != x.rw || h >= H) continue;
        zres[((size_t)j * H + h) * B + lane] = z[jj];
        if (sl >= 0) out[((size_t)sl * H + h) * B + lane] = z[jj];
      }
    }
  }
}

template <int C, int HS, int GW, bool SLICED, typename T, bool MX>
__global__ void __launch_bounds__(SLICED ? FF_LANES * MAX_GROUP : FF_LANES * GW)
    fwd_slice_kernel(const T* __restrict__ ct, const float* __restrict__ z0t,
                     const float* __restrict__ w1t, const float* __restrict__ b1,
                     const float* __restrict__ w2t, const float* __restrict__ b2,
                     const float4* __restrict__ staged, const int* __restrict__ slot,
                     float* __restrict__ out, float* __restrict__ zres, int B, int n, int H,
                     int W, int m, double dt, Tableau tab, Cut cut) {
  using K = Shape<C, HS, GW, SLICED>;
  extern __shared__ float4 ff_smem[];
  float* sm = reinterpret_cast<float*>(ff_smem);
  const int Hp = SLICED ? cut.Hp : HS, G = SLICED ? cut.G : GW;
  const int rows = walk_rows(W), RS = record_floats(C, Hp);
  const bool streamed = SLICED && cut.streamed;
  float* b2s = sm + (size_t)(streamed ? 2 * cut.CR : rows) * RS;
  if (!streamed) load_records(sm, w1t, b1, w2t, H, C, W, Hp, rows);
  load_b2(b2s, b2, H, C, Hp);
  const int r = threadIdx.x % G, s = r / GW;
  const Lane x{sm, b2s, Hp, RS, G, rows, streamed ? cut.CR : rows, streamed ? cut.R : 1, s,
               r % GW, s * HS, streamed, H % 8 != 0};
  if constexpr (SLICED) {
    Ring ring(ff_smem, staged, streamed ? cut.CR * RS / 4 : 0, cut.R);
    __syncthreads();
    forward_lanes<K, T, MX>(x, &ring, ct, z0t, slot, out, zres, B, n, H, m, dt, tab);
    copy_wait();
  } else {
    __syncthreads();
    forward_lanes<K, T, MX>(x, nullptr, ct, z0t, slot, out, zres, B, n, H, m, dt, tab);
  }
}

template <typename T, bool MX>
using FwdKernel = decltype(&fwd_slice_kernel<1, 8, 8, false, T, MX>);

template <typename T, bool MX>
FwdKernel<T, MX> forward_kernel(const Slicing& sl, int C) {
#define K1_FWD(c, hs, gw, sliced) fwd_slice_kernel<c, hs, gw, sliced, T, MX>
  K1_INSTANCES(K1_FWD)
#undef K1_FWD
  return nullptr;
}

// The forward launch for these shapes: the group, the lanes a block, the
// weights' path (resident, or streamed in chunks as large as fit), and as
// many blocks as the SMs hold at once, at most one per lane group.
template <typename T, bool MX>
int forward_plan(LaunchPlan& p, int B, int H, int C, int W) {
  p.sl = slicing(H, C);
  if (p.sl.G > MAX_GROUP) return BAD_ARGUMENT;
  int rc = card_sms(p.sms);
  if (rc) return rc;
  p.lanes = small_batch_lanes(FF_LANES, p.sl.G, B, p.sms, 64, [](int) { return true; });
  p.threads = p.lanes * p.sl.G;
  p.rows = walk_rows(W);
  p.nreg = 0;
  const int RS = record_floats(C, p.sl.Hp);
  const size_t fixed = (size_t)C * p.sl.Hp, room = MAX_SMEM / sizeof(float) - fixed;
  p.streamed = (size_t)p.rows * RS > room;
  p.CR = p.rows;
  p.R = 1;
  p.scratch = 0;
  if (p.streamed) {
    rc = stream_chunk(p, RS, room);
    if (rc) return rc;
  }
  p.bytes = sizeof(float) * (fixed + (size_t)(p.streamed ? 2 * p.CR : p.rows) * RS);
  const FwdKernel<T, MX> kernel = forward_kernel<T, MX>(p.sl, C);
  if (!kernel) return BAD_ARGUMENT;
  rc = resident_blocks(kernel, p.threads, p.bytes, p.resident);
  if (rc) return rc;
  if (p.resident < 1) return BAD_LAUNCH;
  p.groups = (B + p.lanes - 1) / p.lanes;
  p.blocks = std::min<long>(p.groups, (long)p.resident * p.sms);
  return 0;
}

// The forward launch of one mode, as forward_plan plans it: T the slab
// storage, MX the operand rounding.
template <typename T, bool MX>
int forward_mode(const void* ct, const float* z0t, const float* w1t, const float* b1,
                 const float* w2t, const float* b2, const int* slot, float* out, float* zres,
                 float* scratch, int B, int n, int H, int C, int W, int m, double dt,
                 const Tableau& tab, int blocks, cudaStream_t st) {
  LaunchPlan p;
  int rc = forward_plan<T, MX>(p, B, H, C, W);
  if (rc) return rc;
  if (p.blocks != blocks || (p.scratch && !scratch)) return BAD_ARGUMENT;
  if (p.streamed) {
    rc = stage_records(w1t, b1, w2t, H, C, W, p.sl.Hp, p.R * p.CR, scratch, st);
    if (rc) return rc;
  }
  forward_kernel<T, MX>(p.sl, C)<<<p.blocks, p.threads, p.bytes, st>>>(
      static_cast<const T*>(ct), z0t, w1t, b1, w2t, b2,
      reinterpret_cast<const float4*>(scratch), slot, out, zres, B, n, H, W, m, dt, tab,
      cut_of(p));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ff_error_string(int code) {
  if (code == BAD_ARGUMENT) return "invalid argument";
  if (code == BAD_LAUNCH) return "no launch of the kernel fits these shapes";
  return cudaGetErrorString((cudaError_t)code);
}

// The forward launch for these shapes in this mode, into out[10]: the
// weights' path (0 resident in shared memory, 1 streamed through it),
// blocks, threads per block, lanes a block walks at once, threads per lane,
// state slices per lane, blocks an SM holds, SMs, shared bytes of a block
// and floats of the staged records (0 when resident).
int ff_forward_plan(int B, int H, int C, int W, int m, int n_stages, int mode, long* out) {
  if (!shapes_ok(B, H, C, W, m, n_stages, mode)) return BAD_ARGUMENT;
  LaunchPlan p;
  const int rc = mode == 1 ? forward_plan<__nv_bfloat16, true>(p, B, H, C, W)
                           : forward_plan<float, false>(p, B, H, C, W);
  if (!rc) write_plan(p, out);
  return rc;
}

// mode 0: float32 ct; mode 1: bfloat16 ct, bfloat16 operands in the stage
// products (the other pointers are float32 in both).  blocks: as
// ff_forward_plan plans them; scratch: its scratch floats, or null.
int ff_forward(const void* ct, const float* z0t, const float* w1t, const float* b1,
               const float* w2t, const float* b2, const int* slot, float* out, float* zres,
               float* scratch, int B, int n, int H, int C, int W, int m, double dt,
               int n_stages, const double* alpha, const double* a, const double* c, int mode,
               int blocks, void* stream) {
  if (n < 1 || !shapes_ok(B, H, C, W, m, n_stages, mode)) return BAD_ARGUMENT;
  Tableau tab;
  const int rc = make_tableau(n_stages, alpha, a, c, dt, &tab);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 1)
    return forward_mode<__nv_bfloat16, true>(ct, z0t, w1t, b1, w2t, b2, slot, out, zres,
                                             scratch, B, n, H, C, W, m, dt, tab, blocks, st);
  return forward_mode<float, false>(ct, z0t, w1t, b1, w2t, b2, slot, out, zres, scratch, B, n,
                                    H, C, W, m, dt, tab, blocks, st);
}

}  // extern "C"
