// Weights that stream through a block's shared memory, shared by the
// fixed-step kernels (K1: fused_fixed.cu, fused_fixed_bwd.cu) and the
// reversible-Heun backward (K8: fused_reversible_bwd.cu); K8's forward uses
// the ring alone, over its own fragment-ordered copy.
//
// A row w of the MLP field's hidden layer is one record of
// record_floats(C, Hp) floats: W1's row (Hp), W2's column (C Hp, in the
// order q = i Hp + h), b1 and three zeros, the state index padded to Hp with
// zero weights (exact).  Where the records fit, a block keeps them resident
// in shared memory; where they do not, a small kernel stages them once per
// launch in device memory, and the block walks them a chunk of rows at a
// time through a ring of two slots fed by cp.async.
//
// Layouts (float32): w1t (W, H), b1 (W), w2t (C*H, W); the rows of w2t are
// in the kernel order q = i*H + h.

#pragma once

#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "cde_stage.cuh"

namespace {

// count float4s from src (device memory) to dst (shared memory) by
// cp.async, spread over the block's threads, as one commit group.
__device__ __forceinline__ void copy_async(float4* dst, const float4* __restrict__ src,
                                           int count) {
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const unsigned at = (unsigned)__cvta_generic_to_shared(dst + e);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(at), "l"(src + e)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Weights that do not fit a block's shared memory: a ring of two slots, each
// one chunk of the weights as staged in device memory (`size` float4s a
// chunk), fed by cp.async.  Every thread of the block steps it, in the same
// order: chunks 0, 1, ..., chunks - 1, 0, 1, ...
struct Ring {
  float4* slots;
  const float4* src;
  int size, chunks, fetched;

  // Starts the copy of chunk 0 into the first slot.
  __device__ Ring(float4* slots_, const float4* src_, int size_, int chunks_)
      : slots(slots_), src(src_), size(size_), chunks(chunks_), fetched(0) {
    copy_async(slots, src, size);
  }

  // Waits for chunk c (the next in order), makes it visible to the block,
  // starts the copy of the chunk after it into the other slot (whose chunk
  // every thread is done with: it passed this barrier), and returns chunk c.
  __device__ const float4* step(int c) {
    copy_wait();
    __syncthreads();
    const int following = c + 1 == chunks ? 0 : c + 1;
    copy_async(slots + ((fetched + 1) & 1) * size, src + (size_t)following * size, size);
    return slots + (fetched++ & 1) * size;
  }
};

// Floats of one row's record: W1's row (Hp), W2's column (C Hp, in the order
// q = i Hp + h), b1 and three zeros.
__host__ __device__ inline int record_floats(int C, int Hp) { return (1 + C) * Hp + 4; }

// Value e of the records, rows past W zero.
__device__ __forceinline__ float rec_value(const float* __restrict__ w1t,
                                           const float* __restrict__ b1,
                                           const float* __restrict__ w2t, int H, int C, int W,
                                           int Hp, int e) {
  const int RS = record_floats(C, Hp);
  const int w = e / RS, o = e - w * RS;
  if (w >= W) return 0.f;
  if (o < Hp) return o < H ? w1t[(size_t)w * H + o] : 0.f;
  if (o < (1 + C) * Hp) {
    const int i = (o - Hp) / Hp, k = o - Hp - i * Hp;
    return k < H ? w2t[(size_t)(i * H + k) * W + w] : 0.f;
  }
  return o == (1 + C) * Hp ? b1[w] : 0.f;
}

// The records of `rows` rows into device memory, for the blocks to stream.
__global__ void stage_records_kernel(const float* __restrict__ w1t, const float* __restrict__ b1,
                                     const float* __restrict__ w2t, int H, int C, int W, int Hp,
                                     int rows, float* __restrict__ out) {
  const int total = rows * record_floats(C, Hp);
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += gridDim.x * blockDim.x)
    out[e] = rec_value(w1t, b1, w2t, H, C, W, Hp, e);
}

// Launches stage_records_kernel on stream st; 0 or the launch's error.
inline int stage_records(const float* w1t, const float* b1, const float* w2t, int H, int C,
                         int W, int Hp, int rows, float* out, cudaStream_t st) {
  const int total = rows * record_floats(C, Hp);
  stage_records_kernel<<<std::min((total + 255) / 256, 1024), 256, 0, st>>>(
      w1t, b1, w2t, H, C, W, Hp, rows, out);
  return (int)cudaGetLastError();
}

}  // namespace
