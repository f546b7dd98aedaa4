// What the reversible-Heun kernels (K8) share: the forward in
// fused_reversible.cu, the backward in fused_reversible_bwd.cu.  The design
// notes of both are at the top of fused_reversible.cu.

#pragma once

#include <stddef.h>
#include <stdint.h>

#include "cde_stage.cuh"

namespace {

constexpr int MAX_SUBSTEPS = 8;

// The shapes both kernels take: every one inside the JAX package's caps
// (W <= 512, C*H <= 512, 3*C <= 16, m <= 8).
inline int check_call(int B, int n, int H, int C, int W, int m) {
  if (B < 1 || n < 1 || H < 1 || C < 1 || W < 1 || m < 1 || m > MAX_SUBSTEPS) return BAD_ARGUMENT;
  if (W > 512 || C * H > 512 || 3 * C > 16) return BAD_ARGUMENT;
  return 0;
}

// The interval's fraction after s substeps of dt, rounded once.
__device__ __forceinline__ float fraction(int s, double dt) {
  return (float)((double)s * dt);
}

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

}  // namespace
