// What the reversible-Heun kernels (K8) share: the forward in
// fused_reversible.cu, the backward in fused_reversible_bwd.cu.  The design
// notes of both are at the top of fused_reversible.cu; the ring that streams
// weights, the weights' records and their staging are in cde_stream.cuh,
// shared with the fixed-step kernels (K1).

#pragma once

#include <stddef.h>
#include <stdint.h>

#include "cde_stream.cuh"

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

}  // namespace
