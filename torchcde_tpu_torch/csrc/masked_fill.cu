// Masked last-observed / next-observed fill along the length axis (K3), as a
// CUDA kernel for Hopper (sm_90a).
//
// Replaces torchcde_tpu/ops/fill_pallas.py::_fill_kernel (reached through
// masked_fill_pallas).  Position i of each of 1 to 5 value arrays receives
// the entry at the most recent observed position at or before i (at or
// after i, in reverse); positions before the first observation (after the
// last, in reverse) receive the array's first (last) entry, the scan
// identity of the JAX select-combine scan.
//
// What bounds it.  Pure data movement: each value array is read once and
// written once, the mask read once; at the masked cubic fit's gradient
// shapes (8192 x 4096 float32, 1 to 5 values) that is 302 MB to 1.38 GB,
// 0.09 to 0.41 ms at 3.35 TB/s.  The recurrence is sequential along the
// length.
//
// Design.  One warp per row walks the row in tiles of 32 positions, one
// position per lane, so every load and store of a tile is one coalesced
// 128-byte access, and 8192 rows are 8192 warps: enough to keep the memory
// busy.  Within a tile, __ballot_sync gives the observed lanes, and each
// lane takes its value by __shfl_sync from the nearest observed lane at or
// before it (at or after it, in reverse), or the carry from the tiles
// already walked when there is none.  The carry is the value at the tile's
// last (first, in reverse) observed lane.  This replaces the TPU kernel's
// Hillis-Steele roll-combine over VMEM blocks; the selection is exact, so
// the result equals the plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_VALUES = 5;
constexpr int WARPS = 4;  // rows per block
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
constexpr int BAD_ARGUMENT = -2;

struct FillArrays {
  const float* in[MAX_VALUES];
  float* out[MAX_VALUES];
};

template <int NV, bool REVERSE>
__global__ void __launch_bounds__(THREADS)
    fill_kernel(FillArrays a, const uint8_t* __restrict__ obs, long long n,
                int k) {
  const long long row = blockIdx.x * (long long)WARPS + threadIdx.x / 32;
  if (row >= n) return;  // the whole warp: one row per warp
  const int lane = threadIdx.x & 31;
  const size_t base = (size_t)row * (size_t)k;
  const uint8_t* o = obs + base;
  const float* in[NV];
  float* out[NV];
  float carry[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    in[v] = a.in[v] + base;
    out[v] = a.out[v] + base;
    carry[v] = in[v][REVERSE ? k - 1 : 0];  // the scan identity
  }
  // Lanes whose observations can serve this lane: at or before it, or at
  // or after it in reverse.
  const unsigned reach = REVERSE ? ~((1u << lane) - 1u) : (2u << lane) - 1u;
  const int tiles = (k + 31) / 32;
  for (int s = 0; s < tiles; ++s) {
    const int j = (REVERSE ? tiles - 1 - s : s) * 32 + lane;
    const bool valid = j < k;
    float x[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) x[v] = valid ? in[v][j] : 0.f;
    const unsigned seen = __ballot_sync(FULL, valid && o[j] != 0);
    const unsigned mine = seen & reach;
    const int src = mine ? (REVERSE ? __ffs(mine) - 1 : 31 - __clz(mine)) : 0;
    const int last = seen ? (REVERSE ? __ffs(seen) - 1 : 31 - __clz(seen)) : 0;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float got = __shfl_sync(FULL, x[v], src);
      const float next_carry = __shfl_sync(FULL, x[v], last);
      if (valid) out[v][j] = mine ? got : carry[v];
      if (seen) carry[v] = next_carry;
    }
  }
}

template <int NV>
int launch(const FillArrays& a, const uint8_t* obs, long long n, int k,
           int reverse, cudaStream_t stream) {
  const long long blocks = (n + WARPS - 1) / WARPS;
  if (reverse)
    fill_kernel<NV, true><<<(unsigned)blocks, THREADS, 0, stream>>>(a, obs, n, k);
  else
    fill_kernel<NV, false><<<(unsigned)blocks, THREADS, 0, stream>>>(a, obs, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mf_error_string(int code) {
  if (code == BAD_ARGUMENT) return "invalid argument";
  return cudaGetErrorString((cudaError_t)code);
}

// in_k / out_k: the value arrays (n, k), float32, contiguous; unused ones
// null.  obs: (n, k) bytes, nonzero where observed.
int mf_fill(const float* in0, const float* in1, const float* in2,
            const float* in3, const float* in4, float* out0, float* out1,
            float* out2, float* out3, float* out4, const uint8_t* obs,
            long long n, int k, int n_values, int reverse, void* stream) {
  if (n <= 0 || k <= 0 || n_values < 1 || n_values > MAX_VALUES ||
      (n + WARPS - 1) / WARPS > 0x7fffffffLL)
    return BAD_ARGUMENT;
  FillArrays a = {{in0, in1, in2, in3, in4}, {out0, out1, out2, out3, out4}};
  for (int v = 0; v < n_values; ++v)
    if (!a.in[v] || !a.out[v]) return BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_values) {
    case 1: return launch<1>(a, obs, n, k, reverse, s);
    case 2: return launch<2>(a, obs, n, k, reverse, s);
    case 3: return launch<3>(a, obs, n, k, reverse, s);
    case 4: return launch<4>(a, obs, n, k, reverse, s);
    default: return launch<5>(a, obs, n, k, reverse, s);
  }
}

}  // extern "C"
