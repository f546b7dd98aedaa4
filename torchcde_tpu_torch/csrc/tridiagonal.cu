// Batched tridiagonal solve (K4), as CUDA kernels for Hopper (sm_90a).
//
// Replaces torchcde_tpu/ops/tridiagonal_pallas.py::_pcr_thomas_kernel
// (reached through tridiagonal_solve_pallas; its custom VJP _tp_bwd is the
// same solve with the bands swapped, which the wrapper launches again).
// Solves A x = b for every row of b (n, k), A with diagonal d (k), upper u
// (k - 1) and lower l (k - 1).  Each band is read with a row stride of its
// own: 0 where one band serves every row (the natural cubic fit's bands
// depend on the times alone), so broadcast bands are never materialised.
//
// What bounds it.  The work is the Thomas recurrence, 8 flops per row and
// position.  At the dense fit's shape (8192 x 4096 float32, shared bands)
// the function reads b once and writes x once: 268 MB, 0.08 ms at
// 3.35 TB/s; the 0.27 GFLOP are nothing.  Bytes bound it, and a sequential
// recurrence with one thread per row is far from that: 8192 rows are 256
// warps, under two an SM, each waiting on its own chain of 2 k dependent
// steps.
//
// Four routes; the wrapper (ops/tridiagonal_kernel.py, solve_plan) picks
// one from k and the bands' strides.
//
// Shared bands, k <= RES_MAX (the fit's systems, forward and transposed):
// band_pivot_kernel, then shared_band_kernel.  With one band for every row
// the eliminated diagonal nd_i = d_i - l_{i-1} u_{i-1} / nd_{i-1} is the
// same for every row, so one block computes it once per launch: a scan of
// the Moebius maps nd -> (d_i nd - l_{i-1} u_{i-1}) / nd as 2 x 2 matrices,
// products rescaled by a power of two (row_scan.cuh's MoebiusOp: a float32
// product over thousands of positions overflows otherwise), into a (3, P)
// scratch of w_i = l_{i-1} / nd_{i-1}, r_i = 1 / nd_i and c_i = u_i / nd_i
// (P = threads_per_row * RP, zero past k; 48 KB at k 4096, which stays in
// L2).  Then each row stays resident in the registers of a power of two of
// threads, RP positions a thread, as K6/K7's rows do (row_scan.cuh): b is
// staged in through shared memory with coalesced loads, the elimination
// nb_i = b_i - w_i nb_{i-1} is an affine scan across the row, the
// substitution x_i = r_i nb_i - c_i x_{i+1} an affine suffix scan, and x
// leaves through shared memory as b came in.  So b is read once and x
// written once, and every row's recurrences run as RP-long chunks joined by
// log-depth scans.  A chunk's composed map multiplies the w (or c) of its
// positions: those products are entries of the triangular factors'
// inverses, which the Thomas recurrence forms too, so the scans overflow
// only where Thomas' own intermediates would.
//
// Per-row bands, k <= RES_MAX: per_row_kernel.  Each row resident as above,
// its four operands staged through shared memory (b, d in rows of k, u, l
// in rows of k - 1; a band of stride 0 serves every row), so each is read
// once and x written once.  The pivots are the row's own: its Moebius maps
// scanned across its threads give each chunk the eliminated diagonal before
// it, then the chunk's nd, the elimination's affine scan and the
// substitution's affine suffix scan, as above, with w, 1 / nd and u / nd
// formed where they are used.  Three buffers hold the four operands (b
// comes by cp.async into d's once the diagonal is done): 53 KB of shared
// memory a block, four blocks an SM.  The transpose solve of the gradient
// (the bands swapped) is the same launch.
//
// Rows of RES_MAX < k <= CLUSTER_MAX * RES_MAX: the same kernels over a
// thread block cluster a row (row_scan.cuh: cluster_shape, cluster_scan).
// Each of the cluster's cs blocks holds one segment of the row exactly as a
// resident block holds a row, and each scan gains the cluster level: the
// blocks' totals composed in rank order through distributed shared memory.
// Per-row bands take per_row_kernel<true>; shared bands compute the pivots
// once a launch with band_pivot_kernel<true> (one cluster over the band,
// into a (3, cs seg) scratch, 384 KB at 32 768 positions, resident in L2),
// then shared_band_kernel<true> reads only b and writes only x.  The launch
// goes through cudaLaunchKernelEx with the cluster dimension; a refused
// launch is an error, as any other.
//
// Longer rows: thomas_kernel, one thread
// per row running the Thomas algorithm exactly as the JAX package's
// tridiagonal_solve_thomas orders it (forward elimination, then back
// substitution), so against that function it differs only by rounding (and
// by fused multiply-adds).  The eliminated right-hand side is kept in x
// itself (the thread's own row); the eliminated diagonal goes to a
// length-major (k, n) scratch from PyTorch's allocator, so a warp's
// accesses to it are coalesced.  Each sweep loads the operands of STEP
// positions before it computes them: the loads do not depend on the
// recurrence, so STEP of them are in flight at once instead of one memory
// latency per position.  Blocks are one warp, so the rows spread over every
// SM.
//
// The TPU kernel's PCR levels, interleaved slabs and the pre-split of
// lengths over 1024 exist only to fill vector lanes and fit VMEM; they have
// no counterpart.  Every route runs in a fixed order without atomics: two
// launches give the same bits.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "row_scan.cuh"

namespace {

constexpr int THREADS = 32;  // one warp per block: the rows spread over every SM
constexpr int STEP = 16;  // positions whose operands are loaded together
constexpr int BAD_ARGUMENT = -2;

__global__ void __launch_bounds__(THREADS)
    thomas_kernel(const float* __restrict__ b, const float* __restrict__ u,
                  const float* __restrict__ d, const float* __restrict__ l,
                  float* __restrict__ x, float* __restrict__ nd, long long n,
                  int k, long long sb, long long su, long long sd,
                  long long sl) {
  const long long row = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (row >= n) return;
  const float* br = b + row * sb;
  const float* ur = u + row * su;
  const float* dr = d + row * sd;
  const float* lr = l + row * sl;
  float* xr = x + row * (long long)k;
  // Forward elimination: nd_i = d_i - (l_{i-1} / nd_{i-1}) u_{i-1};
  // nb_i likewise; nb is stored in x, nd in the length-major scratch.
  float prev_d = dr[0], prev_b = br[0];
  nd[row] = prev_d;
  xr[0] = prev_b;
  for (int i0 = 1; i0 < k; i0 += STEP) {
    float lv[STEP], uv[STEP], dv[STEP], bv[STEP];
#pragma unroll
    for (int s = 0; s < STEP; ++s) {
      const int i = i0 + s;
      if (i < k) {
        lv[s] = lr[i - 1];
        uv[s] = ur[i - 1];
        dv[s] = dr[i];
        bv[s] = br[i];
      }
    }
#pragma unroll
    for (int s = 0; s < STEP; ++s) {
      const int i = i0 + s;
      if (i < k) {
        const float w = lv[s] / prev_d;
        prev_d = dv[s] - w * uv[s];
        prev_b = bv[s] - w * prev_b;
        nd[(long long)i * n + row] = prev_d;
        xr[i] = prev_b;
      }
    }
  }
  // Back substitution: x_i = (nb_i - u_i x_{i+1}) / nd_i.
  float x_next = prev_b / prev_d;
  xr[k - 1] = x_next;
  for (int i0 = k - 2; i0 >= 0; i0 -= STEP) {
    float bv[STEP], uv[STEP], dv[STEP];
#pragma unroll
    for (int s = 0; s < STEP; ++s) {
      const int i = i0 - s;
      if (i >= 0) {
        bv[s] = xr[i];
        uv[s] = ur[i];
        dv[s] = nd[(long long)i * n + row];
      }
    }
#pragma unroll
    for (int s = 0; s < STEP; ++s) {
      const int i = i0 - s;
      if (i >= 0) {
        x_next = (bv[s] - uv[s] * x_next) / dv[s];
        xr[i] = x_next;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Shared bands: the pivots once, then each row resident (or, past RES_MAX,
// each row over a cluster).

constexpr size_t BAND_SMEM = sizeof(float) * (RES_BUF + RT / 32 * SCAN_SLOT);
constexpr size_t BAND_CLUSTER_SMEM = BAND_SMEM + sizeof(float) * CLUSTER_SLOTS * SCAN_SLOT;

// piv (3, P): rows w, r, c as above, zero at positions past k; P = tpr * RP
// (one block of RT threads, the first tpr of them holding the band, RP
// positions each, the rest running the same scan on nothing), or, over a
// cluster, P = cs * seg (block r of the one cluster holds positions
// [r seg, (r + 1) seg) in all its threads).
template <bool CLUSTER>
__global__ void __launch_bounds__(RT)
    band_pivot_kernel(const float* __restrict__ u, const float* __restrict__ d,
                      const float* __restrict__ l, float* __restrict__ piv, int k, int tpr,
                      int seg) {
  __shared__ float scratch[RT / 32 * SCAN_SLOT];
  __shared__ float slot[SCAN_SLOT];
  const int tid = threadIdx.x;
  const int cs = CLUSTER ? (k + seg - 1) / seg : 1;
  const int P = CLUSTER ? cs * seg : tpr * RP;
  const int j0 = (CLUSTER ? (int)blockIdx.x * seg : 0) + (tid % tpr) * RP;
  const bool mine = CLUSTER ? tid * RP < seg : tid < tpr;
  // The chunk's maps: position j's is [[d_j, -l_{j-1} u_{j-1}], [1, 0]]
  // (l_{-1} u_{-1} = 0), applied to 1 at the start of the row.
  Vec<4> mob = MoebiusOp::identity();
  float lu[RP], dv[RP];
#pragma unroll
  for (int s = 0; s < RP; ++s) {
    const int j = j0 + s;
    const bool in = mine && j < k;
    dv[s] = in ? d[j] : 1.f;
    lu[s] = in && j > 0 ? l[j - 1] * u[j - 1] : 0.f;
    if (in) mob = MoebiusOp::compose(mob, {{dv[s], -lu[s], 1.f, 0.f}});
  }
  mob = full_scan<MoebiusOp, false, CLUSTER>(mob, tpr, scratch, slot);
  if (mine) {
    float prev = (mob.v[0] + mob.v[1]) / (mob.v[2] + mob.v[3]);  // nd_{j0 - 1}
#pragma unroll
    for (int s = 0; s < RP; ++s) {
      const int j = j0 + s;
      float w = 0.f, r = 0.f, c = 0.f;
      if (j < k) {
        w = j > 0 ? l[j - 1] / prev : 0.f;
        prev = dv[s] - lu[s] / prev;
        r = 1.f / prev;
        c = j + 1 < k ? u[j] / prev : 0.f;
      }
      piv[j] = w;
      piv[P + j] = r;
      piv[2 * P + j] = c;
    }
  }
  if (CLUSTER) cluster_done();
}

// x (n, k) from b (n, k) and the pivots (3, P) of band_pivot_kernel: tpr
// threads a row, RT / tpr rows a block; or, over a cluster, one segment of a
// row a block.  Five blocks an SM: the cap of 48 registers a thread costs a
// few bytes of spills, and on an H100 at config 3 it ran faster than three
// or four blocks without them, or six (PERF.md).
template <bool CLUSTER>
__global__ void __launch_bounds__(RT, 5)
    shared_band_kernel(const float* __restrict__ b, const float* __restrict__ piv,
                       float* __restrict__ x, long long n, int k, int tpr, int seg) {
  extern __shared__ float band_smem[];
  float* buf = band_smem;            // [RES_BUF] the block's rows of b, then of x
  float* scratch = buf + RES_BUF;    // [RT / 32][SCAN_SLOT] the scans' warp totals
  float* slots = scratch + RT / 32 * SCAN_SLOT;  // [2][SCAN_SLOT] a cluster's exchanges
  const RowPart p = row_part<CLUSTER>(n, k, tpr, seg);
  const int P = CLUSTER ? (k + seg - 1) / seg * seg : tpr * RP;
  const int tid = threadIdx.x, rb = p.rb, j0 = p.j0, len = p.len;
  const bool live = p.live;

  // Stage the block's rows of b (one contiguous range), coalesced.
  const float* bb = b + p.row0 * k + p.seg0;
  for (int i = tid; i < p.rows * len; i += RT) buf[staged(i)] = bb[i];
  float v[RP], w[RP];
  const bool held = !CLUSTER || j0 < seg;  // the thread's positions lie in the scratch
  const float4* p4 = reinterpret_cast<const float4*>(piv + p.seg0 + j0);
#pragma unroll
  for (int q = 0; q < RP / 4; ++q) {
    const float4 a = held ? p4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    w[4 * q] = a.x, w[4 * q + 1] = a.y, w[4 * q + 2] = a.z, w[4 * q + 3] = a.w;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < RP; ++s) v[s] = live && j0 + s < len ? buf[staged(rb * len + j0 + s)] : 0.f;

  // Elimination: nb_j = b_j - w_j nb_{j-1}, the map nb -> -w_j nb + b_j.
  Vec<2> aff = AffineOp::identity();
#pragma unroll
  for (int s = 0; s < RP; ++s)  // over a cluster, a block's threads past its segment hold none
    if (!CLUSTER || j0 + s < len) aff = AffineOp::compose(aff, {{-w[s], v[s]}});
  aff = full_scan<AffineOp, false, CLUSTER>(aff, tpr, scratch, slots);
  float carry = aff.v[1];  // applied to nb_{-1} = 0
#pragma unroll
  for (int s = 0; s < RP; ++s) {
    carry = v[s] - w[s] * carry;
    v[s] = carry;
  }
  float r[RP], c[RP];
#pragma unroll
  for (int q = 0; q < RP / 4; ++q) {
    const float4 e = held ? p4[P / 4 + q] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 f = held ? p4[P / 2 + q] : make_float4(0.f, 0.f, 0.f, 0.f);
    r[4 * q] = e.x, r[4 * q + 1] = e.y, r[4 * q + 2] = e.z, r[4 * q + 3] = e.w;
    c[4 * q] = f.x, c[4 * q + 1] = f.y, c[4 * q + 2] = f.z, c[4 * q + 3] = f.w;
  }
  // Substitution: x_j = r_j nb_j - c_j x_{j+1}, in reverse (c_{k-1} = 0).
  aff = AffineOp::identity();
#pragma unroll
  for (int s = RP - 1; s >= 0; --s)
    if (!CLUSTER || j0 + s < len) aff = AffineOp::compose(aff, {{-c[s], r[s] * v[s]}});
  aff = full_scan<AffineOp, true, CLUSTER>(aff, tpr, scratch, slots + SCAN_SLOT);
  carry = aff.v[1];  // applied to x_k = 0
#pragma unroll
  for (int s = RP - 1; s >= 0; --s) {
    carry = r[s] * v[s] - c[s] * carry;
    v[s] = carry;
  }
  __syncthreads();  // every read of b in buf is done
#pragma unroll
  for (int s = 0; s < RP; ++s)
    if (live && j0 + s < len) buf[staged(rb * len + j0 + s)] = v[s];
  __syncthreads();
  float* xb = x + p.row0 * k + p.seg0;
  for (int i = tid; i < p.rows * len; i += RT) xb[i] = buf[staged(i)];
  if (CLUSTER) cluster_done();
}

// ---------------------------------------------------------------------------
// Per-row bands: each row resident (or, past RES_MAX, over a cluster) with
// its own pivots.

constexpr int ROW_BUF = RES_BUF + 4;  // staged floats of an operand: RES_MAX + 1 positions
constexpr size_t ROWS_SMEM =
    sizeof(float) * (3 * ROW_BUF + RT / 32 * SCAN_SLOT + CLUSTER_SLOTS * SCAN_SLOT);

// Stages count elements of a band into dst[staged(at + i)]: src[row0 s +
// base + i], or, where a band of stride 0 (one for every row, rows of width
// positions) wraps past its end, src[(base + i) % width].
__device__ __forceinline__ void stage_band(float* dst, int at, const float* __restrict__ src,
                                           long long row0, long long s, int width, int base,
                                           int count) {
  if (s || base + count <= width) {
    const float* q = src + row0 * s + base;
    for (int i = threadIdx.x; i < count; i += RT) dst[staged(at + i)] = q[i];
  } else {
    for (int i = threadIdx.x; i < count; i += RT) dst[staged(at + i)] = src[(base + i) % width];
  }
}

// x (n, k) from b (n, k) and bands u, l (rows of k - 1) and d (rows of k)
// at row strides su, sl, sd (0: one band for every row): tpr threads a row,
// RT / tpr rows a block, or one segment of a row a block over a cluster.
// Three buffers serve the four operands, so four blocks share an SM (64
// registers a thread): d, u and l are staged first; b, needed only from the
// elimination on, comes by cp.async into d's buffer once the diagonal is
// done, and x leaves through the same buffer.
template <bool CLUSTER>
__global__ void __launch_bounds__(RT, 4)
    per_row_kernel(const float* __restrict__ b, const float* __restrict__ u,
                   const float* __restrict__ d, const float* __restrict__ l,
                   float* __restrict__ x, long long n, int k, int tpr, int seg, long long su,
                   long long sd, long long sl) {
  extern __shared__ float rows_smem[];
  float* sdg = rows_smem;            // [ROW_BUF] the block's rows of d, then b, then x
  float* sup = sdg + ROW_BUF;        // [ROW_BUF] u
  float* slo = sup + ROW_BUF;        // [ROW_BUF] l
  float* scratch = slo + ROW_BUF;    // [RT / 32][SCAN_SLOT] the scans' warp totals
  float* slots = scratch + RT / 32 * SCAN_SLOT;  // [3][SCAN_SLOT] a cluster's exchanges
  float* sb = sdg;
  const RowPart p = row_part<CLUSTER>(n, k, tpr, seg);
  const int km1 = k - 1, j0 = p.j0, len = p.len;
  // Position g of the thread's row: b and d at staged(bi + g), u and l at
  // staged(ui + g).  A resident block holds its rows whole (b, d k apart; u,
  // l k - 1 apart); a cluster's block holds its segment, u and l from the
  // position before it on.
  const int bi = p.rb * len - p.seg0;
  const int ui = CLUSTER ? 1 - p.seg0 : p.rb * km1;
  const int g0 = p.seg0 + j0;

  // The block's range of each operand: nbd elements of b and d, nul of u
  // and l from position lo on (a cluster's block: from the one before its
  // segment).
  const int nbd = p.rows * len;
  const int lo = CLUSTER ? max(p.seg0 - 1, 0) : 0;
  const int nul = CLUSTER ? min(p.seg0 + len, km1) - lo : p.rows * km1;
  const int at = lo + (CLUSTER ? ui : 0);
  stage_band(sdg, 0, d, p.row0, sd, k, p.seg0, nbd);
  stage_band(sup, at, u, p.row0, su, km1, lo, nul);
  stage_band(slo, at, l, p.row0, sl, km1, lo, nul);
  __syncthreads();
#define IN(s) (p.live && j0 + (s) < len)

  // The eliminated diagonal's carry-in: the Moebius maps
  // [[d_g, -l_{g-1} u_{g-1}], [1, 0]] of the positions before the chunk,
  // applied to 1.
  Vec<4> mob = MoebiusOp::identity();
#pragma unroll
  for (int s = 0; s < RP; ++s) {
    const int g = g0 + s;
    if (IN(s)) {
      const float lu = g > 0 ? slo[staged(ui + g - 1)] * sup[staged(ui + g - 1)] : 0.f;
      mob = MoebiusOp::compose(mob, {{sdg[staged(bi + g)], -lu, 1.f, 0.f}});
    }
  }
  mob = full_scan<MoebiusOp, false, CLUSTER>(mob, tpr, scratch, slots);
  float prev_d = (mob.v[0] + mob.v[1]) / (mob.v[2] + mob.v[3]);

  // The diagonal in the chunk, nd_g = d_g - w_g u_{g-1} with w_g =
  // l_{g-1} / nd_{g-1} (nb holds each w until the carry-in is known).
  float nd[RP], nb[RP];
#pragma unroll
  for (int s = 0; s < RP; ++s) {
    const int g = g0 + s;
    nd[s] = 1.f;
    nb[s] = 0.f;
    if (IN(s)) {
      float w = 0.f, dg = sdg[staged(bi + g)];
      if (g > 0) {
        w = slo[staged(ui + g - 1)] / prev_d;
        dg -= w * sup[staged(ui + g - 1)];
      }
      prev_d = dg;
      nd[s] = dg;
      nb[s] = w;
    }
  }
  // d is read no more: b comes into its buffer.
  __syncthreads();
  const float* qb = b + p.row0 * k + p.seg0;
  for (int i = threadIdx.x; i < nbd; i += RT)
    __pipeline_memcpy_async(sb + staged(i), qb + i, sizeof(float));
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // The elimination's maps nb -> -w_g nb + b_g, then nb from its carry-in
  // (applied to nb_{-1} = 0).
  Vec<2> aff = AffineOp::identity();
#pragma unroll
  for (int s = 0; s < RP; ++s)
    if (IN(s)) aff = AffineOp::compose(aff, {{-nb[s], sb[staged(bi + g0 + s)]}});
  aff = full_scan<AffineOp, false, CLUSTER>(aff, tpr, scratch, slots + SCAN_SLOT);
  float carry = aff.v[1];
#pragma unroll
  for (int s = 0; s < RP; ++s) {
    if (IN(s)) {
      carry = sb[staged(bi + g0 + s)] - nb[s] * carry;
      nb[s] = carry;
    }
  }

  // Substitution, in reverse: x_g = r_g nb_g - c_g x_{g+1}, r_g = 1 / nd_g,
  // c_g = u_g r_g (0 at g = k - 1), from the carry-in x after the chunk
  // (applied to x_k = 0); nd holds r from here; x goes over b in sb, each
  // thread at its own positions.
  aff = AffineOp::identity();
#pragma unroll
  for (int s = RP - 1; s >= 0; --s) {
    const int g = g0 + s;
    if (IN(s)) {
      nd[s] = 1.f / nd[s];
      const float c = g < km1 ? sup[staged(ui + g)] * nd[s] : 0.f;
      aff = AffineOp::compose(aff, {{-c, nd[s] * nb[s]}});
    }
  }
  aff = full_scan<AffineOp, true, CLUSTER>(aff, tpr, scratch, slots + 2 * SCAN_SLOT);
  carry = aff.v[1];
#pragma unroll
  for (int s = RP - 1; s >= 0; --s) {
    const int g = g0 + s;
    if (IN(s)) {
      const float c = g < km1 ? sup[staged(ui + g)] * nd[s] : 0.f;
      carry = nd[s] * nb[s] - c * carry;
      sb[staged(bi + g)] = carry;
    }
  }
#undef IN
  __syncthreads();
  float* xb = x + p.row0 * k + p.seg0;
  for (int i = threadIdx.x; i < p.rows * len; i += RT) xb[i] = sb[staged(i)];
  if (CLUSTER) cluster_done();
}

}  // namespace

extern "C" {

const char* td_error_string(int code) {
  if (code == BAD_ARGUMENT) return "invalid argument";
  return cudaGetErrorString((cudaError_t)code);
}

// b (n, k) and x (n, k) contiguous; u, l rows of k - 1 and d rows of k at
// row strides su, sl, sd (0: one band for every row); nd: (k, n) scratch.
// The thomas_kernel route.
int td_solve(const float* b, const float* u, const float* d, const float* l,
             float* x, float* nd, long long n, int k, long long sb,
             long long su, long long sd, long long sl, void* stream) {
  if (n <= 0 || k <= 0 || !b || !d || !x || !nd ||
      (k > 1 && (!u || !l)) || (n + THREADS - 1) / THREADS > 0x7fffffffLL)
    return BAD_ARGUMENT;
  const long long blocks = (n + THREADS - 1) / THREADS;
  thomas_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      b, u, d, l, x, nd, n, k, sb, su, sd, sl);
  return (int)cudaGetLastError();
}

// The checks shared by the resident and cluster routes: tpr threads a row,
// a power of two with tpr * RP >= k, k <= RES_MAX (cs 1); or cs blocks a
// row of seg positions each (cluster_shape_ok, tpr = RT).  Returns the
// blocks of the launch, or -1.
static long long row_blocks(long long n, int k, int tpr, int cs, int seg) {
  if (n <= 0 || k <= 0) return -1;
  long long blocks;
  if (cs == 1) {
    if (k > RES_MAX || tpr < 1 || tpr > RT || (tpr & (tpr - 1)) || (long long)tpr * RP < k)
      return -1;
    blocks = (n + RT / tpr - 1) / (RT / tpr);
  } else {
    if (!cluster_shape_ok(k, cs, seg) || tpr != RT) return -1;
    blocks = n * cs;
  }
  return blocks > 0x7fffffffLL ? -1 : blocks;
}

// The shared-band route: b (n, k) and x (n, k) contiguous, one band each
// (u, l of k - 1, d of k); piv: (3, P) scratch, 16-byte aligned, P = tpr *
// RP for a resident row (cs 1), cs * seg over a cluster; the launch shape
// as row_blocks checks it (the wrapper's solve_plan).
int td_solve_shared(const float* b, const float* u, const float* d, const float* l,
                    float* x, float* piv, long long n, int k, int tpr, int cs, int seg,
                    void* stream) {
  const long long blocks = row_blocks(n, k, tpr, cs, seg);
  if (blocks < 0 || !b || !d || !x || !piv || (k > 1 && (!u || !l)) ||
      (reinterpret_cast<size_t>(piv) & 15))
    return BAD_ARGUMENT;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (cs == 1) {
    band_pivot_kernel<false><<<1, RT, 0, st>>>(u, d, l, piv, k, tpr, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    shared_band_kernel<false><<<(unsigned)blocks, RT, BAND_SMEM, st>>>(b, piv, x, n, k, tpr, 0);
    return (int)cudaGetLastError();
  }
  err = launch_clusters(band_pivot_kernel<true>, cs, cs, 0, st, u, d, l, piv, k, (int)RT, seg);
  if (err != cudaSuccess) return (int)err;
  err = launch_clusters(shared_band_kernel<true>, blocks, cs, BAND_CLUSTER_SMEM, st, b,
                        (const float*)piv, x, n, k, (int)RT, seg);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The per-row route: b (n, k) and x (n, k) contiguous; u, l rows of k - 1
// and d rows of k at row strides su, sl, sd (0: one band for every row);
// the launch shape as row_blocks checks it (the wrapper's solve_plan).
int td_solve_rows(const float* b, const float* u, const float* d, const float* l, float* x,
                  long long n, int k, int tpr, int cs, int seg, long long su, long long sd,
                  long long sl, void* stream) {
  const long long blocks = row_blocks(n, k, tpr, cs, seg);
  if (blocks < 0 || !b || !d || !x || (k > 1 && (!u || !l)) || su < 0 || sd < 0 || sl < 0)
    return BAD_ARGUMENT;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (cs == 1) {
    err = cudaFuncSetAttribute(per_row_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ROWS_SMEM);
    if (err != cudaSuccess) return (int)err;
    per_row_kernel<false><<<(unsigned)blocks, RT, ROWS_SMEM, st>>>(b, u, d, l, x, n, k, tpr,
                                                                    0, su, sd, sl);
    return (int)cudaGetLastError();
  }
  err = cudaFuncSetAttribute(per_row_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)ROWS_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = launch_clusters(per_row_kernel<true>, blocks, cs, ROWS_SMEM, st, b, u, d, l, x, n, k,
                        (int)RT, seg, su, sd, sl);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
