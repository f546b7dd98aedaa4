// The fixed-step solve's backward (K1) in its bfloat16 mode (fused_fixed_bwd.cuh),
// for fused_fixed_bwd.cu's entries: a source of its own, so that nvcc builds
// the two modes' kernels in parallel.

#include "fused_fixed_bwd.cuh"

extern "C" {

int ffb_bf16_plan(int B, int H, int C, int W, long* out) {
  LaunchPlan p;
  const int rc = backward_plan<__nv_bfloat16, true>(p, B, H, C, W);
  if (!rc) write_plan(p, out);
  return rc;
}

int ffb_bf16_launch(const void* ct, const float* zres, const float* z0t, const float* gz,
                    const float* w1t, const float* b1, const float* w2t, const float* b2,
                    const int* slot, void* dct, float* dz0, float* dw1p, float* db1p,
                    float* dw2p, float* db2p, float* scratch, int B, int n, int H, int C, int W,
                    int m, double dt, const void* tab, int blocks, void* stream) {
  return backward_mode<__nv_bfloat16, true>(ct, zres, z0t, gz, w1t, b1, w2t, b2, slot, dct, dz0,
                                            dw1p, db1p, dw2p, db2p, scratch, B, n, H, C, W, m,
                                            dt, *static_cast<const Tableau*>(tab), blocks,
                                            (cudaStream_t)stream);
}

}  // extern "C"
