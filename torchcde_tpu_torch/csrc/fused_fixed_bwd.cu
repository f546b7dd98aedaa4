// The fixed-step solve's backward (K1): its float32 mode and the entries of
// both modes; the kernel, its plan and its launch are in fused_fixed_bwd.cuh,
// the bfloat16 mode is built by fused_fixed_bwd_bf16.cu.

#include "fused_fixed_bwd.cuh"

extern "C" {

// The bfloat16 mode's plan and launch (fused_fixed_bwd_bf16.cu).
int ffb_bf16_plan(int B, int H, int C, int W, long* out);
int ffb_bf16_launch(const void* ct, const float* zres, const float* z0t, const float* gz,
                    const float* w1t, const float* b1, const float* w2t, const float* b2,
                    const int* slot, void* dct, float* dz0, float* dw1p, float* db1p,
                    float* dw2p, float* db2p, float* scratch, int B, int n, int H, int C, int W,
                    int m, double dt, const void* tab, int blocks, void* stream);

// The backward launch, as ff_forward_plan reports the forward's; its blocks
// are the leading size of the weight partials.
int ff_backward_plan(int B, int H, int C, int W, int m, int n_stages, int mode, long* out) {
  if (!shapes_ok(B, H, C, W, m, n_stages, mode)) return BAD_ARGUMENT;
  if (mode == 1) return ffb_bf16_plan(B, H, C, W, out);
  LaunchPlan p;
  const int rc = backward_plan<float, false>(p, B, H, C, W);
  if (!rc) write_plan(p, out);
  return rc;
}

// mode 0: float32 ct and dct; mode 1: bfloat16 ct and dct, bfloat16
// operands in the stage products (the other pointers are float32 in both).
// blocks: as ff_backward_plan plans them; scratch: its scratch floats, or
// null.
int ff_backward(const void* ct, const float* zres, const float* z0t, const float* gz,
                const float* w1t, const float* b1, const float* w2t, const float* b2,
                const int* slot, void* dct, float* dz0, float* dw1p, float* db1p, float* dw2p,
                float* db2p, float* scratch, int B, int n, int H, int C, int W, int m,
                double dt, int n_stages, const double* alpha, const double* a, const double* c,
                int mode, int blocks, void* stream) {
  if (n < 1 || !shapes_ok(B, H, C, W, m, n_stages, mode)) return BAD_ARGUMENT;
  Tableau tab;
  const int rc = make_tableau(n_stages, alpha, a, c, dt, &tab);
  if (rc) return rc;
  if (mode == 1)
    return ffb_bf16_launch(ct, zres, z0t, gz, w1t, b1, w2t, b2, slot, dct, dz0, dw1p, db1p,
                           dw2p, db2p, scratch, B, n, H, C, W, m, dt, &tab, blocks, stream);
  return backward_mode<float, false>(ct, zres, z0t, gz, w1t, b1, w2t, b2, slot, dct, dz0, dw1p,
                                     db1p, dw2p, db2p, scratch, B, n, H, C, W, m, dt, tab,
                                     blocks, (cudaStream_t)stream);
}

}  // extern "C"
