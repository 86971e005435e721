// K2: the fused feed-forward on Hopper, as a chain of two hand-written
// kernels.
//
// Replaces: sesa_tpu/ops/ff.py fused_ff_residual (Pallas kernel _ff_kernel),
// which computes x + s * (W2 . act(W1 . norm(x) + b1) + b2) over (tokens, d),
// in two forms:
//   form 0 (roformer):  norm RMSNorm * gamma, act tanh-GELU, s = 1;
//   form 1 (conformer): norm LayerNorm * gamma + beta, act SiLU, s = 0.5.
//
// Bound on the H100: tensor-core operations. One call does 4 * T * d * 4d
// FLOP: at the flagship roformer shape (tokens 256,680, d 512, hidden 2048)
// 1.08e12, about 1.09 ms at the 989 TFLOP/s bf16 peak, against ~0.16 ms to
// read x and write the output at 3.35 TB/s; at the mel-band conformer shape
// (248,400 x 384 -> 1536) 5.9e11, about 0.59 ms.
//
// Design: the TPU kernel kept the (tile, 4d) hidden activation in VMEM. Here
//   1. up:   norm row pass (f32 sums, bf16 rounding as ff.py:40-48,
//            rmsnorm.cuh) -> W1 -> + b1 -> tanh-GELU or SiLU in f32 -> bf16
//            store of h (ff.py:55-57);
//   2. down: W2 -> + b2 -> * s -> bf16 -> + x residual (ff.py:71).
// The hidden activation crosses device memory once each way (2 x 1.05 GB at
// the flagship shape, ~0.63 ms of traffic at 3.35 TB/s, overlapped with the
// products); keeping it on chip needs a persistent fused kernel, later work.
#include "gemm.cuh"

using namespace sesa;

extern "C" {

// h = bf16(act(norm(x) . w1^T + b1)); xn is (tokens, dim) scratch; beta is
// read by form 1 only
int sesa_ff_up(const void* x, const void* gamma, const void* beta, void* xn, const void* w1,
               const void* b1, void* h, int tokens, int dim, int hidden, int form,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (form == 0) {
    rc = launch_rms_norm<RMS_FF>((const bf16*)x, (const bf16*)gamma, (bf16*)xn, tokens, dim, s);
  } else if (form == 1) {
    rc = launch_layer_norm((const bf16*)x, (const bf16*)gamma, (const bf16*)beta, (bf16*)xn,
                           tokens, dim, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  GemmArgs p = {};
  p.A = (const bf16*)xn; p.B1 = (const bf16*)w1;
  p.bias1 = (const bf16*)b1; p.C1 = (bf16*)h;
  p.M = tokens; p.N = hidden; p.K = dim; p.n1 = hidden; p.ldc1 = hidden;
  p.out_scale = 1.0f;
  return form == 0 ? launch_gemm<EPI_BIAS_GELU>(p, s) : launch_gemm<EPI_BIAS_SILU>(p, s);
}

// out = bf16(bf16((h . w2^T + b2) * out_scale) + x)
int sesa_ff_down(const void* h, const void* w2, const void* b2, const void* x,
                 void* out, int tokens, int dim, int hidden, float out_scale,
                 void* stream) {
  GemmArgs p = {};
  p.A = (const bf16*)h; p.B1 = (const bf16*)w2; p.bias1 = (const bf16*)b2;
  p.resid = (const bf16*)x; p.C1 = (bf16*)out;
  p.M = tokens; p.N = dim; p.K = hidden; p.n1 = dim; p.ldc1 = dim;
  p.out_scale = out_scale;
  return launch_gemm<EPI_RESID>(p, (cudaStream_t)stream);
}

}  // extern "C"
