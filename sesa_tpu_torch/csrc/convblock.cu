// K5: the fused conformer conv module on Hopper, as a chain of hand-written
// kernels.
//
// Replaces: sesa_tpu/ops/convblock.py fused_conformer_conv (Pallas kernel
// _conformer_conv_kernel), which computes
//   x + W2 . swish(BN_eval(dwconv_k(GLU(W1 . xn + b1)))) + b2
// with xn = LayerNorm(x) * gamma + beta, GLU over channels (a * sigmoid(g)),
// a depthwise convolution of k taps along each sequence, and the eval
// BatchNorm folded with the depthwise bias into a per-channel scale and
// shift (rounded to bf16, convblock.py:126-133).
//
// Bound on the H100: tensor-core operations. At the mel-band conformer shape
// (tokens 248,400, d 384, e 768, k 31) one call does 2 * T * (d * 2e + e * d)
// = 4.4e11 FLOP of pointwise products plus 2 * T * k * e = 1.2e10 of the
// depthwise taps (CUDA cores), about 0.46 ms at 989 TFLOP/s, against
// ~0.11 ms to read x and write the output at 3.35 TB/s.
//
// Design. One TPU program held a slab of whole sequences and the (rows, e)
// GLU and conv activations in VMEM. Here:
//   1. up:   LayerNorm row pass (rmsnorm.cuh) -> GEMM against W1, whose rows
//            the wrapper interleaves (a0, g0, a1, g1, ...) so that each
//            thread's column pair is one (a, g): + b1, GLU in f32, bf16
//            store of the (T, e) GLU output (convblock.py:93).
//   2. dw:   the depthwise stencil. A block stages 64 rows of one sequence
//            and 64 channels, plus a halo of k - 1 rows, in shared memory
//            (zero outside [0, n)), with the lucidrains padding
//            (k / 2 before, k / 2 - (k + 1) % 2 after: _conv_apply,
//            conformer_core.py:143, also right for even k). Each thread
//            keeps a channel pair's taps in registers and slides them over
//            8 consecutive rows (39 shared loads for 8 x 31 taps); f32 sums,
//            * scale + shift, swish in f32, bf16 store.
//   3. down: GEMM with W2, + b2, bf16, + x residual in the epilogue.
// The GLU and conv activations cross device memory once each way (4 x 0.38 GB
// at the main path's shape, ~0.46 ms of traffic); keeping them on chip needs
// a persistent kernel with the stencil between the two GEMMs, later work.
#include "gemm.cuh"

namespace sesa {

constexpr int DW_ROWS = 64;  // sequence rows per block
constexpr int DW_CH = 64;    // channels per block: 32 pairs
constexpr int DW_KMAX = 32;  // taps held in registers (taps >= k are zero)
constexpr int DW_RPT = 8;    // consecutive rows per thread

__global__ void __launch_bounds__(256)
dwconv_bn_swish_kernel(const bf16* __restrict__ hin, const bf16* __restrict__ taps,
                       const bf16* __restrict__ scale, const bf16* __restrict__ shift,
                       bf16* __restrict__ y, int n, int e, int k, int pad_l) {
  __shared__ float2 s[DW_ROWS + DW_KMAX - 1][DW_CH / 2];
  const int i0 = blockIdx.x * DW_ROWS, c0 = blockIdx.y * DW_CH;
  const size_t seq0 = (size_t)blockIdx.z * n;
  const int cp = threadIdx.x & 31, rg = threadIdx.x >> 5;

  // staged row r is sequence row i0 - pad_l + r; zero outside [0, n)
  for (int idx = threadIdx.x; idx < (DW_ROWS + DW_KMAX - 1) * (DW_CH / 2); idx += 256) {
    const int r = idx / (DW_CH / 2), c = idx % (DW_CH / 2), pos = i0 - pad_l + r;
    float2 v = make_float2(0.f, 0.f);
    if (pos >= 0 && pos < n)
      v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(hin + (seq0 + pos) * e + c0 + 2 * c));
    s[r][c] = v;
  }
  float2 tp[DW_KMAX];
#pragma unroll
  for (int t = 0; t < DW_KMAX; ++t)
    tp[t] = t < k ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                        taps + (size_t)t * e + c0 + 2 * cp))
                  : make_float2(0.f, 0.f);
  __syncthreads();

  // out[i] = sum_t taps[t] * h[i + t - pad_l] = sum_t taps[t] * s[i - i0 + t],
  // summed in tap order as the TPU kernel
  const int rbase = rg * DW_RPT;
  float2 acc[DW_RPT];
#pragma unroll
  for (int r = 0; r < DW_RPT; ++r) acc[r] = make_float2(0.f, 0.f);
#pragma unroll
  for (int j = 0; j < DW_RPT + DW_KMAX - 1; ++j) {
    const float2 v = s[rbase + j][cp];
#pragma unroll
    for (int r = 0; r < DW_RPT; ++r) {
      const int t = j - r;
      if (t >= 0 && t < DW_KMAX) {
        acc[r].x = fmaf(tp[t].x, v.x, acc[r].x);
        acc[r].y = fmaf(tp[t].y, v.y, acc[r].y);
      }
    }
  }

  const float2 sc =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(scale + c0 + 2 * cp));
  const float2 sh =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(shift + c0 + 2 * cp));
#pragma unroll
  for (int r = 0; r < DW_RPT; ++r) {
    const int i = i0 + rbase + r;
    if (i >= n) continue;
    const float v0 = acc[r].x * sc.x + sh.x, v1 = acc[r].y * sc.y + sh.y;
    *reinterpret_cast<uint32_t*>(y + (seq0 + i) * e + c0 + 2 * cp) =
        pack_bf16x2(v0 * sigmoidf_(v0), v1 * sigmoidf_(v1));
  }
}

}  // namespace sesa

using namespace sesa;

extern "C" {

// glu = bf16(GLU(layer_norm(x) * gamma + beta) . w1i^T + b1i)), with w1i and
// b1i interleaved (a0, g0, a1, g1, ...); xn is (tokens, dim) scratch, glu is
// (tokens, e2 / 2)
int sesa_conv_up(const void* x, const void* gamma, const void* beta, void* xn, const void* w1i,
                 const void* b1i, void* glu, int tokens, int dim, int e2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = launch_layer_norm((const bf16*)x, (const bf16*)gamma, (const bf16*)beta,
                                   (bf16*)xn, tokens, dim, s);
  if (rc != 0) return rc;
  GemmArgs p = {};
  p.A = (const bf16*)xn; p.B1 = (const bf16*)w1i; p.bias1 = (const bf16*)b1i;
  p.C1 = (bf16*)glu;
  p.M = tokens; p.N = e2; p.K = dim; p.n1 = e2; p.ldc1 = e2 / 2;
  p.out_scale = 1.0f;
  return launch_gemm<EPI_GLU>(p, s);
}

// y = bf16(swish(dwconv(glu) * scale + shift)) per sequence of n rows;
// taps (k, e), k <= 32
int sesa_conv_dw(const void* glu, const void* taps, const void* scale, const void* shift,
                 void* y, int batch, int n, int e, int k, void* stream) {
  if (k < 1 || k > DW_KMAX || e % DW_CH) return (int)cudaErrorInvalidValue;
  dim3 grid((n + DW_ROWS - 1) / DW_ROWS, e / DW_CH, batch);
  dwconv_bn_swish_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)glu, (const bf16*)taps, (const bf16*)scale, (const bf16*)shift, (bf16*)y,
      n, e, k, k / 2);
  return (int)cudaGetLastError();
}

// out = bf16(bf16(y . w2^T + b2) + x)
int sesa_conv_down(const void* y, const void* w2, const void* b2, const void* x, void* out,
                   int tokens, int dim, int e, void* stream) {
  GemmArgs p = {};
  p.A = (const bf16*)y; p.B1 = (const bf16*)w2; p.bias1 = (const bf16*)b2;
  p.resid = (const bf16*)x; p.C1 = (bf16*)out;
  p.M = tokens; p.N = dim; p.K = e; p.n1 = dim; p.ldc1 = dim;
  p.out_scale = 1.0f;
  return launch_gemm<EPI_RESID>(p, (cudaStream_t)stream);
}

}  // extern "C"
