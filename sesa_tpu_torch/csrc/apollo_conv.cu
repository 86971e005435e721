// K6: the fused Apollo conv block (ICB / ConvActNorm) on Hopper, as a chain of
// three hand-written kernels.
//
// Replaces: sesa_tpu/ops/convblock.py fused_apollo_conv (Pallas kernel
// _apollo_conv_kernel with the stencil _dw_conv_seq), which computes
//   x + W2 . SiLU(W1 . (RMSNorm(dwconv_k(x) + b_dw) * gamma) + b1) + b2
// over (b, n, d): a depthwise convolution of k (odd) taps along each
// sequence, zero-padded by (k - 1) / 2 at both ends, an RMSNorm over the
// channels (mean of squares + 1e-5) and a pointwise MLP of hidden width 4d.
//
// Bound on the H100: tensor-core operations. At Apollo's shape (tokens
// 608,320, d 256, hidden 1024, k 7) one call does 2 * T * 2 * d * 4d = 6.4e11
// FLOP of pointwise products plus 2 * T * k * d = 2.2e9 of taps, about
// 0.65 ms at 989 TFLOP/s, against 0.19 ms to read x and write the output at
// 3.35 TB/s.
//
// Design. One TPU program held a slab of whole sequences, the conv output
// and the 1024-wide hidden in VMEM. Here:
//   1. dw:   depthwise stencil + b_dw + RMSNorm in one pass. A block stages
//            64 rows of one sequence, all d channels, plus a halo of k - 1
//            rows (zero outside [0, n): the 320 sequences sit back to back in
//            memory and the halo must not read the neighbour). Each warp owns
//            8 consecutive rows: a lane slides the taps of its channel pairs
//            over them (f32 sums in tap order), rounds conv + b_dw to bf16
//            as the TPU kernel does, and keeps the row's sum of squares, so a
//            warp reduction gives the norm with no second pass over memory;
//            bf16(bf16(y * rsqrt(mean + eps)) * gamma) leaves in 16-byte
//            stores.
//   2. up:   W1 on gemm_ws.cuh (persistent, TMA producer warp, two ping-pong
//            consumer warpgroups; at K = d <= 512 the block's slice of W1
//            stays in shared memory), + b1, SiLU in f32 (silu_fast: the fast
//            divide, a few f32 ulps from an IEEE divide, far below the bf16
//            rounding that follows), bf16 hidden.
//   3. down: W2 on gemm_ws.cuh (K = 4d streams both operands), + b2, bf16,
//            + x residual in the epilogue.
// Both products take their persistent grids from the host
// (ops/ff.py ff_gemm_schedule).
// The normed activation and the hidden cross device memory once each way
// (2 x 0.31 GB and 2 x 1.25 GB at Apollo's shape, ~0.93 ms of traffic, more
// than the products' time); a persistent kernel that keeps the hidden tile on
// chip between the two GEMMs is later work.
#include "gemm_ws.cuh"

namespace sesa {

constexpr int AC_ROWS = 64;  // sequence rows per block: 8 warps x 8 rows
constexpr int AC_RPT = 8;    // consecutive rows per warp

// KMAX: taps held in registers (taps >= k are zero); 8 or 32
template <int KMAX>
__global__ void __launch_bounds__(256)
dwconv_rmsnorm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ taps,
                      const bf16* __restrict__ dwb, const bf16* __restrict__ gamma,
                      bf16* __restrict__ xn, int n, int d, int k, int tiles, float eps) {
  extern __shared__ __align__(16) unsigned char ac_smem[];
  constexpr int SROWS = AC_ROWS + KMAX - 1;
  bf16* s_in = reinterpret_cast<bf16*>(ac_smem);  // [SROWS][d] staged input
  bf16* s_y = s_in + (size_t)SROWS * d;            // [AC_ROWS][d] conv + b_dw, bf16

  const int i0 = (blockIdx.x % tiles) * AC_ROWS, pad_l = (k - 1) / 2;
  const size_t seq0 = (size_t)(blockIdx.x / tiles) * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // staged row r is sequence row i0 - pad_l + r; zero outside [0, n)
  const int cpr = d / 8, rows_needed = AC_ROWS + k - 1;
  for (int c = threadIdx.x; c < rows_needed * cpr; c += 256) {
    const int r = c / cpr, c8 = (c % cpr) * 8, pos = i0 - pad_l + r;
    const bool in = pos >= 0 && pos < n;
    cp_async16_zfill(s_in + (size_t)r * d + c8, x + (seq0 + (in ? pos : 0)) * d + c8,
                     in ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // out[i] = sum_t taps[t] * x[i + t - pad_l] = sum_t taps[t] * s_in[i - i0 + t]
  const int rbase = warp * AC_RPT;
  float ss[AC_RPT];
#pragma unroll
  for (int r = 0; r < AC_RPT; ++r) ss[r] = 0.f;
  for (int cp = lane; cp < d / 2; cp += 32) {
    float2 tp[KMAX];
#pragma unroll
    for (int t = 0; t < KMAX; ++t)
      tp[t] = t < k ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                          taps + (size_t)t * d + 2 * cp))
                    : make_float2(0.f, 0.f);
    float2 acc[AC_RPT];
#pragma unroll
    for (int r = 0; r < AC_RPT; ++r) acc[r] = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < AC_RPT + KMAX - 1; ++j) {
      if (j >= AC_RPT + k - 1) break;  // rows beyond the halo were not staged
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(s_in + (size_t)(rbase + j) * d + 2 * cp));
#pragma unroll
      for (int r = 0; r < AC_RPT; ++r) {
        const int t = j - r;
        if (t >= 0 && t < KMAX) {
          acc[r].x = fmaf(tp[t].x, v.x, acc[r].x);
          acc[r].y = fmaf(tp[t].y, v.y, acc[r].y);
        }
      }
    }
    const float2 bias =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dwb + 2 * cp));
#pragma unroll
    for (int r = 0; r < AC_RPT; ++r) {
      const float y0 = rbf(acc[r].x + bias.x), y1 = rbf(acc[r].y + bias.y);
      ss[r] += y0 * y0 + y1 * y1;
      *reinterpret_cast<uint32_t*>(s_y + (size_t)(rbase + r) * d + 2 * cp) = pack_bf16x2(y0, y1);
    }
  }
  __syncwarp();

  // RMSNorm of this warp's rows: bf16(bf16(y * rsqrt(mean(y^2) + eps)) * gamma)
#pragma unroll
  for (int r = 0; r < AC_RPT; ++r) {
    const int i = i0 + rbase + r;
    const float inv = rsqrtf(warp_sum(ss[r]) / (float)d + eps);
    if (i >= n) continue;
    for (int c = lane * 8; c < d; c += 256) {
      const uint4 v = *reinterpret_cast<const uint4*>(s_y + (size_t)(rbase + r) * d + c);
      const uint4 gv = *reinterpret_cast<const uint4*>(gamma + c);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
      const bf16* ge = reinterpret_cast<const bf16*>(&gv);
      uint4 o;
      uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        op[q] = pack_bf16x2(rbf(bf2f(e[2 * q]) * inv) * bf2f(ge[2 * q]),
                            rbf(bf2f(e[2 * q + 1]) * inv) * bf2f(ge[2 * q + 1]));
      *reinterpret_cast<uint4*>(xn + (seq0 + i) * d + c) = o;
    }
  }
}

template <int KMAX>
static int launch_dwconv_rmsnorm(const bf16* x, const bf16* taps, const bf16* dwb,
                                 const bf16* gamma, bf16* xn, int batch, int n, int d, int k,
                                 float eps, cudaStream_t s) {
  const int smem = (AC_ROWS + KMAX - 1 + AC_ROWS) * d * 2;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(dwconv_rmsnorm_kernel<KMAX>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int tiles = (n + AC_ROWS - 1) / AC_ROWS;
  dwconv_rmsnorm_kernel<KMAX><<<(unsigned)(tiles * batch), 256, smem, s>>>(
      x, taps, dwb, gamma, xn, n, d, k, tiles, eps);
  return (int)cudaGetLastError();
}

}  // namespace sesa

using namespace sesa;

extern "C" {

// xn = bf16(bf16(y * rsqrt(mean(y^2) + eps)) * gamma) with
// y = bf16(dwconv_k(x) + dwb) per sequence of n rows; taps (k, d), k odd <= 31
int sesa_apollo_dw(const void* x, const void* taps, const void* dwb, const void* gamma,
                   void* xn, int batch, int n, int d, int k, float eps, void* stream) {
  if (k < 1 || k > 31 || k % 2 == 0 || d % 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 8)
    return launch_dwconv_rmsnorm<8>((const bf16*)x, (const bf16*)taps, (const bf16*)dwb,
                                    (const bf16*)gamma, (bf16*)xn, batch, n, d, k, eps, s);
  return launch_dwconv_rmsnorm<32>((const bf16*)x, (const bf16*)taps, (const bf16*)dwb,
                                   (const bf16*)gamma, (bf16*)xn, batch, n, d, k, eps, s);
}

// h = bf16(silu(xn . w1^T + b1)); grid: blocks of the persistent product
int sesa_apollo_up(const void* xn, const void* w1, const void* b1, void* h, int tokens,
                   int dim, int hidden, int grid, void* stream) {
  WsArgs p = {};
  p.bias = (const bf16*)b1; p.C = (bf16*)h;
  p.M = tokens; p.N = hidden; p.K = dim; p.out_scale = 1.0f;
  return launch_gemm_ws<WS_BIAS_SILU>((const bf16*)xn, (const bf16*)w1, p, grid,
                                      (cudaStream_t)stream);
}

// out = bf16(bf16(h . w2^T + b2) + x); grid: blocks of the persistent product
int sesa_apollo_down(const void* h, const void* w2, const void* b2, const void* x, void* out,
                     int tokens, int dim, int hidden, int grid, void* stream) {
  WsArgs p = {};
  p.bias = (const bf16*)b2; p.resid = (const bf16*)x; p.C = (bf16*)out;
  p.M = tokens; p.N = dim; p.K = hidden; p.out_scale = 1.0f;
  return launch_gemm_ws<WS_RESID>((const bf16*)h, (const bf16*)w2, p, grid,
                                  (cudaStream_t)stream);
}

}  // extern "C"
