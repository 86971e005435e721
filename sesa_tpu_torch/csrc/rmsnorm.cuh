// Row normalisation passes. K2's RMSNorm (lucidrains form: l2-normalise with
// the norm clamped at 1e-12, then * sqrt(d) * gamma), with the bf16 rounding
// points of the TPU kernel (sesa_tpu/ops/ff.py:40-42):
//   xn = bf16(bf16(x * (sqrt(d) / max(|x|, 1e-12))) * gamma)
// (K1's RMSNorm, which divides by the norm, is in its norm pass beside the
// gates, attention.cu.)
// LayerNorm, shared by K2's conformer form, K4 and K5 (sesa_tpu/ops/ff.py:44-48,
// attention.py:594-599, convblock.py:77-82): f32 mean and biased variance,
// eps 1e-5, xn = bf16(bf16(bf16((x - mu) * rsqrt(var + eps)) * gamma) + beta).
// One warp per row, 16-byte loads and stores; the sums are f32.
//
// The TPU kernels normalise inside the projection kernel. Fused into this
// port's GEMM as a prologue, the normalisation ran once per 128-column tile
// of the output (13 to 16 times per row at the flagship widths) and held the
// projections to 63-90 TFLOP/s on the H100; as its own pass it reads x once
// and writes xn once (2 x 263 MB at the flagship shape).
#pragma once

#include "common.cuh"

namespace sesa {

__global__ void __launch_bounds__(256)
rms_norm_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                     bf16* __restrict__ xn, int rows, int d) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * d;
  float ss = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) { const float f = bf2f(e[i]); ss += f * f; }
  }
  const float sqrt_d = sqrtf((float)d), nrm = fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
  const float inv = sqrt_d / nrm;
  for (int c = lane * 8; c < d; c += 256) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    uint4 gv = *reinterpret_cast<const uint4*>(gamma + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    const bf16* ge = reinterpret_cast<const bf16*>(&gv);
    uint4 o;
    uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float y[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float f = bf2f(e[2 * i + j]);
        const float s = rbf(f * inv);
        y[j] = s * bf2f(ge[2 * i + j]);
      }
      op[i] = pack_bf16x2(y[0], y[1]);
    }
    *reinterpret_cast<uint4*>(xn + (size_t)row * d + c) = o;
  }
}

inline int launch_rms_norm(const bf16* x, const bf16* gamma, bf16* xn, int rows, int d,
                           cudaStream_t stream) {
  rms_norm_rows_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(x, gamma, xn, rows, d);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(256)
layer_norm_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                       const bf16* __restrict__ beta, bf16* __restrict__ xn, int rows, int d) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * d;
  float s = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += bf2f(e[i]);
  }
  const float mu = warp_sum(s) / (float)d;
  float ss = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) { const float f = bf2f(e[i]) - mu; ss += f * f; }
  }
  const float rstd = rsqrtf(warp_sum(ss) / (float)d + 1e-5f);
  for (int c = lane * 8; c < d; c += 256) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    uint4 gv = *reinterpret_cast<const uint4*>(gamma + c);
    uint4 bv = *reinterpret_cast<const uint4*>(beta + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    const bf16* ge = reinterpret_cast<const bf16*>(&gv);
    const bf16* be = reinterpret_cast<const bf16*>(&bv);
    uint4 o;
    uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float y[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int q = 2 * i + j;
        y[j] = rbf(rbf((bf2f(e[q]) - mu) * rstd) * bf2f(ge[q])) + bf2f(be[q]);
      }
      op[i] = pack_bf16x2(y[0], y[1]);
    }
    *reinterpret_cast<uint4*>(xn + (size_t)row * d + c) = o;
  }
}

inline int launch_layer_norm(const bf16* x, const bf16* gamma, const bf16* beta, bf16* xn,
                             int rows, int d, cudaStream_t stream) {
  layer_norm_rows_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(x, gamma, beta, xn, rows, d);
  return (int)cudaGetLastError();
}

}  // namespace sesa
