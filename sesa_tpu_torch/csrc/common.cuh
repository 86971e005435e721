// Shared device helpers for the hand-written Hopper kernels of sesa_tpu_torch.
//
// The mma.sync cores (flash_core.cuh, K4's short-sequence core, K7, K8) use
// mma.sync.m16n8k16 (bf16 operands, f32 sums), whose fragments they can hand
// from one product to the next in registers; the wgmma kernels' helpers are
// in hopper.cuh. Fragment layouts follow the PTX ISA for m16n8k16 with
// groupID = lane / 4 and tig = lane % 4:
//   A (16x16, row):  a0 (g, 2t..2t+1)   a1 (g+8, 2t..)   a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16x8,  col):  b0 (k 2t..2t+1, n g)   b1 (k 2t+8..2t+9, n g)
//   C (16x8):        c0,c1 (g, 2t..2t+1)    c2,c3 (g+8, 2t..2t+1)
// Shared-memory tiles keep rows with a stride of (width + 8) bf16, so the
// eight 16-byte rows an ldmatrix phase reads fall in distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sesa {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }
// round an f32 value to the nearest bf16 and back (a bf16 rounding point)
__device__ __forceinline__ float rbf(float v) { return bf2f(f2bf(v)); }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// 16-byte async copy; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int src_bytes) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [pos0, pos0 + ROWS) of one head's q, k or v in shared memory
// (the attention cores of K1 and K4); rows at or beyond n repeat row n - 1
// (masked keys, unwritten queries).
template <int DH, int ROWS, int THREADS>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* qkv, int row_stride,
                                           int col0, int seq0, int pos0, int n) {
  constexpr int CPR = DH / 8, LD = DH + 8;  // 16-byte chunks per row
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
    const int r = c / CPR, d0 = (c % CPR) * 8, pos = min(pos0 + r, n - 1);
    cp_async16(dst + r * LD + d0, qkv + (size_t)(seq0 + pos) * row_stride + col0 + d0);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// tanh-approximate GELU, the form jax.nn.gelu(approximate=True) computes;
// tanh(u) = 1 - 2 / (exp(2u) + 1) with the fast exp and divide (a few f32
// ulps, far below the bf16 rounding that follows) instead of tanhf, whose
// cost bounded the W1 epilogue
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float u = k0 * (x + 0.044715f * x * x * x);
  const float th = 1.0f - __fdividef(2.0f, __expf(2.0f * u) + 1.0f);
  return 0.5f * x * (1.0f + th);
}

}  // namespace sesa
