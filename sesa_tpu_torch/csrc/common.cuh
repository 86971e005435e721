// Shared device helpers for the hand-written Hopper kernels of sesa_tpu_torch.
//
// The projections (gemm.cuh) use wgmma from shared memory; the attention
// core uses mma.sync.m16n8k16 (bf16 operands, f32 sums), whose fragments it
// can hand from one product to the next in registers. Fragment layouts
// follow the PTX ISA for m16n8k16 with groupID = lane / 4 and tig = lane % 4:
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

// D[64 x 128] += A[64 x 16] . B[128 x 16]^T, both operands K-major in shared
// memory (128-byte swizzle descriptors), f32 accumulators in the m64nNk16
// layout: d[4j + e] is row 16 * warp + g (+8 for e >= 2), column 8j + 2t (+1
// for odd e), the mma.sync C layout per 8-column slice
__device__ __forceinline__ void wgmma_m64n128k16(float d[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// shared-memory matrix descriptor of a K-major tile whose 128-byte rows are
// stored with the 128-byte swizzle (16-byte chunk c of row r at chunk
// c ^ (r % 8)); groups of 8 rows are 1024 bytes apart, the tile is
// 1024-byte aligned
__device__ __forceinline__ uint64_t sw128_desc(const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads across the async wgmma
__device__ __forceinline__ void fence_regs(float d[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// make this thread's completed cp.async writes visible to the async proxy
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
