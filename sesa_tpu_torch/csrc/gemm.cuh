// One templated tensor-core GEMM with a fused epilogue:
//   C[M, N] = epilogue( A[M, K] . B[N, K]^T )
// B keeps the torch (out_features, in_features) layout, so both operands are
// K-contiguous. The projections of K4 and K5 are its instances (K1's, K2's
// and K6's run on the persistent gemm_ws.cuh; moving these onto it is later
// work).
//
// Epilogues
//   EPI_RESID     y = (acc [+ bias1]) [* out_scale]; C1 = bf16(bf16(y) [+ resid]).
//   EPI_GLU       B rows come interleaved (a0, g0, a1, g1, ...), so each
//                 thread's adjacent column pair is one (a, g):
//                 C1[:, c] = bf16((a + bias1[2c]) * sigmoid(g + bias1[2c+1])),
//                 C1 is (M, N / 2).
//
// Tiling: 128 x 128 x 64 block tiles, two warpgroups of 4 warps, each
// computing 64 x 128 of C with wgmma.m64n128k16 from shared memory. All 256
// threads fill a three-stage ring with cp.async, writing the 128-byte
// swizzle that the wgmma descriptors name (97 KB, two blocks per SM); TMA
// and a producer warp are later work. Ragged M and N are handled by clamping
// the rows that are loaded and masking the stores; K must be a multiple of
// 64, and N a multiple of 8 (checked by the host).
#pragma once

#include "common.cuh"
#include "rmsnorm.cuh"

namespace sesa {

enum Epilogue { EPI_RESID = 0, EPI_GLU = 1 };

struct GemmArgs {
  const bf16* A;      // (M, K)
  const bf16* B1;     // (N, K)
  const bf16* bias1;  // (N,) or null
  const bf16* resid;  // (M, N) or null, EPI_RESID only
  bf16* C1;           // (M, ldc1)
  int M, N, K, ldc1;
  float out_scale;
};

constexpr int W_BM = 128, W_BN = 128, W_BK = 64, W_STAGES = 3, W_THREADS = 256;
constexpr int W_STAGE_BYTES = (W_BM + W_BN) * W_BK * 2;
constexpr int W_SMEM_BYTES = W_STAGES * W_STAGE_BYTES + 1024;  // + alignment slack

template <int EPI>
__global__ void __launch_bounds__(W_THREADS, 2)
gemm_nt_kernel(const GemmArgs p) {
  extern __shared__ unsigned char g_smem_raw[];
  // swizzled tiles must start on 1024-byte boundaries
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(g_smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, wq = warp & 3;
  const int m0 = blockIdx.y * W_BM, n0 = blockIdx.x * W_BN;
  const int K = p.K;

  // 16-byte chunk ch of tile row r goes to chunk ch ^ (r % 8) of its 128-byte row
  auto load_stage = [&](int kt, int s) {
    unsigned char* sA = smem + s * W_STAGE_BYTES;
    unsigned char* sB = sA + W_BM * W_BK * 2;
    const int k0 = kt * W_BK;
#pragma unroll
    for (int c = tid; c < W_BM * 8; c += W_THREADS) {
      const int r = c >> 3, ch = c & 7, off = r * 128 + ((ch ^ (r & 7)) << 4);
      const int arow = min(m0 + r, p.M - 1);
      cp_async16(sA + off, p.A + (size_t)arow * K + k0 + ch * 8);
      const int brow = min(n0 + r, p.N - 1);
      cp_async16(sB + off, p.B1 + (size_t)brow * K + k0 + ch * 8);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  const int KT = K / W_BK;
#pragma unroll
  for (int s = 0; s < W_STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % W_STAGES;
    cp_async_wait<W_STAGES - 2>();
    fence_proxy_async_shared();
    __syncthreads();
    // refill the stage whose wgmmas completed in the previous iteration
    if (kt + W_STAGES - 1 < KT) load_stage(kt + W_STAGES - 1, (kt + W_STAGES - 1) % W_STAGES);
    cp_async_commit();
    const unsigned char* sA = smem + s * W_STAGE_BYTES + wg * 64 * 128;
    const unsigned char* sB = smem + s * W_STAGE_BYTES + W_BM * W_BK * 2;
    const uint64_t da = sw128_desc(sA), db = sw128_desc(sB);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W_BK / 16; ++kk)  // +32 bytes per k16 step: +2 in the descriptor
      wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // the stage ring is reused below as the output tile

  // epilogue, in two steps: (1) each thread finishes its pairs of adjacent
  // columns (2t, 2t+1) into a bf16 tile in shared memory; (2) the tile
  // leaves in coalesced 16-byte row chunks, where EPI_RESID adds the residual
  constexpr int TLD = W_BN + 8;
  bf16* tile = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wg * 64 + wq * 16 + g + half * 8;
#pragma unroll
    for (int j = 0; j < W_BN / 8; ++j) {
      const int c = j * 8 + 2 * t, col = n0 + c;
      float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if (col >= p.N) continue;
      if (EPI == EPI_GLU) {  // one output column per (a, g) pair
        const float a = v0 + bf2f(p.bias1[col]), gt = v1 + bf2f(p.bias1[col + 1]);
        tile[r * TLD + (c >> 1)] = f2bf(a * sigmoidf_(gt));
        continue;
      } else {
        if (p.bias1) { v0 += bf2f(p.bias1[col]); v1 += bf2f(p.bias1[col + 1]); }
        if (p.out_scale != 1.0f) { v0 *= p.out_scale; v1 *= p.out_scale; }
      }
      *reinterpret_cast<uint32_t*>(tile + r * TLD + c) = pack_bf16x2(v0, v1);
    }
  }
  __syncthreads();
  // bf16 columns of this tile: those below N / 2 (GLU) or N; all multiples of 8
  constexpr int OUT_BN = EPI == EPI_GLU ? W_BN / 2 : W_BN;
  const int n0o = EPI == EPI_GLU ? n0 / 2 : n0;
  const int ncols = min(OUT_BN, (EPI == EPI_GLU ? p.N / 2 : p.N) - n0o);
  for (int c = tid; c < W_BM * (OUT_BN / 8); c += W_THREADS) {
    const int r = c / (OUT_BN / 8), c8 = (c % (OUT_BN / 8)) * 8, row = m0 + r;
    if (row >= p.M || c8 >= ncols) continue;
    uint4 v = *reinterpret_cast<const uint4*>(tile + r * TLD + c8);
    // bf16(y) + x, rounded: the TPU kernels' residual add
    if (EPI == EPI_RESID && p.resid != nullptr) {
      const uint4 x = *reinterpret_cast<const uint4*>(p.resid + (size_t)row * p.N + n0 + c8);
      uint32_t* vp = reinterpret_cast<uint32_t*>(&v);
      const uint32_t* xp = reinterpret_cast<const uint32_t*>(&x);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vp + i));
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xp + i));
        vp[i] = pack_bf16x2(a.x + b.x, a.y + b.y);
      }
    }
    *reinterpret_cast<uint4*>(p.C1 + (size_t)row * p.ldc1 + n0o + c8) = v;
  }
}

template <int EPI>
inline int launch_gemm(const GemmArgs& p, cudaStream_t stream) {
  cudaFuncSetAttribute(gemm_nt_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       W_SMEM_BYTES);
  dim3 grid((p.N + W_BN - 1) / W_BN, (p.M + W_BM - 1) / W_BM);
  gemm_nt_kernel<EPI><<<grid, W_THREADS, W_SMEM_BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace sesa
