// The flash-attention loop of K1's core for sequences of at most 64
// (attention.cu attn_core_kernel, the freq leg): softmax(q . k^T * scale) . v
// for one (sequence, head, BQ-query tile), left unnormalised in registers
// for the caller's epilogue. Longer sequences (K1's time leg, K3) run the
// persistent Hopper core flash_wgmma.cuh.
//
// K/V tiles of 64 keys are double-buffered through cp.async, fragments come
// by ldmatrix (V transposed by ldmatrix.trans), the two products are
// mma.sync m16n8k16 with the online f32 softmax between them, keys >= n are
// masked to -inf. The scores never leave registers. The probabilities are
// rounded to bf16 before the row sum is known (unnormalised), which moves a
// result by about one bf16 ulp against a softmax normalised first.
#pragma once

#include "common.cuh"

namespace sesa {

constexpr int FC_BK = 64;  // keys per tile; 16 query rows per warp

// dynamic shared memory of a block: the Q tile, then K buffers 0, 1 and V
// buffers 0, 1
template <int DH, int BQ>
constexpr int flash_core_smem_bytes() { return (BQ + 4 * FC_BK) * (DH + 8) * 2; }

// One block of BQ * 2 threads (BQ / 16 warps). qg, kg, vg point at row 0 of
// this sequence's head with row strides q_ld, k_ld, v_ld in elements (unit
// stride along DH, 16-byte aligned rows); q0 is the block's first query row;
// scale_log2 = scale * log2(e). On return thread (warp, g = lane / 4,
// t = lane % 4) holds for query rows q0 + 16 * warp + g + 8 * r, r = 0, 1,
// the unnormalised output columns 8 * i + 2 * t (+1) in o[i][2 * r (+1)] and
// the softmax denominator in l_run[r].
template <int DH, int BQ>
__device__ __forceinline__ void flash_core(bf16* smem, const bf16* __restrict__ qg,
                                           const bf16* __restrict__ kg,
                                           const bf16* __restrict__ vg, int q_ld, int k_ld,
                                           int v_ld, int q0, int n, float scale_log2,
                                           float (&o)[DH / 8][4], float (&l_run)[2]) {
  constexpr int LD = DH + 8, THREADS = BQ * 2;
  bf16* sQ = smem;
  auto sK = [&](int b) { return sQ + (BQ + b * FC_BK) * LD; };
  auto sV = [&](int b) { return sQ + (BQ + (2 + b) * FC_BK) * LD; };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  // ldmatrix.x4 lane addressing (see gemm.cuh)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;

  stage_tile<DH, BQ, THREADS>(sQ, qg, q_ld, 0, 0, q0, n);
  stage_tile<DH, FC_BK, THREADS>(sK(0), kg, k_ld, 0, 0, 0, n);
  stage_tile<DH, FC_BK, THREADS>(sV(0), vg, v_ld, 0, 0, 0, n);
  cp_async_commit();

  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  l_run[0] = l_run[1] = 0.f;

  const int n_tiles = (n + FC_BK - 1) / FC_BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      stage_tile<DH, FC_BK, THREADS>(sK(buf ^ 1), kg, k_ld, 0, 0, (kt + 1) * FC_BK, n);
      stage_tile<DH, FC_BK, THREADS>(sV(buf ^ 1), vg, v_ld, 0, 0, (kt + 1) * FC_BK, n);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (kt == 0) {  // this warp's 16 query rows as A fragments, kept in registers
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        ldmatrix_x4(qf[kk], sQ + (warp * 16 + a_row) * LD + kk * 16 + a_col);
    }
    const bf16* k_s = sK(buf);
    const bf16* v_s = sV(buf);
    const int k0 = kt * FC_BK;

    float s[FC_BK / 8][4];
#pragma unroll
    for (int j = 0; j < FC_BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int jj = 0; jj < FC_BK / 16; ++jj) {
        uint32_t r[4];
        ldmatrix_x4(r, k_s + (jj * 16 + b_row) * LD + kk * 16 + b_col);
        mma_bf16_16816(s[2 * jj], qf[kk], r[0], r[1]);
        mma_bf16_16816(s[2 * jj + 1], qf[kk], r[2], r[3]);
      }
    }

    // online softmax in base 2 (scores pre-scaled by log2 e); thread rows:
    // g (c0, c1) and g + 8 (c2, c3)
    float mx[2] = {m_run[0], m_run[1]};
    const bool full = k0 + FC_BK <= n;
#pragma unroll
    for (int j = 0; j < FC_BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        s[j][e] = (full || key < n) ? s[j][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float corr[2], lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m_run[r] - mx[r]);  // 2^-inf = 0 on the first tile
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < FC_BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - mx[e >> 1]);
        lsum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
      l_run[r] = l_run[r] * corr[r] + lsum[r];
    }
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      o[i][0] *= corr[0]; o[i][1] *= corr[0];
      o[i][2] *= corr[1]; o[i][3] *= corr[1];
    }

    // P (bf16, C layout reused as A fragments) . V (B fragments by ldmatrix.trans)
#pragma unroll
    for (int kk = 0; kk < FC_BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int ii = 0; ii < DH / 16; ++ii) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, v_s + (kk * 16 + a_row) * LD + ii * 16 + a_col);
        mma_bf16_16816(o[2 * ii], pa, r[0], r[1]);
        mma_bf16_16816(o[2 * ii + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();  // this buffer is refilled in the next iteration
  }
}

}  // namespace sesa
