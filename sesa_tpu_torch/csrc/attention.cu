// K1: the fused roformer attention block on Hopper, as a chain of three
// hand-written kernels.
//
// Replaces: sesa_tpu/ops/attention.py fused_attention_block (Pallas kernel
// _attn_block_kernel), which computes
//   x + W_o . (sigmoid(W_g . xn + b_g) * softmax(rope(q) . rope(k)^T * scale) . v)
// with xn = rms_norm(x) * gamma and q, k, v = W_qkv . xn, f32 softmax, keys
// at padded positions masked.
//
// Bound on the H100: tensor-core operations. At the flagship shapes
// (d 512, 8 heads x 64, tokens 256,680) one call does about 5.4e11 FLOP of
// projections plus 3.6e11 (time leg, n 690) or 3.3e10 (freq leg, n 62) of
// attention, against ~0.16 ms of unavoidable traffic at 3.35 TB/s.
//
// Design. One TPU program held a (gb*690, 1536) qkv scratch and a 690x690
// f32 score tile in VMEM; an SM's 227 KB cannot, so the block is split:
//   1. proj: RMSNorm row pass (f32 sums, bf16 rounding of xn as the TPU
//      kernel, rmsnorm.cuh) -> GEMM against [W_qkv; W_g] -> qkv in bf16
//      with rope applied to q and
//      k in the epilogue (interleaved pairs sit in one thread's registers;
//      bf16 arithmetic as the TPU kernel), sigmoid(gates + b_g) in f32.
//   2. core: flash-style attention per (sequence, head, 64- or 128-query
//      tile):
//      K/V tiles of 64 keys double-buffered through cp.async, fragments by
//      ldmatrix (V transposed by ldmatrix.trans), an online f32 softmax,
//      keys >= n masked, the per-head gate multiplied in before the bf16
//      store; rows >= n are not written.
//   3. out: GEMM with W_o, residual added in the epilogue.
// xn, the qkv tensor and the gated attention output cross device memory
// once each, which the fused TPU kernel avoided; making the chain one persistent
// kernel with wgmma and TMA is later work.
#include "gemm.cuh"

namespace sesa {

constexpr int AT_BK = 64;  // keys per tile; 16 query rows per warp

template <int DH, int BQ>
constexpr int attn_smem_bytes() { return (BQ + 4 * AT_BK) * (DH + 8) * 2; }

// BQ query rows per block (BQ / 16 warps); scale_log2 = scale * log2(e)
template <int DH, int BQ>
__global__ void __launch_bounds__(BQ * 2)
attn_core_kernel(const bf16* __restrict__ qkv, const float* __restrict__ gates,
                 bf16* __restrict__ ao, int n, int heads, float scale_log2) {
  constexpr int LD = DH + 8, THREADS = BQ * 2;
  extern __shared__ __align__(16) unsigned char at_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(at_smem);
  // K buffers 0, 1 then V buffers 0, 1 after the Q tile
  auto sK = [&](int b) { return sQ + (BQ + b * AT_BK) * LD; };
  auto sV = [&](int b) { return sQ + (BQ + (2 + b) * AT_BK) * LD; };

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, seq0 = blockIdx.z * n;
  const int hd = heads * DH, stride = 3 * hd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix.x4 lane addressing (see gemm.cuh)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;

  stage_tile<DH, BQ, THREADS>(sQ, qkv, stride, h * DH, seq0, q0, n);
  stage_tile<DH, AT_BK, THREADS>(sK(0), qkv, stride, (heads + h) * DH, seq0, 0, n);
  stage_tile<DH, AT_BK, THREADS>(sV(0), qkv, stride, (2 * heads + h) * DH, seq0, 0, n);
  cp_async_commit();

  uint32_t qf[DH / 16][4];
  float o[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  const int n_tiles = (n + AT_BK - 1) / AT_BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      stage_tile<DH, AT_BK, THREADS>(sK(buf ^ 1), qkv, stride, (heads + h) * DH, seq0,
                                     (kt + 1) * AT_BK, n);
      stage_tile<DH, AT_BK, THREADS>(sV(buf ^ 1), qkv, stride, (2 * heads + h) * DH, seq0,
                                     (kt + 1) * AT_BK, n);
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
    const int k0 = kt * AT_BK;

    float s[AT_BK / 8][4];
#pragma unroll
    for (int j = 0; j < AT_BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int jj = 0; jj < AT_BK / 16; ++jj) {
        uint32_t r[4];
        ldmatrix_x4(r, k_s + (jj * 16 + b_row) * LD + kk * 16 + b_col);
        mma_bf16_16816(s[2 * jj], qf[kk], r[0], r[1]);
        mma_bf16_16816(s[2 * jj + 1], qf[kk], r[2], r[3]);
      }
    }

    // online softmax in base 2 (logits pre-scaled by log2 e); thread rows:
    // g (c0, c1) and g + 8 (c2, c3)
    float mx[2] = {m_run[0], m_run[1]};
    const bool full = k0 + AT_BK <= n;
#pragma unroll
    for (int j = 0; j < AT_BK / 8; ++j) {
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
    for (int j = 0; j < AT_BK / 8; ++j)
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
    for (int kk = 0; kk < AT_BK / 16; ++kk) {
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

  // normalise, gate (bf16 product of bf16 values, as the TPU kernel), store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = q0 + warp * 16 + g + r * 8;
    if (pos >= n) continue;
    const size_t tok = (size_t)seq0 + pos;
    const float gate = rbf(gates[tok * heads + h]);
    const float inv_l = 1.0f / l_run[r];
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      const float v0 = rbf(o[i][2 * r] * inv_l) * gate;
      const float v1 = rbf(o[i][2 * r + 1] * inv_l) * gate;
      *reinterpret_cast<uint32_t*>(ao + tok * hd + h * DH + i * 8 + 2 * t) = pack_bf16x2(v0, v1);
    }
  }
}

}  // namespace sesa

using namespace sesa;

template <int DH, int BQ>
static void launch_attn_core(const void* qkv, const void* gates, void* ao, int batch,
                             int n, int heads, float scale_log2, cudaStream_t s) {
  constexpr int smem = attn_smem_bytes<DH, BQ>();
  cudaFuncSetAttribute(attn_core_kernel<DH, BQ>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((n + BQ - 1) / BQ, heads, batch);
  attn_core_kernel<DH, BQ><<<grid, BQ * 2, smem, s>>>(
      (const bf16*)qkv, (const float*)gates, (bf16*)ao, n, heads, scale_log2);
}

extern "C" {

// xn = rms_norm(x) * gamma; qkv = bf16(xn . wqkv^T) with rope on q and k;
// gates = sigmoid(xn . wg^T + bg). cos_t/sin_t (seq_len, rot_width) or null.
// xn is (tokens, dim) scratch.
int sesa_attn_proj(const void* x, const void* gamma, void* xn, const void* wqkv,
                   const void* wg, const void* bg, const void* cos_t, const void* sin_t,
                   void* qkv, void* gates, int tokens, int dim, int heads, int dim_head,
                   int seq_len, int rot_width, void* stream) {
  const int rc = launch_rms_norm<RMS_ATTN>((const bf16*)x, (const bf16*)gamma, (bf16*)xn,
                                           tokens, dim, (cudaStream_t)stream);
  if (rc != 0) return rc;
  const int hd = heads * dim_head;
  GemmArgs p = {};
  p.A = (const bf16*)xn; p.B1 = (const bf16*)wqkv; p.B2 = (const bf16*)wg;
  p.bias2 = (const bf16*)bg;
  p.cos_t = (const bf16*)cos_t; p.sin_t = (const bf16*)sin_t;
  p.C1 = (bf16*)qkv; p.C2 = (float*)gates;
  p.M = tokens; p.N = 3 * hd + heads; p.K = dim; p.n1 = 3 * hd; p.ldc1 = 3 * hd;
  p.seq_len = seq_len; p.rot_w = rot_width; p.dim_head = dim_head; p.rope_cols = 2 * hd;
  p.out_scale = 1.0f;
  return launch_gemm<EPI_QKV_GATES>(p, (cudaStream_t)stream);
}

// ao = gate * softmax(q . k^T * scale) . v per (sequence, head); q, k roped
// 64-query tiles for sequences that fit one (the freq leg), else 128
int sesa_attn_core(const void* qkv, const void* gates, void* ao, int batch, int n,
                   int heads, int dim_head, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float scale_log2 = scale * 1.4426950408889634f;
  if (dim_head == 64 && n <= 64) {
    launch_attn_core<64, 64>(qkv, gates, ao, batch, n, heads, scale_log2, s);
  } else if (dim_head == 64) {
    launch_attn_core<64, 128>(qkv, gates, ao, batch, n, heads, scale_log2, s);
  } else if (dim_head == 32 && n <= 64) {
    launch_attn_core<32, 64>(qkv, gates, ao, batch, n, heads, scale_log2, s);
  } else if (dim_head == 32) {
    launch_attn_core<32, 128>(qkv, gates, ao, batch, n, heads, scale_log2, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out = bf16(bf16(ao . wo^T) + x)
int sesa_attn_out(const void* ao, const void* wo, const void* x, void* out,
                  int tokens, int dim, int hd, void* stream) {
  GemmArgs p = {};
  p.A = (const bf16*)ao; p.B1 = (const bf16*)wo; p.resid = (const bf16*)x;
  p.C1 = (bf16*)out;
  p.M = tokens; p.N = dim; p.K = hd; p.n1 = dim; p.ldc1 = dim;
  p.out_scale = 1.0f;
  return launch_gemm<EPI_RESID>(p, (cudaStream_t)stream);
}

}  // extern "C"
