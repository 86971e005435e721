// K4: the fused conformer attention block on Hopper, as a chain of
// hand-written kernels.
//
// Replaces: sesa_tpu/ops/attention.py fused_conformer_attention (Pallas
// kernel _conformer_attn_kernel), which computes
//   x + W_o . softmax((q . k^T + q . E[clip(i - j, -P, P) + P]) * scale) . v + b_o
// with xn = LayerNorm(x) * gamma + beta and q, k, v = W_qkv . xn (rows of
// W_qkv: q heads, then k heads, then v heads), E the (2P + 1, dh) Shaw
// relative-position table shared by the heads (lucidrains conformer; the
// distance is i - j, as sesa_tpu/models/conformer_core.py _attn_apply), an
// f32 softmax and keys at padded positions masked.
//
// Bound on the H100: tensor-core operations. At the mel-band conformer shapes
// (d 384, 8 heads x 64, tokens 248,400) one call does 2 * T * d * 4hd =
// 3.9e11 FLOP of projections plus 6 * b * h * n^2 * dh of q.k, q.E and p.v:
// 5.3e11 on the time leg (b 360, n 690), 4.6e10 on the freq leg (b 4140,
// n 60); against ~0.11 ms of unavoidable traffic at 3.35 TB/s.
//
// Design. The TPU kernel held a whole sequence's qkv and its (n, n) logits in
// VMEM and skewed q . E_exp^T into the logits with a strided lane roll. Here:
//   1. proj: LayerNorm row pass (rmsnorm.cuh) -> GEMM against W_qkv, bf16 qkv.
//   2. core: flash attention per (sequence, head, 64- or 128-query tile),
//      K/V tiles of 64 keys double-buffered through cp.async. For each
//      (query tile, key tile) pair the distances i - j span BQ + 63 values;
//      the table rows clip(i - j, -P, P) + P for that span are staged beside
//      K and V. Each warp multiplies its 16 query rows against the 80 staged
//      rows its own distances reach (mma.sync, f32 sums), keeps that q . E
//      tile in shared memory, and adds element
//      qE[i][(i - i0) - (j - j0) + 63] to q . k^T in f32 before the scale,
//      as the TPU kernel does. Online f32 softmax, keys >= n masked, rows >= n
//      not written.
//   3. out: GEMM with W_o, + b_o, bf16, + x residual in the epilogue.
// xn, qkv and the attention output cross device memory once each, which the
// fused TPU kernel avoided; one persistent kernel is later work.
#include "gemm.cuh"

namespace sesa {

constexpr int CA_BK = 64;    // keys per tile; 16 query rows per warp
constexpr int CA_QE_W = 80;  // table rows one warp's 16 rows reach per key tile (79 used)
constexpr int CA_LDQE = 84;  // f32 row stride of a warp's q . E tile

template <int DH, int BQ>
constexpr int conf_attn_smem_bytes() {
  // Q, K x 2, V x 2, E x 2 (BQ + 64 rows) in bf16, then one q . E tile per warp
  return (BQ + 4 * CA_BK + 2 * (BQ + CA_BK)) * (DH + 8) * 2 + (BQ / 16) * 16 * CA_LDQE * 4;
}

// BQ query rows per block (BQ / 16 warps); scale_log2 = scale * log2(e)
template <int DH, int BQ>
__global__ void __launch_bounds__(BQ * 2)
conf_attn_core_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ rel,
                      bf16* __restrict__ ao, int n, int heads, int max_pos, float scale_log2) {
  constexpr int LD = DH + 8, THREADS = BQ * 2, ER = BQ + CA_BK;
  extern __shared__ __align__(16) unsigned char ca_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(ca_smem);
  auto sK = [&](int b) { return sQ + (BQ + b * CA_BK) * LD; };
  auto sV = [&](int b) { return sQ + (BQ + (2 + b) * CA_BK) * LD; };
  auto sE = [&](int b) { return sQ + (BQ + 4 * CA_BK + b * ER) * LD; };

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, seq0 = blockIdx.z * n;
  const int hd = heads * DH, stride = 3 * hd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix.x4 lane addressing (see gemm.cuh)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  float* qe_w = reinterpret_cast<float*>(sQ + (BQ + 4 * CA_BK + 2 * ER) * LD) +
                warp * 16 * CA_LDQE;

  // staged row r of E for key tile k0 holds E[clip(q0 - k0 + r - 63, -P, P) + P]:
  // the distance of query q0 + a and key k0 + c with r = a - c + 63
  auto stage_e = [&](bf16* dst, int k0) {
    constexpr int CPR = DH / 8;
#pragma unroll
    for (int c = threadIdx.x; c < ER * CPR; c += THREADS) {
      const int r = c / CPR, d0 = (c % CPR) * 8;
      const int dist = min(max(q0 - k0 + r - (CA_BK - 1), -max_pos), max_pos);
      cp_async16(dst + r * LD + d0, rel + (size_t)(dist + max_pos) * DH + d0);
    }
  };

  stage_tile<DH, BQ, THREADS>(sQ, qkv, stride, h * DH, seq0, q0, n);
  stage_tile<DH, CA_BK, THREADS>(sK(0), qkv, stride, (heads + h) * DH, seq0, 0, n);
  stage_tile<DH, CA_BK, THREADS>(sV(0), qkv, stride, (2 * heads + h) * DH, seq0, 0, n);
  stage_e(sE(0), 0);
  cp_async_commit();

  uint32_t qf[DH / 16][4];
  float o[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  const int n_tiles = (n + CA_BK - 1) / CA_BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      const int k1 = (kt + 1) * CA_BK;
      stage_tile<DH, CA_BK, THREADS>(sK(buf ^ 1), qkv, stride, (heads + h) * DH, seq0, k1, n);
      stage_tile<DH, CA_BK, THREADS>(sV(buf ^ 1), qkv, stride, (2 * heads + h) * DH, seq0,
                                     k1, n);
      stage_e(sE(buf ^ 1), k1);
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
    const bf16* e_s = sE(buf) + warp * 16 * LD;  // this warp's 80 table rows
    const int k0 = kt * CA_BK;

    {  // q . E over the warp's distances into its shared-memory tile
      float qe[CA_QE_W / 8][4];
#pragma unroll
      for (int j = 0; j < CA_QE_W / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) qe[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
        for (int jj = 0; jj < CA_QE_W / 16; ++jj) {
          uint32_t r[4];
          ldmatrix_x4(r, e_s + (jj * 16 + b_row) * LD + kk * 16 + b_col);
          mma_bf16_16816(qe[2 * jj], qf[kk], r[0], r[1]);
          mma_bf16_16816(qe[2 * jj + 1], qf[kk], r[2], r[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < CA_QE_W / 8; ++j) {
        *reinterpret_cast<float2*>(qe_w + g * CA_LDQE + j * 8 + 2 * t) =
            make_float2(qe[j][0], qe[j][1]);
        *reinterpret_cast<float2*>(qe_w + (g + 8) * CA_LDQE + j * 8 + 2 * t) =
            make_float2(qe[j][2], qe[j][3]);
      }
      __syncwarp();
    }

    float s[CA_BK / 8][4];
#pragma unroll
    for (int j = 0; j < CA_BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int jj = 0; jj < CA_BK / 16; ++jj) {
        uint32_t r[4];
        ldmatrix_x4(r, k_s + (jj * 16 + b_row) * LD + kk * 16 + b_col);
        mma_bf16_16816(s[2 * jj], qf[kk], r[0], r[1]);
        mma_bf16_16816(s[2 * jj + 1], qf[kk], r[2], r[3]);
      }
    }

    // (q . k + q . E[dist]) * scale in f32, then the online softmax in base 2
    // (logits pre-scaled by log2 e); thread rows: g (c0, c1) and g + 8 (c2, c3)
    float mx[2] = {m_run[0], m_run[1]};
    const bool full = k0 + CA_BK <= n;
#pragma unroll
    for (int j = 0; j < CA_BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + (e >> 1) * 8, col = j * 8 + 2 * t + (e & 1);
        const float bias = qe_w[row * CA_LDQE + row - col + CA_BK - 1];
        s[j][e] = (full || k0 + col < n) ? (s[j][e] + bias) * scale_log2 : -INFINITY;
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
    for (int j = 0; j < CA_BK / 8; ++j)
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
    for (int kk = 0; kk < CA_BK / 16; ++kk) {
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
    __syncthreads();  // these buffers and the q . E tiles are refilled next iteration
  }

  // normalise and store in bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = q0 + warp * 16 + g + r * 8;
    if (pos >= n) continue;
    const size_t tok = (size_t)seq0 + pos;
    const float inv_l = 1.0f / l_run[r];
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<uint32_t*>(ao + tok * hd + h * DH + i * 8 + 2 * t) =
          pack_bf16x2(o[i][2 * r] * inv_l, o[i][2 * r + 1] * inv_l);
  }
}

}  // namespace sesa

using namespace sesa;

template <int DH, int BQ>
static int launch_conf_attn_core(const void* qkv, const void* rel, void* ao, int batch, int n,
                                 int heads, int max_pos, float scale_log2, cudaStream_t s) {
  constexpr int smem = conf_attn_smem_bytes<DH, BQ>();
  cudaFuncSetAttribute(conf_attn_core_kernel<DH, BQ>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((n + BQ - 1) / BQ, heads, batch);
  conf_attn_core_kernel<DH, BQ><<<grid, BQ * 2, smem, s>>>(
      (const bf16*)qkv, (const bf16*)rel, (bf16*)ao, n, heads, max_pos, scale_log2);
  return (int)cudaGetLastError();
}

extern "C" {

// xn = layer_norm(x) * gamma + beta; qkv = bf16(xn . wqkv^T); xn is
// (tokens, dim) scratch, qkv (tokens, n_out)
int sesa_conf_attn_proj(const void* x, const void* gamma, const void* beta, void* xn,
                        const void* wqkv, void* qkv, int tokens, int dim, int n_out,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = launch_layer_norm((const bf16*)x, (const bf16*)gamma, (const bf16*)beta,
                                   (bf16*)xn, tokens, dim, s);
  if (rc != 0) return rc;
  GemmArgs p = {};
  p.A = (const bf16*)xn; p.B1 = (const bf16*)wqkv; p.C1 = (bf16*)qkv;
  p.M = tokens; p.N = n_out; p.K = dim; p.ldc1 = n_out;
  p.out_scale = 1.0f;
  return launch_gemm<EPI_RESID>(p, s);
}

// ao = softmax((q . k^T + q . rel[clip(i - j, -P, P) + P]) * scale) . v per
// (sequence, head); rel is the (2P + 1, dim_head) table. 64-query tiles for
// sequences that fit one (the freq leg) and for dim_head 128, else 128.
int sesa_conf_attn_core(const void* qkv, const void* rel, void* ao, int batch, int n,
                        int heads, int dim_head, int max_pos, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float sl2 = scale * 1.4426950408889634f;
  if (dim_head == 32)
    return n <= 64 ? launch_conf_attn_core<32, 64>(qkv, rel, ao, batch, n, heads, max_pos, sl2, s)
                   : launch_conf_attn_core<32, 128>(qkv, rel, ao, batch, n, heads, max_pos, sl2, s);
  if (dim_head == 64)
    return n <= 64 ? launch_conf_attn_core<64, 64>(qkv, rel, ao, batch, n, heads, max_pos, sl2, s)
                   : launch_conf_attn_core<64, 128>(qkv, rel, ao, batch, n, heads, max_pos, sl2, s);
  if (dim_head == 128)
    return launch_conf_attn_core<128, 64>(qkv, rel, ao, batch, n, heads, max_pos, sl2, s);
  return (int)cudaErrorInvalidValue;
}

// out = bf16(bf16(ao . wo^T + bo) + x)
int sesa_conf_attn_out(const void* ao, const void* wo, const void* bo, const void* x,
                       void* out, int tokens, int dim, int hd, void* stream) {
  GemmArgs p = {};
  p.A = (const bf16*)ao; p.B1 = (const bf16*)wo; p.bias1 = (const bf16*)bo;
  p.resid = (const bf16*)x; p.C1 = (bf16*)out;
  p.M = tokens; p.N = dim; p.K = hd; p.ldc1 = dim;
  p.out_scale = 1.0f;
  return launch_gemm<EPI_RESID>(p, (cudaStream_t)stream);
}

}  // extern "C"
