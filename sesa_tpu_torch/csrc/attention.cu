// K1: the fused roformer attention block on Hopper, as a chain of three
// hand-written kernels.
//
// Replaces: sesa_tpu/ops/attention.py fused_attention_block (Pallas kernel
// _attn_block_kernel), which computes
//   x + W_o . (sigmoid(W_g . xn + b_g) * softmax(rope(q) . rope(k)^T * scale) . v)
// with xn = rms_norm(x) * gamma and q, k, v = W_qkv . xn, f32 softmax, keys
// at padded positions masked. Its value-residual modes (vr_mode 1 and 2 of
// _attn_block_kernel) also return the pre-mix V and lerp V toward a given
// first-layer V by sigmoid(W_vr . xn + b_vr) per head; add_residual=False
// leaves x out of the sum.
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
//   2. core: flash attention per (sequence, head, 64- or 128-query tile),
//      the loop of flash_core.cuh (shared with K3): online f32 softmax, keys
//      >= n masked; the per-head gate is multiplied in before the bf16
//      store; rows >= n are not written.
//   3. out: GEMM with W_o, residual added in the epilogue (or not).
// Value residual: the mix projection is h more columns beside the gates' in
// the projection GEMM (sigmoid in its epilogue, f32), and one elementwise
// pass between proj and core copies the V columns of the qkv buffer out as
// the pre-mix V and overwrites them with bf16(v + (v_first - v) * mix), v
// and v_first read as f32, before the core reads V.
// xn, the qkv tensor and the gated attention output cross device memory
// once each, which the fused TPU kernel avoided; making the chain one persistent
// kernel with wgmma and TMA is later work.
#include "flash_core.cuh"
#include "gemm.cuh"

namespace sesa {

// The core: flash_core over one head's columns of the qkv buffer, then the
// per-head gate. BQ query rows per block (BQ / 16 warps); scale_log2 = scale
// * log2(e)
template <int DH, int BQ>
__global__ void __launch_bounds__(BQ * 2)
attn_core_kernel(const bf16* __restrict__ qkv, const float* __restrict__ gates,
                 bf16* __restrict__ ao, int n, int heads, int gate_ld, float scale_log2) {
  extern __shared__ __align__(16) unsigned char at_smem[];
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, seq0 = blockIdx.z * n;
  const int hd = heads * DH, stride = 3 * hd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qg = qkv + (size_t)seq0 * stride + h * DH;

  float o[DH / 8][4], l_run[2];
  flash_core<DH, BQ>(reinterpret_cast<bf16*>(at_smem), qg, qg + hd, qg + 2 * hd, stride,
                     stride, stride, q0, n, scale_log2, o, l_run);

  // normalise, gate (bf16 product of bf16 values, as the TPU kernel), store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = q0 + warp * 16 + g + r * 8;
    if (pos >= n) continue;
    const size_t tok = (size_t)seq0 + pos;
    const float gate = rbf(gates[tok * gate_ld + h]);
    const float inv_l = 1.0f / l_run[r];
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      const float v0 = rbf(o[i][2 * r] * inv_l) * gate;
      const float v1 = rbf(o[i][2 * r + 1] * inv_l) * gate;
      *reinterpret_cast<uint32_t*>(ao + tok * hd + h * DH + i * 8 + 2 * t) = pack_bf16x2(v0, v1);
    }
  }
}

// The value-residual pass over the V columns of the qkv buffer, 8 values
// (16 bytes) per thread: v_pre = v; with v_first, v <- bf16(v + (v_first - v)
// * mix) in f32, mix = side[token, heads + head] (already through the sigmoid)
__global__ void __launch_bounds__(256)
attn_vr_kernel(bf16* __restrict__ qkv, const float* __restrict__ side,
               const bf16* __restrict__ v_first, bf16* __restrict__ v_pre, int tokens,
               int heads, int dim_head, int side_ld) {
  const int hd = heads * dim_head, per_row = hd / 8;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)tokens * per_row) return;
  const size_t tok = idx / per_row;
  const int c = (int)(idx % per_row) * 8;
  bf16* vp = qkv + tok * 3 * hd + 2 * hd + c;
  uint4 v = *reinterpret_cast<const uint4*>(vp);
  *reinterpret_cast<uint4*>(v_pre + tok * hd + c) = v;
  if (v_first == nullptr) return;
  const float mix = side[tok * side_ld + heads + c / dim_head];
  const uint4 f = *reinterpret_cast<const uint4*>(v_first + tok * hd + c);
  uint32_t* vw = reinterpret_cast<uint32_t*>(&v);
  const uint32_t* fw = reinterpret_cast<const uint32_t*>(&f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vw + i));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(fw + i));
    vw[i] = pack_bf16x2(a.x + (b.x - a.x) * mix, a.y + (b.y - a.y) * mix);
  }
  *reinterpret_cast<uint4*>(vp) = v;
}

}  // namespace sesa

using namespace sesa;

template <int DH, int BQ>
static void launch_attn_core(const void* qkv, const void* gates, void* ao, int batch,
                             int n, int heads, int gate_ld, float scale_log2, cudaStream_t s) {
  constexpr int smem = flash_core_smem_bytes<DH, BQ>();
  cudaFuncSetAttribute(attn_core_kernel<DH, BQ>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((n + BQ - 1) / BQ, heads, batch);
  attn_core_kernel<DH, BQ><<<grid, BQ * 2, smem, s>>>(
      (const bf16*)qkv, (const float*)gates, (bf16*)ao, n, heads, gate_ld, scale_log2);
}

extern "C" {

// xn = rms_norm(x) * gamma; qkv = bf16(xn . wqkv^T) with rope on q and k;
// gates = sigmoid(xn . wg^T + bg), (tokens, side) f32: wg (side, dim) and bg
// (side,) hold the heads' gate rows, then for the value-residual mix the
// heads' mix rows (side = heads or 2 * heads). cos_t/sin_t (seq_len,
// rot_width) or null. xn is (tokens, dim) scratch.
int sesa_attn_proj(const void* x, const void* gamma, void* xn, const void* wqkv,
                   const void* wg, const void* bg, const void* cos_t, const void* sin_t,
                   void* qkv, void* gates, int tokens, int dim, int heads, int dim_head,
                   int seq_len, int rot_width, int side, void* stream) {
  const int rc = launch_rms_norm<RMS_ATTN>((const bf16*)x, (const bf16*)gamma, (bf16*)xn,
                                           tokens, dim, (cudaStream_t)stream);
  if (rc != 0) return rc;
  const int hd = heads * dim_head;
  GemmArgs p = {};
  p.A = (const bf16*)xn; p.B1 = (const bf16*)wqkv; p.B2 = (const bf16*)wg;
  p.bias2 = (const bf16*)bg;
  p.cos_t = (const bf16*)cos_t; p.sin_t = (const bf16*)sin_t;
  p.C1 = (bf16*)qkv; p.C2 = (float*)gates;
  p.M = tokens; p.N = 3 * hd + side; p.K = dim; p.n1 = 3 * hd; p.ldc1 = 3 * hd;
  p.seq_len = seq_len; p.rot_w = rot_width; p.dim_head = dim_head; p.rope_cols = 2 * hd;
  p.out_scale = 1.0f;
  return launch_gemm<EPI_QKV_GATES>(p, (cudaStream_t)stream);
}

// v_pre = the V columns of qkv; with v_first (tokens, heads * dim_head) they
// are then lerped toward it by the mix columns of side (tokens, side_ld)
int sesa_attn_vr(void* qkv, const void* side, const void* v_first, void* v_pre, int tokens,
                 int heads, int dim_head, int side_ld, void* stream) {
  const size_t chunks = (size_t)tokens * heads * dim_head / 8;
  attn_vr_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (bf16*)qkv, (const float*)side, (const bf16*)v_first, (bf16*)v_pre, tokens, heads,
      dim_head, side_ld);
  return (int)cudaGetLastError();
}

// ao = gate * softmax(q . k^T * scale) . v per (sequence, head); q, k roped;
// gates (tokens, gate_ld) with the heads' gates in the first columns.
// 64-query tiles for sequences that fit one (the freq leg), else 128
int sesa_attn_core(const void* qkv, const void* gates, void* ao, int batch, int n,
                   int heads, int dim_head, int gate_ld, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float scale_log2 = scale * 1.4426950408889634f;
  if (dim_head == 64 && n <= 64) {
    launch_attn_core<64, 64>(qkv, gates, ao, batch, n, heads, gate_ld, scale_log2, s);
  } else if (dim_head == 64) {
    launch_attn_core<64, 128>(qkv, gates, ao, batch, n, heads, gate_ld, scale_log2, s);
  } else if (dim_head == 32 && n <= 64) {
    launch_attn_core<32, 64>(qkv, gates, ao, batch, n, heads, gate_ld, scale_log2, s);
  } else if (dim_head == 32) {
    launch_attn_core<32, 128>(qkv, gates, ao, batch, n, heads, gate_ld, scale_log2, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out = bf16(bf16(ao . wo^T) + x), or bf16(ao . wo^T) when x is null
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
