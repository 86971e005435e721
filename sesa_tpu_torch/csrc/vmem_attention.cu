// K3: whole-sequence attention over (BH, S, D) on Hopper.
//
// Replaces: sesa_tpu/ops/attention.py _vmem_attention (Pallas kernel
// _vmem_attn_kernel), which computes softmax(q . k^T * scale) . v for one
// head per step with the whole (S, S) f32 score tile in VMEM: scores and
// softmax in f32, keys at padded positions masked, p rounded to bf16 before
// p . v, the f32 product rounded on the way out.
//
// Bound on the H100: tensor-core operations, 4 * BH * S^2 * D FLOP (at the
// hyper-connection time leg, BH 2976, S 690, D 64: 3.6e11 FLOP, 0.37 ms at
// the bf16 peak, against 1.05 GB of q, k, v and output, 0.31 ms).
//
// Design. An SM cannot hold an S x S f32 tile (1.9 MB at S 690), so this is
// flash attention: one block per (sequence, 128- or 64-query tile) runs the
// loop of flash_core.cuh, which K1's core (attention.cu) runs too: keys >= S
// masked to -inf, the scores never leave registers; rows >= S are not
// written. Unlike the TPU kernel the probabilities are rounded to bf16
// before the row sum is known (unnormalised), which moves a result by about
// one bf16 ulp.
//
// q, k, v and the output are addressed by (batch, head, row) strides, so the
// roformer's permuted views of its qkv projection are read where they lie
// and the output can be written in the (b, s, h, d) layout that the out
// projection reads.
#include "flash_core.cuh"

namespace sesa {

struct VmemAttnArgs {
  const bf16 *q, *k, *v;
  bf16* o;
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;  // strides in elements
  int heads, n, q_tiles;
  float scale_log2;  // scale * log2(e)
};

// two blocks per SM at D <= 64 (at most 128 registers a thread), as K1's core
template <int DH, int BQ>
__global__ void __launch_bounds__(BQ * 2, DH <= 64 ? 2 : 1)
vmem_attn_kernel(const VmemAttnArgs p) {
  extern __shared__ __align__(16) unsigned char va_smem[];
  const int n = p.n;
  // a sequence's query tiles are neighbours in the grid, so that its K and V
  // are read from device memory once and then from L2
  const int q0 = (blockIdx.x % p.q_tiles) * BQ, seq = blockIdx.x / p.q_tiles;
  const long long bi = seq / p.heads, hi = seq % p.heads;
  bf16* og = p.o + bi * p.ob + hi * p.oh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  // row strides fit an int (the host checks)
  float o[DH / 8][4], l_run[2];
  flash_core<DH, BQ>(reinterpret_cast<bf16*>(va_smem), p.q + bi * p.qb + hi * p.qh,
                     p.k + bi * p.kb + hi * p.kh, p.v + bi * p.vb + hi * p.vh, (int)p.qs,
                     (int)p.ks, (int)p.vs, q0, n, p.scale_log2, o, l_run);

  // normalise and store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = q0 + warp * 16 + g + r * 8;
    if (pos >= n) continue;
    const float inv_l = 1.0f / l_run[r];
    bf16* orow = og + (long long)pos * p.os;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<uint32_t*>(orow + i * 8 + 2 * t) =
          pack_bf16x2(o[i][2 * r] * inv_l, o[i][2 * r + 1] * inv_l);
  }
}

}  // namespace sesa

using namespace sesa;

template <int DH, int BQ>
static int launch_vmem_attn(VmemAttnArgs p, int batch, cudaStream_t s) {
  constexpr int smem = flash_core_smem_bytes<DH, BQ>();
  cudaFuncSetAttribute(vmem_attn_kernel<DH, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  p.q_tiles = (p.n + BQ - 1) / BQ;
  const long long blocks = (long long)batch * p.heads * p.q_tiles;
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  vmem_attn_kernel<DH, BQ><<<(unsigned)blocks, BQ * 2, smem, s>>>(p);
  return (int)cudaGetLastError();
}

extern "C" {

// o = softmax(q . k^T * scale) . v for batch x heads sequences of n rows of
// dim_head values; strides in elements for (batch, head, row), unit stride
// along dim_head, 16-byte aligned rows
int sesa_vmem_attn(const void* q, const void* k, const void* v, void* o,
                   long long qb, long long qh, long long qs,
                   long long kb, long long kh, long long ks,
                   long long vb, long long vh, long long vs,
                   long long ob, long long oh, long long os,
                   int batch, int heads, int n, int dim_head, float scale, void* stream) {
  if (qs > 0x7fffffffLL || ks > 0x7fffffffLL || vs > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  VmemAttnArgs p = {(const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
                    qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os,
                    heads, n, 0, scale * 1.4426950408889634f};
  cudaStream_t s = (cudaStream_t)stream;
  if (dim_head == 32) return launch_vmem_attn<32, 128>(p, batch, s);
  if (dim_head == 64) return launch_vmem_attn<64, 128>(p, batch, s);
  if (dim_head == 128) return launch_vmem_attn<128, 64>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
