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
// the bf16 peak, against 1.05 GB of q, k, v and output, 0.31 ms). At D 64
// the softmax costs about as much issue time as the products (one exp2 per
// score: 16K per 128 x 128 block, against ~1K cycles of wgmma), so the
// design hides it behind them.
//
// Design (flash_wgmma.cuh): an SM cannot hold an S x S f32 tile (1.9 MB at S
// 690), so this is flash attention, persistent: one block per SM walks over
// (sequence, 128-query) tiles, a sequence's tiles on neighbouring blocks so
// its K and V come from L2. A producer warp feeds Q and a ring of K/V tiles
// by TMA with mbarriers; two consumer warpgroups of 64 query rows run both
// products as wgmma and overlap each block's softmax with the previous
// block's P . V product. Unlike the TPU kernel the probabilities are rounded
// to bf16 before the row sum is known (unnormalised), which moves a result
// by about one bf16 ulp.
//
// q, k and v are read through TMA tensor maps encoded here for each call
// from the dims and byte strides the wrapper computes (ops/attention.py
// k3_plan): a 4-D (d, s, h, b) map reads the roformer's permuted views of
// its qkv projection where they lie; contiguous (BH, S, D) input, whose
// head stride is 0, is a 3-D (d, s, bh) map. Rows past S come as zero fill.
// The output is addressed by (batch, head, row) strides, so it can be
// written in the (b, s, h, d) layout that the out projection reads.
#include "flash_wgmma.cuh"

using namespace sesa;

extern "C" {

// o = softmax(q . k^T * scale) . v for batch x heads sequences of n rows of
// dim_head values. rank 4: dims (dim_head, n, heads, batch); rank 3: dims
// (dim_head, n, batch), heads 1. *_s1..3: byte strides of dims 1..rank-1 of
// q, k, v (multiples of 16); ob, oh, os: output strides in elements for
// (batch, head, row), unit stride along dim_head; scale > 0. dim_head is a
// multiple of 8 up to 128: other than 32, 64 or 128 it runs on the next of
// them, TMA's zero fill padding each head (the wrapper pads a width that is
// not a multiple of 8 with a copy)
int sesa_vmem_attn(const void* q, const void* k, const void* v, void* o, int rank,
                   long long d0, long long d1, long long d2, long long d3,
                   long long q_s1, long long q_s2, long long q_s3,
                   long long k_s1, long long k_s2, long long k_s3,
                   long long v_s1, long long v_s2, long long v_s3,
                   long long ob, long long oh, long long os,
                   int batch, int heads, int n, int dim_head, float scale, void* stream) {
  if ((rank != 3 && rank != 4) || !(scale > 0.f) || dim_head < 8 || dim_head > 128 ||
      dim_head % 8 || d0 != dim_head || d1 != n ||
      (rank == 4 && (d2 != heads || d3 != batch)) || (rank == 3 && (d2 != batch || heads != 1)))
    return (int)cudaErrorInvalidValue;
  const uint64_t dims[4] = {(uint64_t)d0, (uint64_t)d1, (uint64_t)d2, (uint64_t)d3};
  const uint64_t qs[3] = {(uint64_t)q_s1, (uint64_t)q_s2, (uint64_t)q_s3};
  const uint64_t ks[3] = {(uint64_t)k_s1, (uint64_t)k_s2, (uint64_t)k_s3};
  const uint64_t vs[3] = {(uint64_t)v_s1, (uint64_t)v_s2, (uint64_t)v_s3};
  FlashArgs a = {(bf16*)o, ob, oh, os, heads, n, 0, 0, rank, scale * 1.4426950408889634f};
  a.dv = dim_head;
  cudaStream_t s = (cudaStream_t)stream;
  // the narrowest instance that holds dim_head; three consumer warpgroups
  // (192-query tiles) where their registers fit
  if (dim_head <= 32) return launch_flash_wgmma<32, 3>(a, q, k, v, dims, qs, ks, vs, batch, s);
  if (dim_head <= 64) return launch_flash_wgmma<64, 3>(a, q, k, v, dims, qs, ks, vs, batch, s);
  return launch_flash_wgmma<128, 2>(a, q, k, v, dims, qs, ks, vs, batch, s);
}

}  // extern "C"
