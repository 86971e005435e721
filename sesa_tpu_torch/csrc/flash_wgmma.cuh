// The attention core on Hopper of K3 (vmem_attention.cu) and K1
// (attention.cu): softmax(q . k^T * scale) . v over whole sequences, one
// persistent block per SM walking over (sequence, BQ-query) tiles, BQ = 64
// per consumer warpgroup.
//
// A compile-time option, off for K3: with GATE the output row of token (b,
// pos), head h is multiplied by bf16(gates[(b * n + pos) * gate_ld + h])
// before the store: bf16(bf16(o / l) * bf16(gate)), the rounding points of
// the TPU kernel's ao * gate (sesa_tpu/ops/attention.py _attn_block_kernel).
//
// Roles (NCW + 1 warpgroups: NCW = 3 consumers at D <= 64, 2 at D 128):
//   warpgroup 0, the producer: one thread issues every copy. It loads a
//     tile's Q once (TMA, `q_full`; two Q buffers at D <= 64, so the next
//     tile's Q arrives during this one) and keeps a ring of STAGES K/V
//     tiles of 128 keys in flight (`k_full`, `v_full`), refilling a stage
//     when both consumers have released it (`kv_empty`); a Q buffer is
//     refilled when both have issued their last Q . K^T from it (`q_empty`).
//   warpgroups 1..NCW, the consumers: each owns 64 of the tile's query
//     rows. S = Q . K^T is wgmma with both operands in shared memory; O +=
//     P . V is wgmma with P from registers (the accumulator layout of the
//     first product is the A fragment of the second) and V read MN-major
//     (transposed) from shared memory.
// The softmax overlaps the products: a consumer issues S_j = Q . K_j^T and
// O += P_{j-1} . V_{j-1} together, waits for S_j only (wgmma.wait_group 1),
// runs the softmax of S_j while the P . V product is in flight, then rescales
// O and packs P_j (after P_{j-1} . V_{j-1}, whose A registers P_j reuses).
// The consumers also take turns, round robin, to issue their wgmmas (named
// barriers 4..3 + NCW), so one consumer's softmax runs while another's
// products do. setmaxnreg moves registers from the producer to the
// consumers: 24 / 160 with three consumers, 40 / 232 with two.
//
// Head widths other than 32, 64 and 128 (K3) run at the next of them: the
// tensor maps' innermost dim is the real width, so TMA fills the columns
// beyond it with zeros, which add nothing to q . k^T and give zero output
// columns that are not stored.
//
// Rounding points (those of the TPU kernel, sesa_tpu/ops/attention.py
// _vmem_attn_kernel): scores and softmax in f32 (exp2 of scores pre-scaled
// by log2 e), the probabilities rounded to bf16 before the row sum is known
// (unnormalised; the row sum is taken over the f32 values), O normalised in
// f32 and rounded to bf16 on the way out. Keys >= n come as TMA's zero fill
// and are masked to -inf before the row max; rows >= n are never stored.
#pragma once

#include "hopper.cuh"

namespace sesa {

template <int DH, int NCW>
struct FlashCfg {
  static constexpr int BQ = 64 * NCW;  // query rows per tile, 64 per consumer warpgroup
  static constexpr int THREADS = 128 * (NCW + 1);
  static constexpr int PRODUCER_REGS = NCW == 3 ? 24 : 40, CONSUMER_REGS = NCW == 3 ? 160 : 232;
  static constexpr int BK = 128;  // keys per K/V tile
  static constexpr int STAGES = DH == 128 ? 2 : 3;
  static constexpr int QBUF = DH == 128 ? 1 : 2;  // Q buffers
  static constexpr int SW = DH >= 64 ? 128 : 64;  // bytes per row of a TMA box (the swizzle)
  static constexpr int BOX = SW / 2;              // bf16 columns per box
  static constexpr int NBOX = DH / BOX;           // boxes across a row of DH
  static constexpr int Q_BYTES = BQ * DH * 2, KV_BYTES = BK * DH * 2;
  static constexpr int OLD = DH + 8;  // row stride of the output staging tile, elements
  static constexpr int OFF_K = QBUF * Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_O = OFF_V + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_O + NCW * 64 * OLD * 2;
  static constexpr int NBARS = 2 * QBUF + 3 * STAGES;
  static constexpr int SMEM = OFF_BAR + 8 * NBARS + 1024;  // + alignment slack
  static_assert(SMEM <= 232448, "shared memory of one block");
};

struct FlashArgs {
  bf16* o;
  long long ob, oh, os;  // output strides in elements: batch, head, row
  int heads, n, q_tiles, tiles, rank;
  float scale_log2;  // scale * log2(e), > 0
  const float* gates;  // GATE: (batch * n, gate_ld) f32, the heads' gates first
  int gate_ld;
  // the head width of q, k, v and o in memory (a multiple of 8, at most DH):
  // the tensor maps' innermost dim, so TMA's zero fill pads a head to DH
  // columns, and the columns of o that are stored
  int dv;
};

// one box of rows [row, row + box rows) at column `col` of head (hi, bi):
// rank 4 maps are (d, s, h, b), rank 3 maps (d, s, bh) with bi the sequence
__device__ __forceinline__ void flash_load_box(void* dst, const CUtensorMap* m, uint64_t* bar,
                                               int col, int row, int hi, int bi, int rank) {
  if (rank == 4)
    tma_load_4d(dst, m, bar, col, row, hi, bi);
  else
    tma_load_3d(dst, m, bar, col, row, bi);
}

// S[64 x 128] = Q[64 x DH] . K[128 x DH]^T for one consumer warpgroup; q is
// its first row in box 0 (boxes of BQ rows follow each other), k the K tile
template <int DH, int NCW>
__device__ __forceinline__ void flash_qk(float (&s)[64], const unsigned char* q,
                                         const unsigned char* k) {
  using C = FlashCfg<DH, NCW>;
  constexpr int STEPS = C::BOX / 16;  // k16 steps per box
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int box = kk / STEPS, sub = kk % STEPS;
    const uint64_t da = desc_kmajor<C::SW>(q + box * C::BQ * C::SW) + 2 * sub;
    const uint64_t db = desc_kmajor<C::SW>(k + box * C::BK * C::SW) + 2 * sub;
    wgmma_ss_m64n128k16(s, da, db, kk > 0);
  }
  wgmma_commit();
}

// O[64 x DH] += P[64 x 128] . V[128 x DH]; P as bf16 A fragments, 4 registers
// per 16 keys; V's boxes of 128 key rows are atoms BK * SW bytes apart
template <int DH, int NCW>
__device__ __forceinline__ void flash_pv(float (&o)[DH / 2], const uint32_t (&pa)[32],
                                         const unsigned char* v) {
  using C = FlashCfg<DH, NCW>;
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk) {
    const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
    const uint64_t db = desc_mnmajor<C::SW>(v + kk * 16 * C::SW, C::BK * C::SW);
    if constexpr (DH == 32)
      wgmma_rs_m64n32k16(o, a, db);
    else if constexpr (DH == 64)
      wgmma_rs_m64n64k16(o, a, db);
    else
      wgmma_rs_m64n128k16(o, a, db);
  }
  wgmma_commit();
}

// the online softmax of one 128-key block of raw scores s (keys k0..): masks
// keys >= n, updates the row max, returns the correction of earlier sums in
// corr, leaves this block's f32 probabilities in s and adds them to this
// thread's part of the row sums. Thread rows: g (e < 2) and g + 8 (e >= 2);
// a row's four threads t share its max.
__device__ __forceinline__ void flash_softmax(float (&s)[64], int k0, int n, int t, float c,
                                              float (&m_run)[2], float (&l_run)[2],
                                              float (&corr)[2]) {
  if (k0 + 128 > n) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + 2 * t + (e & 1) >= n) s[4 * j + e] = -INFINITY;
  }
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = fast_exp2((m_run[r] - mx[r]) * c);  // 2^-inf = 0 on the first block
    m_run[r] = mx[r];
    mc[r] = mx[r] * c;
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = fast_exp2(fmaf(s[i], c, -mc[(i >> 1) & 1]));
    ls[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + ls[r];
}

// the probabilities as bf16 A fragments of P . V, 4 registers per 16 keys
// (the accumulator layout of S read as the A layout)
__device__ __forceinline__ void flash_pack(const float (&s)[64], uint32_t (&pa)[32]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[4 * kk + i] = pack_bf16x2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

template <int DH, int NCW, bool GATE = false>
__global__ void __launch_bounds__(FlashCfg<DH, NCW>::THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const FlashArgs p) {
  using C = FlashCfg<DH, NCW>;
  extern __shared__ unsigned char fw_smem_raw[];
  // swizzled tiles start on 1024-byte boundaries
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(fw_smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* q_empty = q_full + C::QBUF;
  uint64_t* k_full = q_empty + C::QBUF;
  uint64_t* v_full = k_full + C::STAGES;
  uint64_t* kv_empty = v_full + C::STAGES;
  unsigned char* sQ = smem;
  unsigned char* sK = smem + C::OFF_K;
  unsigned char* sV = smem + C::OFF_V;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < C::QBUF; ++b) {
      mbar_init(q_full + b, 1);
      mbar_init(q_empty + b, 4 * NCW);  // one arrival per consumer warp
    }
#pragma unroll
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(k_full + st, 1);
      mbar_init(v_full + st, 1);
      mbar_init(kv_empty + st, 4 * NCW);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int n = p.n, n_kb = (n + C::BK - 1) / C::BK;
  if (threadIdx.x < 128) {
    // ---- producer ----
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      int it = 0;  // K/V tiles loaded so far
      for (int ti = 0, tile = blockIdx.x; tile < p.tiles; ++ti, tile += gridDim.x) {
        const int seq = tile / p.q_tiles, q0 = (tile % p.q_tiles) * C::BQ;
        const int bi = seq / p.heads, hi = seq % p.heads;
        const int qb = ti % C::QBUF;
        mbar_wait(q_empty + qb, ((ti / C::QBUF) & 1) ^ 1);
        mbar_expect_tx(q_full + qb, C::Q_BYTES);
#pragma unroll
        for (int j = 0; j < C::NBOX; ++j)
          flash_load_box(sQ + qb * C::Q_BYTES + j * C::BQ * C::SW, &tq, q_full + qb, j * C::BOX,
                         q0, hi, bi, p.rank);
        for (int kb = 0; kb < n_kb; ++kb, ++it) {
          const int st = it % C::STAGES;
          mbar_wait(kv_empty + st, ((it / C::STAGES) & 1) ^ 1);
          mbar_expect_tx(k_full + st, C::KV_BYTES);
#pragma unroll
          for (int j = 0; j < C::NBOX; ++j)
            flash_load_box(sK + st * C::KV_BYTES + j * C::BK * C::SW, &tk, k_full + st,
                           j * C::BOX, kb * C::BK, hi, bi, p.rank);
          mbar_expect_tx(v_full + st, C::KV_BYTES);
#pragma unroll
          for (int j = 0; j < C::NBOX; ++j)
            flash_load_box(sV + st * C::KV_BYTES + j * C::BK * C::SW, &tv, v_full + st,
                           j * C::BOX, kb * C::BK, hi, bi, p.rank);
        }
      }
    }
  } else {
    // ---- consumers ----
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int cw = (threadIdx.x >> 7) - 1;  // query rows 64 * cw .. of each tile
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const float c = p.scale_log2;
    bf16* stage_o = reinterpret_cast<bf16*>(smem + C::OFF_O) + cw * 64 * C::OLD;
    // issue turns, round robin: consumer cw waits at barrier 4 + cw, then
    // lets the next one go (barriers 1..NCW order each consumer's epilogue)
    auto my_turn = [&]() { named_bar_sync(4 + cw, 256); };
    auto next_turn = [&]() { named_bar_arrive(4 + (cw + 1) % NCW, 256); };
    if (cw == NCW - 1) next_turn();  // consumer 0 issues first
    int it = 0;  // K/V tiles consumed so far
    for (int ti = 0, tile = blockIdx.x; tile < p.tiles; ++ti, tile += gridDim.x) {
      // this consumer's sequence (bi, hi) and the position of its first row
      const int seq = tile / p.q_tiles;
      const long long bi = seq / p.heads, hi = seq % p.heads;
      const int row0 = (tile % p.q_tiles) * C::BQ + cw * 64;
      // GATE: this thread's rows' gates, loaded now and used in the epilogue
      float gate[2] = {0.f, 0.f};
      if (GATE) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pos = row0 + warp * 16 + g + 8 * h;
          if (pos < n) gate[h] = rbf(p.gates[(bi * n + pos) * p.gate_ld + hi]);
        }
      }
      const int qb = ti % C::QBUF;
      const unsigned char* q_wg = sQ + qb * C::Q_BYTES + cw * 64 * C::SW;
      float o[DH / 2], s[64], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
      float corr[2];
      uint32_t pa[32];  // P as the A fragments of P . V
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;

      // block 0: S = Q . K_0^T, then its softmax (nothing to overlap yet)
      mbar_wait(q_full + qb, (ti / C::QBUF) & 1);
      int st = it % C::STAGES;
      mbar_wait(k_full + st, (it / C::STAGES) & 1);
      my_turn();
      wgmma_fence();
      flash_qk<DH, NCW>(s, q_wg, sK + st * C::KV_BYTES);
      next_turn();
      wgmma_wait<0>();
      reg_fence(s);
      if (n_kb == 1 && lane == 0) mbar_arrive(q_empty + qb);
      flash_softmax(s, 0, n, t, c, m_run, l_run, corr);
      flash_pack(s, pa);

      for (int kb = 1; kb < n_kb; ++kb) {
        const int it_n = it + 1, sn = it_n % C::STAGES;
        mbar_wait(k_full + sn, (it_n / C::STAGES) & 1);
        mbar_wait(v_full + st, (it / C::STAGES) & 1);
        reg_fence(o);
        reg_fence(pa);
        my_turn();
        wgmma_fence();
        flash_qk<DH, NCW>(s, q_wg, sK + sn * C::KV_BYTES);
        flash_pv<DH, NCW>(o, pa, sV + st * C::KV_BYTES);
        next_turn();
        wgmma_wait<1>();  // S_kb is done; P_{kb-1} . V_{kb-1} may still run
        reg_fence(s);
        if (kb == n_kb - 1 && lane == 0) mbar_arrive(q_empty + qb);
        flash_softmax(s, kb * C::BK, n, t, c, m_run, l_run, corr);
        wgmma_wait<0>();
        reg_fence(o);
        reg_fence(pa);
        if (lane == 0) mbar_arrive(kv_empty + st);
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) o[i] *= corr[(i >> 1) & 1];
        flash_pack(s, pa);
        it = it_n;
        st = sn;
      }
      mbar_wait(v_full + st, (it / C::STAGES) & 1);
      reg_fence(o);
      reg_fence(pa);
      my_turn();
      wgmma_fence();
      flash_pv<DH, NCW>(o, pa, sV + st * C::KV_BYTES);
      next_turn();
      wgmma_wait<0>();
      reg_fence(o);
      if (lane == 0) mbar_arrive(kv_empty + st);
      ++it;

      // normalise; the rows leave through a staging tile in 16-byte chunks
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[r] = 1.0f / l;
      }
      named_bar_sync(1 + cw, 128);  // the previous tile's rows have left the staging tile
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = o[4 * j + 2 * h] * inv[h], v1 = o[4 * j + 2 * h + 1] * inv[h];
          if (GATE) {
            v0 = rbf(v0) * gate[h];
            v1 = rbf(v1) * gate[h];
          }
          *reinterpret_cast<uint32_t*>(stage_o + (warp * 16 + g + 8 * h) * C::OLD + 8 * j + 2 * t) =
              pack_bf16x2(v0, v1);
        }
      named_bar_sync(1 + cw, 128);
      bf16* og = p.o + bi * p.ob + hi * p.oh;
      for (int ci = tid; ci < 64 * (DH / 8); ci += 128) {
        const int r = ci / (DH / 8), ch = ci % (DH / 8), pos = row0 + r;
        if (pos < n && ch * 8 < p.dv)
          *reinterpret_cast<uint4*>(og + (long long)pos * p.os + ch * 8) =
              *reinterpret_cast<const uint4*>(stage_o + r * C::OLD + ch * 8);
      }
    }
  }
}

// host: the (sequence, BQ-query) tiles of a launch over batch x heads
// sequences of n rows
template <int DH, int NCW>
inline long long flash_tiles(long long batch, int heads, int n) {
  return batch * heads * ((n + FlashCfg<DH, NCW>::BQ - 1) / FlashCfg<DH, NCW>::BQ);
}

// host: the three tensor maps (rank 4: dims (d, s, h, b); rank 3: (d, s, bh);
// byte strides of dims 1..rank-1) and the persistent launch, one block per SM
template <int DH, int NCW, bool GATE = false>
inline int launch_flash_wgmma(FlashArgs a, const void* q, const void* k, const void* v,
                              const uint64_t* dims, const uint64_t* qs, const uint64_t* ks,
                              const uint64_t* vs, int batch, cudaStream_t stream) {
  using C = FlashCfg<DH, NCW>;
  const uint32_t box_q[4] = {(uint32_t)C::BOX, (uint32_t)C::BQ, 1, 1};
  const uint32_t box_kv[4] = {(uint32_t)C::BOX, (uint32_t)C::BK, 1, 1};
  CUtensorMap tq, tk, tv;
  int rc = make_tmap_bf16(&tq, q, a.rank, dims, qs, box_q, C::SW);
  if (rc == 0) rc = make_tmap_bf16(&tk, k, a.rank, dims, ks, box_kv, C::SW);
  if (rc == 0) rc = make_tmap_bf16(&tv, v, a.rank, dims, vs, box_kv, C::SW);
  if (rc != 0) return rc;
  a.q_tiles = (a.n + C::BQ - 1) / C::BQ;
  const long long tiles = flash_tiles<DH, NCW>(batch, a.heads, a.n);
  const int sms = sm_count();
  if (tiles < 1 || tiles > 0x7fffffffLL || sms < 1) return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  const int grid = (int)(tiles < sms ? tiles : sms);
  auto kernel = flash_wgmma_kernel<DH, NCW, GATE>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace sesa
