// The attention core of K4 (conformer_attention.cu) for sequences longer
// than 64 (the mel-band conformer's time leg, n 690):
//   softmax((q . k^T + q . E[clip(i - j, -P, P) + P]) * scale) . v
// per (sequence, head), with E the Shaw relative-position table, on the
// persistent TMA / wgmma pipeline of flash_wgmma.cuh, whose P . V product,
// softmax and packing it reuses. One persistent block per SM walks over
// (sequence, 128-query) tiles.
//
// The expanded table. The wrapper builds on the device, once per call, the
// table T of 2 * n_pad rows (n_pad = n rounded up to 128) with row r =
// E[clip(r - (n_pad - 1), -P, P) + P]: the row of distance i - j is
// i - j + n_pad - 1. The distances of a query tile q0.. (128 rows) and a key
// tile k0.. (128 keys) then form one run of rows, q0 - k0 + n_pad - 128 ..
// + 255, which one TMA box brings beside K; nothing is clipped in the kernel.
//
// Roles (3 warpgroups):
//   warpgroup 0, the producer: one thread loads a tile's Q once (`q_full`,
//     refilled when both consumers have issued their last product from it,
//     `q_empty`) and keeps a ring of 2 stages of (K, table box) and V of 128
//     keys in flight (`k_full`, `v_full`, `kv_empty`).
//   warpgroups 1 and 2, the consumers: each owns 64 of the tile's query rows,
//     holds them as wgmma A fragments in registers (ldmatrix from the
//     swizzled tile, once a tile: the products then read only their B
//     operands from shared memory, whose bandwidth the skew below competes
//     for) and, per key tile,
//     1. QE = Q . T_box^T over the 192 table rows its own distances reach
//        (box rows 64 * consumer ..; wgmma m64n192), f32;
//     2. writes QE to shared memory: each warp only the 144 columns its 16
//        rows reach (16 * warp .. + 143), into a tile of its own, so the
//        write and the skewed read below need no more than __syncwarp;
//     3. S = Q . K^T together with O += P . V of the previous key tile;
//     4. adds qE[a][a - c + 127] to S[a][c] in f32 before the scale, as the
//        TPU kernel adds its rolled q . E_exp^T (sesa_tpu/ops/attention.py
//        _conformer_attn_kernel), while the P . V product runs;
//     5. the online softmax of flash_wgmma.cuh (f32, keys >= n masked, the
//        probabilities rounded to bf16 unnormalised) and the P fragments.
//
// Shared memory is the constraint: the q.E tiles take 76 KB (eight warps x
// 16 rows x 152 f32), so a tile has two consumers (K3 has three), Q one
// buffer and K, V and the table box two stages: 226,368 bytes at dim_head 64.
// The output leaves through a staging tile that reuses the first warp's
// q.E tile of its consumer. dim_head 128 (two 64-wide boxes, twice the
// table box) does not fit and runs conformer_attention.cu's mma.sync core.
#pragma once

#include "flash_wgmma.cuh"

namespace sesa {

template <int DH>
struct ShawCfg {
  static_assert(DH == 32 || DH == 64, "dim_head 32 or 64");
  static constexpr int NCW = 2;                 // consumer warpgroups, 64 query rows each
  static constexpr int BQ = 64 * NCW, BK = 128;  // query rows per tile, keys per K/V tile
  static constexpr int ER = BQ + BK;            // table rows of a box (BQ + BK - 1 used)
  static constexpr int THREADS = 128 * (NCW + 1);
  static constexpr int STAGES = 2;
  static constexpr int SW = DH == 64 ? 128 : 64;  // bytes per row of a TMA box (the swizzle)
  static constexpr int BOX = SW / 2;              // bf16 columns per box: DH
  static constexpr int Q_BYTES = BQ * DH * 2, KV_BYTES = BK * DH * 2, E_BYTES = ER * DH * 2;
  // a warp's q.E tile: 16 rows of 144 columns (the distances its rows reach
  // for 128 keys: 16 + 127) at a row stride of 152 f32, which keeps its
  // 8-byte writes free of bank conflicts (the skewed reads take two phases)
  static constexpr int QE_COLS = 144, QE_LD = 152;
  static constexpr int QE_WARP_BYTES = 16 * QE_LD * 4;
  static constexpr int OLD = DH + 8;  // row stride of the output staging tile, elements
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_E = OFF_V + STAGES * KV_BYTES;
  static constexpr int OFF_QE = OFF_E + STAGES * E_BYTES;
  static constexpr int OFF_BAR = OFF_QE + 4 * NCW * QE_WARP_BYTES;
  static constexpr int NBARS = 2 + 3 * STAGES;
  static constexpr int SMEM = OFF_BAR + 8 * NBARS + 1024;  // + alignment slack
  static_assert(SMEM <= 232448, "shared memory of one block");
  static_assert(64 * OLD * 2 <= QE_WARP_BYTES, "the staging tile fits a warp's q.E tile");
  static_assert(FlashCfg<DH, NCW>::SW == SW && FlashCfg<DH, NCW>::BK == BK,
                "flash_wgmma.cuh's P . V product reads these tiles");
};

struct ShawArgs {
  bf16* o;
  long long ob, oh, os;  // output strides in elements: batch, head, row
  int heads, n, n_pad, q_tiles, tiles;
  float scale_log2;  // scale * log2(e), > 0
};

// this thread's A fragments of the consumer's Q rows (k16 step kk: rows
// 16 * warp + g (+8), columns 16 kk + 2t (+8)), by ldmatrix from the TMA's
// swizzled tile (16-byte chunk c of row r at chunk c ^ (r % 8) with the
// 128-byte swizzle, c ^ ((r / 2) % 4) with the 64-byte one)
template <int DH>
__device__ __forceinline__ void shaw_q_frags(uint32_t (&qf)[DH / 16][4], const unsigned char* q,
                                             int warp, int lane) {
  constexpr int SW = ShawCfg<DH>::SW;
  const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int swz = SW == 128 ? row & 7 : (row >> 1) & 3;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int chunk = 2 * kk + (lane >> 4);
    ldmatrix_x4(qf[kk], reinterpret_cast<const bf16*>(q + row * SW + ((chunk ^ swz) << 4)));
  }
}

// S[64 x 128] = Q . K^T with Q from registers, K K-major in shared memory
template <int DH>
__device__ __forceinline__ void shaw_qk(float (&s)[64], const uint32_t (&qf)[DH / 16][4],
                                        const unsigned char* k) {
  constexpr int SW = ShawCfg<DH>::SW;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_rs_kmajor_m64n128k16(s, qf[kk], desc_kmajor<SW>(k) + 2 * kk, kk > 0);
  wgmma_commit();
}

// QE[64 x 192] = Q[64 x DH] . T[192 x DH]^T for one consumer warpgroup, Q
// from registers, e its first table row (K-major)
template <int DH>
__device__ __forceinline__ void shaw_qe(float (&qe)[96], const uint32_t (&qf)[DH / 16][4],
                                        const unsigned char* e) {
  constexpr int SW = ShawCfg<DH>::SW;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)  // +32 bytes per k16 step
    wgmma_rs_kmajor_m64n192k16(qe, qf[kk], desc_kmajor<SW>(e) + 2 * kk, kk > 0);
  wgmma_commit();
}

// this warp's rows of QE (16 * warp + g (+8)) into its tile: column m of
// QE, for m in 16 * warp .. + 143, to column m - 16 * warp. The register
// index is static, the warp's window a predicate.
__device__ __forceinline__ void shaw_qe_store(const float (&qe)[96], float* tile, int warp,
                                              int g, int t) {
  constexpr int LD = ShawCfg<64>::QE_LD, COLS = ShawCfg<64>::QE_COLS;
#pragma unroll
  for (int jj = 0; jj < 24; ++jj) {
    const int q = jj - 2 * warp;
    if (q >= 0 && q < COLS / 8) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(tile + (g + 8 * h) * LD + 8 * q + 2 * t) =
            make_float2(qe[4 * jj + 2 * h], qe[4 * jj + 2 * h + 1]);
    }
  }
}

// the skew: S[a][c] += QE[a][a - c + 127] for this thread's S elements (a =
// 16 * warp + g + 8h, c = 8j + 2t + e), read from its warp's tile at row g +
// 8h, column a - c + 127 - 16 * warp = g + 8h - 8j - 2t - e + 127
__device__ __forceinline__ void shaw_skew_add(float (&s)[64], const float* tile, int g, int t) {
  constexpr int LD = ShawCfg<64>::QE_LD, BK = ShawCfg<64>::BK;
  const float* base = tile + g * (LD + 1) + (BK - 1) - 2 * t;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) s[4 * j + 2 * h + e] += base[8 * h * (LD + 1) - 8 * j - e];
}

template <int DH>
__global__ void __launch_bounds__(ShawCfg<DH>::THREADS, 1)
flash_shaw_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap te,
                  const ShawArgs p) {
  using C = ShawCfg<DH>;
  extern __shared__ unsigned char fs_smem_raw[];
  // swizzled tiles start on 1024-byte boundaries
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(fs_smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;  // K and the table box of a stage
  uint64_t* v_full = k_full + C::STAGES;
  uint64_t* kv_empty = v_full + C::STAGES;
  unsigned char* sQ = smem;
  unsigned char* sK = smem + C::OFF_K;
  unsigned char* sV = smem + C::OFF_V;
  unsigned char* sE = smem + C::OFF_E;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * C::NCW);  // one arrival per consumer warp
#pragma unroll
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(k_full + st, 1);
      mbar_init(v_full + st, 1);
      mbar_init(kv_empty + st, 4 * C::NCW);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int n = p.n, n_kb = (n + C::BK - 1) / C::BK;
  if (threadIdx.x < 128) {
    // ---- producer ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      tma_prefetch(&te);
      int it = 0;  // K/V tiles loaded so far
      for (int ti = 0, tile = blockIdx.x; tile < p.tiles; ++ti, tile += gridDim.x) {
        const int seq = tile / p.q_tiles, q0 = (tile % p.q_tiles) * C::BQ;
        const int bi = seq / p.heads, hi = seq % p.heads;
        mbar_wait(q_empty, (ti & 1) ^ 1);
        mbar_expect_tx(q_full, C::Q_BYTES);
        tma_load_4d(sQ, &tq, q_full, 0, q0, hi, bi);
        for (int kb = 0; kb < n_kb; ++kb, ++it) {
          const int st = it % C::STAGES, k0 = kb * C::BK;
          mbar_wait(kv_empty + st, ((it / C::STAGES) & 1) ^ 1);
          mbar_expect_tx(k_full + st, C::KV_BYTES + C::E_BYTES);
          tma_load_4d(sK + st * C::KV_BYTES, &tk, k_full + st, 0, k0, hi, bi);
          // table rows of the distances q0 - k0 - 127 .. q0 - k0 + 127 (+1)
          tma_load_2d(sE + st * C::E_BYTES, &te, k_full + st, 0, q0 - k0 + p.n_pad - C::BK);
          mbar_expect_tx(v_full + st, C::KV_BYTES);
          tma_load_4d(sV + st * C::KV_BYTES, &tv, v_full + st, 0, k0, hi, bi);
        }
      }
    }
  } else {
    // ---- consumers ----
    setmaxnreg_inc<232>();
    const int cw = (threadIdx.x >> 7) - 1;  // query rows 64 * cw .. of each tile
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const float c = p.scale_log2;
    float* qe_tile = reinterpret_cast<float*>(smem + C::OFF_QE +
                                              (cw * 4 + warp) * C::QE_WARP_BYTES);
    bf16* stage_o = reinterpret_cast<bf16*>(smem + C::OFF_QE + cw * 4 * C::QE_WARP_BYTES);
    int it = 0;  // K/V tiles consumed so far
    for (int ti = 0, tile = blockIdx.x; tile < p.tiles; ++ti, tile += gridDim.x) {
      const int seq = tile / p.q_tiles;
      const long long bi = seq / p.heads, hi = seq % p.heads;
      const int row0 = (tile % p.q_tiles) * C::BQ + cw * 64;
      const unsigned char* q_wg = sQ + cw * 64 * C::SW;
      const int e_off = cw * 64 * C::SW;  // this consumer's 192 rows of a table box
      float o[DH / 2], s[64], qe[96], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
      float corr[2];
      uint32_t pa[32];  // P as the A fragments of P . V
      uint32_t qf[DH / 16][4];  // Q as the A fragments of Q . K^T and Q . T^T
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;

      // key tile 0: QE, its tile, S, the skew, the softmax
      mbar_wait(q_full, ti & 1);
      shaw_q_frags<DH>(qf, q_wg, warp, lane);
      int st = it % C::STAGES;
      mbar_wait(k_full + st, (it / C::STAGES) & 1);
      wgmma_fence();
      shaw_qe<DH>(qe, qf, sE + st * C::E_BYTES + e_off);
      wgmma_wait<0>();
      reg_fence(qe);
      shaw_qe_store(qe, qe_tile, warp, g, t);
      __syncwarp();
      wgmma_fence();
      shaw_qk<DH>(s, qf, sK + st * C::KV_BYTES);
      wgmma_wait<0>();
      reg_fence(s);
      if (n_kb == 1 && lane == 0) mbar_arrive(q_empty);
      shaw_skew_add(s, qe_tile, g, t);
      __syncwarp();
      flash_softmax(s, 0, n, t, c, m_run, l_run, corr);
      flash_pack(s, pa);

      for (int kb = 1; kb < n_kb; ++kb) {
        const int it_n = it + 1, sn = it_n % C::STAGES;
        mbar_wait(k_full + sn, (it_n / C::STAGES) & 1);
        wgmma_fence();
        shaw_qe<DH>(qe, qf, sE + sn * C::E_BYTES + e_off);
        wgmma_wait<0>();
        reg_fence(qe);
        shaw_qe_store(qe, qe_tile, warp, g, t);
        __syncwarp();
        mbar_wait(v_full + st, (it / C::STAGES) & 1);
        reg_fence(o);
        reg_fence(pa);
        wgmma_fence();
        shaw_qk<DH>(s, qf, sK + sn * C::KV_BYTES);
        flash_pv<DH, C::NCW>(o, pa, sV + st * C::KV_BYTES);
        wgmma_wait<1>();  // S_kb is done; P_{kb-1} . V_{kb-1} may still run
        reg_fence(s);
        if (kb == n_kb - 1 && lane == 0) mbar_arrive(q_empty);
        shaw_skew_add(s, qe_tile, g, t);
        __syncwarp();
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
      wgmma_fence();
      flash_pv<DH, C::NCW>(o, pa, sV + st * C::KV_BYTES);
      wgmma_wait<0>();
      reg_fence(o);
      if (lane == 0) mbar_arrive(kv_empty + st);
      ++it;

      // normalise; the rows leave through the staging tile in 16-byte chunks
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[r] = 1.0f / l;
      }
      named_bar_sync(1 + cw, 128);  // warp 0 has read its q.E tile, which the staging reuses
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(stage_o + (warp * 16 + g + 8 * h) * C::OLD + 8 * j + 2 * t) =
              pack_bf16x2(o[4 * j + 2 * h] * inv[h], o[4 * j + 2 * h + 1] * inv[h]);
      named_bar_sync(1 + cw, 128);
      bf16* og = p.o + bi * p.ob + hi * p.oh;
      for (int ci = tid; ci < 64 * (DH / 8); ci += 128) {
        const int r = ci / (DH / 8), ch = ci % (DH / 8), pos = row0 + r;
        if (pos < n)
          *reinterpret_cast<uint4*>(og + (long long)pos * p.os + ch * 8) =
              *reinterpret_cast<const uint4*>(stage_o + r * C::OLD + ch * 8);
      }
      named_bar_sync(1 + cw, 128);  // the rows have left before warp 0's next q.E tile
    }
  }
}

// host: the (sequence, 128-query) tiles of a launch over batch x heads
// sequences of n rows
template <int DH>
inline long long shaw_tiles(long long batch, int heads, int n) {
  return batch * heads * ((n + ShawCfg<DH>::BQ - 1) / ShawCfg<DH>::BQ);
}

// host: the four tensor maps and the persistent launch of `grid` blocks. q,
// k, v: rank-4 (d, s, h, b) maps of dims `dims` with byte strides `strides`
// of dims 1-3; the table: (2 * n_pad, DH), boxes of 256 rows
template <int DH>
inline int launch_flash_shaw(ShawArgs a, const void* q, const void* k, const void* v,
                             const void* table, const uint64_t* dims, const uint64_t* strides,
                             int batch, int grid, cudaStream_t stream) {
  using C = ShawCfg<DH>;
  const uint32_t box_q[4] = {(uint32_t)C::BOX, (uint32_t)C::BQ, 1, 1};
  const uint32_t box_kv[4] = {(uint32_t)C::BOX, (uint32_t)C::BK, 1, 1};
  const uint64_t dims_e[2] = {(uint64_t)DH, 2 * (uint64_t)a.n_pad};
  const uint64_t strides_e[1] = {(uint64_t)DH * 2};
  const uint32_t box_e[2] = {(uint32_t)C::BOX, (uint32_t)C::ER};
  CUtensorMap tq, tk, tv, te;
  int rc = make_tmap_bf16(&tq, q, 4, dims, strides, box_q, C::SW);
  if (rc == 0) rc = make_tmap_bf16(&tk, k, 4, dims, strides, box_kv, C::SW);
  if (rc == 0) rc = make_tmap_bf16(&tv, v, 4, dims, strides, box_kv, C::SW);
  if (rc == 0) rc = make_tmap_bf16(&te, table, 2, dims_e, strides_e, box_e, C::SW);
  if (rc != 0) return rc;
  a.q_tiles = (a.n + C::BQ - 1) / C::BQ;
  const long long tiles = shaw_tiles<DH>(batch, a.heads, a.n);
  if (tiles < 1 || tiles > 0x7fffffffLL || grid < 1 || grid > tiles)
    return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  auto kernel = flash_shaw_kernel<DH>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(tq, tk, tv, te, a);
  return (int)cudaGetLastError();
}

}  // namespace sesa
