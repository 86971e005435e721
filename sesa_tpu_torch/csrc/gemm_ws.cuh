// A persistent, warp-specialised tensor-core GEMM with a fused epilogue: the
// two products of K2 (ff.cu), K1's projection and out products
// (attention.cu) and K6's up and down products (apollo_conv.cu):
//   C[M, N] = epilogue( A[M, K] . B[N, K]^T )
// B keeps the torch (out_features, in_features) layout, so both operands are
// K-contiguous and read by TMA as 64-wide K slices with the 128-byte swizzle.
//
// Epilogues (f32, the rounding points of the TPU kernels):
//   WS_BIAS_GELU  C = bf16(gelu_tanh(acc + bias))
//   WS_BIAS_SILU  C = bf16(silu(acc + bias))  (silu_fast)
//   WS_RESID      C = bf16(bf16((acc + bias) * out_scale) + resid)
//   WS_QKV_ROPE   C = bf16(acc), with rope in bf16 arithmetic on the q and k
//                 columns (< rope_cols) at position row % seq_len, on the
//                 rounded values as they leave; no bias
//   WS_OUT        C = bf16(bf16(acc) + resid), or bf16(acc) when resid is
//                 null; no bias, no scale
//
// Design. One block of 384 threads per SM walks over 128 x 128 output tiles
// with a static stride (tile, tile + grid, ...). Tile i is row block
// i / n_tiles and column block i % n_tiles, and the grid is a multiple of
// n_tiles, so each block keeps one column block and walks along M; the
// blocks of one row block run at about the same time, so A is read from
// device memory once and then from L2. Warpgroup 0 is the producer: one
// thread loads the k-steps of the block's tiles, in order, into a ring of
// stages (TMA, mbarriers). Warpgroups 1 and 2 are consumers in ping-pong:
// the block's tiles 0, 2, 4, ... go to the first and 1, 3, 5, ... to the
// second, so one warpgroup's epilogue (bias, activation, residual, stores)
// runs while the other's wgmmas do; at K 384-512 a tile has only 6-8
// k-steps, and the epilogue is as long as the main loop. The main loops
// take turns (`turn` barriers): a consumer starts a tile's main loop when
// the other has seen the last stage of the previous tile arrive, so the two
// wait on the ring's stages in ring order (a parity wait cannot tell a phase
// from the one two phases on). A consumer keeps one k-step of wgmmas in
// flight (wait_group 1) and releases a stage as soon as the k-step that read
// it is done. setmaxnreg moves registers from the producer (40) to the
// consumers (232): each holds a 128 x 128 f32 accumulator, 128 registers a
// thread.
//
// At 128 x 128 tiles each k-step brings 32 KB from L2 for 2.1 MFLOP, which
// bounds the main loop by L2 bandwidth, not the tensor cores. With K <= 512
// (the up product) the block's 128 x K slice of B (at most 128 KB) is
// loaded once and stays in shared memory (RES), so only A streams: half the
// bytes per k-step.
//
// Ragged M and N: TMA fills rows past M or N with zeros and the stores are
// masked; K must be a multiple of 64 and N a multiple of 8 (checked by the
// host).
#pragma once

#include "hopper.cuh"

namespace sesa {

enum WsEpilogue { WS_BIAS_GELU = 0, WS_BIAS_SILU = 1, WS_RESID = 2, WS_QKV_ROPE = 3,
                  WS_OUT = 4 };

__host__ __device__ constexpr bool ws_has_bias(int epi) { return epi <= WS_RESID; }

struct WsArgs {
  const bf16* bias;   // (N,), the epilogues with a bias
  const bf16* resid;  // (M, N), WS_RESID; WS_OUT: or null
  bf16* C;            // (M, N)
  int M, N, K, n_tiles, tiles;
  float out_scale;
  // WS_QKV_ROPE: tables (seq_len, rot_w) or null (no rope); dim_head a power
  // of 2; the q and k columns are those below rope_cols
  const bf16* cos_t;
  const bf16* sin_t;
  int seq_len, rot_w, dim_head, rope_cols;
};

constexpr int WS_BM = 128, WS_BN = 128, WS_BK = 64;
constexpr int WS_SLICE_BYTES = 128 * WS_BK * 2;  // one k-step of A or of B: 16 KB
constexpr int WS_KT_RES = 8;                     // k-steps of a resident B slice: K <= 512
// a staging tile holds 64 rows of 256 bytes (half a consumer's tile); 16-byte
// chunk ch of row r sits at chunk ch ^ (r % 8), so that neither the rows a
// warp writes nor the chunks it reads share a bank
constexpr int WS_C_BYTES = 64 * WS_BN * 2;

template <bool RES>
struct WsLayout {
  static constexpr int STAGES = RES ? 4 : 5;
  static constexpr int STAGE_BYTES = RES ? WS_SLICE_BYTES : 2 * WS_SLICE_BYTES;  // A (+ B)
  static constexpr int OFF_RING = RES ? WS_KT_RES * WS_SLICE_BYTES : 0;  // B slice first
  static constexpr int OFF_C = OFF_RING + STAGES * STAGE_BYTES;
  static constexpr int OFF_BAR = OFF_C + 2 * WS_C_BYTES;
  static constexpr int SMEM = OFF_BAR + 8 * (2 * STAGES + 3) + 1024;  // + alignment slack
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// x * sigmoid(x) with the fast exp and divide: a few f32 ulps from x / (1 +
// exp(-x)) divided to IEEE precision, far below the bf16 rounding that follows
__device__ __forceinline__ float silu_fast(float x) { return __fdividef(x, 1.0f + __expf(-x)); }

// WS_QKV_ROPE: the offset in its head of a 16-byte chunk of 8 columns from
// col that the rope reaches (q and k columns, offsets below rot_w), else -1
__device__ __forceinline__ int ws_rope_offset(int col, const WsArgs& p) {
  if (p.cos_t == nullptr || col >= p.rope_cols) return -1;
  const int d = col & (p.dim_head - 1);
  return d < p.rot_w ? d : -1;
}

// the cos and sin pairs of the chunk's interleaved (even, odd) column pairs
// at offset d of row `row` (sequence position row % seq_len)
__device__ __forceinline__ void ws_rope_load(uint32_t (&cw)[4], uint32_t (&sw)[4], int row, int d,
                                             const WsArgs& p) {
  const int idx = (row % p.seq_len) * p.rot_w + d;  // even: 4-byte loads
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (d + 2 * e < p.rot_w) {
      cw[e] = *reinterpret_cast<const uint32_t*>(p.cos_t + idx + 2 * e);
      sw[e] = *reinterpret_cast<const uint32_t*>(p.sin_t + idx + 2 * e);
    }
  }
}

// rope on the chunk's bf16 pairs in bf16 arithmetic, as the TPU kernel:
// y = bf16(bf16(x * cos) + bf16(rotate_half(x) * sin))
__device__ __forceinline__ void ws_rope_apply(uint4& v, const uint32_t (&cw)[4],
                                              const uint32_t (&sw)[4], int d, const WsArgs& p) {
  uint32_t* vp = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (d + 2 * e >= p.rot_w) continue;
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vp + e));
    const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&cw[e]));
    const float2 sn = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&sw[e]));
    vp[e] = pack_bf16x2(rbf(rbf(x.x * c.x) + rbf(-x.y * sn.x)),
                        rbf(rbf(x.y * c.y) + rbf(x.x * sn.y)));
  }
}

// element offset of (row r, even column c) in a staging tile
__device__ __forceinline__ int ws_c_off(int r, int c) {
  return r * WS_BN + ((((c >> 3) ^ r) & 7) | (c >> 3 & ~7)) * 8 + (c & 7);
}

// the bias pairs of this thread's columns 8j + 2t (+1), j < 16; loaded
// before any store, which the compiler could not move them across
__device__ __forceinline__ void ws_load_bias(float2 (&b)[WS_BN / 8], int t, int n0,
                                             const WsArgs& p) {
#pragma unroll
  for (int j = 0; j < WS_BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    b[j] = col < p.N
               ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.bias + col))
               : make_float2(0.f, 0.f);
  }
}

// one 64 x 128 half of a consumer's accumulator (rows 16 * warp + g (+8))
// into the staging tile, with the bias and activation applied in f32
template <int EPI>
__device__ __forceinline__ void ws_stage_half(const float (&acc)[64], const float2 (&b)[WS_BN / 8],
                                              bf16* tile, int warp, int g, int t,
                                              const WsArgs& p) {
#pragma unroll
  for (int j = 0; j < WS_BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (ws_has_bias(EPI)) {
        v0 += b[j].x;
        v1 += b[j].y;
      }
      if (EPI == WS_BIAS_GELU) {
        v0 = gelu_tanh(v0);
        v1 = gelu_tanh(v1);
      } else if (EPI == WS_BIAS_SILU) {
        v0 = silu_fast(v0);
        v1 = silu_fast(v1);
      } else if (EPI == WS_RESID && p.out_scale != 1.0f) {
        v0 *= p.out_scale;
        v1 *= p.out_scale;
      }
      *reinterpret_cast<uint32_t*>(tile + ws_c_off(16 * warp + g + 8 * h, 8 * j + 2 * t)) =
          pack_bf16x2(v0, v1);
    }
  }
}

// the staging tile's 64 rows out to rows m0.. of C in coalesced 16-byte
// chunks, eight a thread in two batches of four; WS_RESID adds the
// residual, WS_OUT where it has one, WS_QKV_ROPE ropes the bf16 values
// (here, where a warp's table loads are whole rows, and not in
// ws_stage_half, where they were scattered over eight rows). A batch's
// loads all come before its stores, which the loads could otherwise not
// pass.
template <int EPI>
__device__ __forceinline__ void ws_store_half(const bf16* tile, int tid, int m0, int n0,
                                              const WsArgs& p) {
  constexpr int BATCH = 4, PER = 64 * (WS_BN / 8) / 128;
  const int ncols = min(WS_BN, p.N - n0);
  const bool resid = EPI == WS_RESID || (EPI == WS_OUT && p.resid != nullptr);
#pragma unroll
  for (int b0 = 0; b0 < PER; b0 += BATCH) {
    uint4 v[BATCH], x[BATCH];
    uint32_t cw[BATCH][4], sw[BATCH][4];
    bool ok[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int c = tid + 128 * (b0 + i), r = c / (WS_BN / 8), c8 = (c % (WS_BN / 8)) * 8;
      ok[i] = m0 + r < p.M && c8 < ncols;
      v[i] = *reinterpret_cast<const uint4*>(tile + ws_c_off(r, c8));
      if (resid && ok[i])
        x[i] = *reinterpret_cast<const uint4*>(p.resid + (size_t)(m0 + r) * p.N + n0 + c8);
      if (EPI == WS_QKV_ROPE) {
        const int d = ws_rope_offset(n0 + c8, p);
        if (d >= 0 && ok[i]) ws_rope_load(cw[i], sw[i], m0 + r, d, p);
      }
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int c = tid + 128 * (b0 + i), r = c / (WS_BN / 8), c8 = (c % (WS_BN / 8)) * 8;
      if (!ok[i]) continue;
      if (EPI == WS_QKV_ROPE) {
        const int d = ws_rope_offset(n0 + c8, p);
        if (d >= 0) ws_rope_apply(v[i], cw[i], sw[i], d, p);
      }
      if (resid) {  // bf16(y) + x, rounded: the TPU kernel's residual add
        uint32_t* vp = reinterpret_cast<uint32_t*>(&v[i]);
        const uint32_t* xp = reinterpret_cast<const uint32_t*>(&x[i]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vp + e));
          const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xp + e));
          vp[e] = pack_bf16x2(a.x + y.x, a.y + y.y);
        }
      }
      *reinterpret_cast<uint4*>(p.C + (size_t)(m0 + r) * p.N + n0 + c8) = v[i];
    }
  }
}

template <int EPI, bool RES>
__global__ void __launch_bounds__(384, 1)
gemm_ws_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
               const WsArgs p) {
  using L = WsLayout<RES>;
  extern __shared__ unsigned char ws_smem_raw[];
  // swizzled tiles start on 1024-byte boundaries
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(ws_smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = smem + L::OFF_RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* empty = full + L::STAGES;
  uint64_t* turn = empty + L::STAGES;  // turn[c]: all stages of consumer c's tile arrived
  uint64_t* b_full = turn + 2;         // RES: the resident B slice arrived

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < L::STAGES; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 4);  // the four warps of the consumer that read the stage
    }
    mbar_init(turn, 4);
    mbar_init(turn + 1, 4);
    mbar_init(b_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int KT = p.K / WS_BK;
  if (threadIdx.x < 128) {
    // ---- producer ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      tma_prefetch(&ta);
      tma_prefetch(&tb);
      if (RES && (int)blockIdx.x < p.tiles) {  // the block's column block of B, once
        mbar_expect_tx(b_full, KT * WS_SLICE_BYTES);
        for (int kt = 0; kt < KT; ++kt)
          tma_load_2d(smem + kt * WS_SLICE_BYTES, &tb, b_full, kt * WS_BK,
                      (blockIdx.x % p.n_tiles) * WS_BN);
      }
      int it = 0;  // k-steps loaded so far
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int m0 = (tile / p.n_tiles) * WS_BM, n0 = (tile % p.n_tiles) * WS_BN;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int st = it % L::STAGES;
          unsigned char* sa = ring + st * L::STAGE_BYTES;
          mbar_wait(empty + st, ((it / L::STAGES) & 1) ^ 1);
          mbar_expect_tx(full + st, L::STAGE_BYTES);
          tma_load_2d(sa, &ta, full + st, kt * WS_BK, m0);
          if (!RES) tma_load_2d(sa + WS_SLICE_BYTES, &tb, full + st, kt * WS_BK, n0);
        }
      }
    }
  } else {
    // ---- consumers, in ping-pong over the block's tiles ----
    setmaxnreg_inc<232>();
    const int cw = (threadIdx.x >> 7) - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    bf16* tile_c = reinterpret_cast<bf16*>(smem + L::OFF_C + cw * WS_C_BYTES);
    float acc0[64], acc1[64];  // rows 0-63 and 64-127 of the tile
    if (RES && (int)blockIdx.x < p.tiles) mbar_wait(b_full, 0);
    for (int j = 0, local = cw, tile = blockIdx.x + cw * gridDim.x; tile < p.tiles;
         ++j, local += 2, tile += 2 * gridDim.x) {
      const int m0 = (tile / p.n_tiles) * WS_BM, n0 = (tile % p.n_tiles) * WS_BN;
      int it = local * KT;  // this tile's first k-step in the block's ring order
      // the stages of the block's tile local - 1 (the other consumer's) have
      // arrived: the other consumer's j-th (cw 1) or (j-1)-th (cw 0) turn
      if (local > 0) mbar_wait(turn + (cw ^ 1), (cw == 0 ? j - 1 : j) & 1);
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int st = it % L::STAGES;
        const unsigned char* sa = ring + st * L::STAGE_BYTES;
        mbar_wait(full + st, (it / L::STAGES) & 1);
        // every stage of this tile has arrived: the other consumer may start
        // waiting on the stages after them
        if (kt == KT - 1 && lane == 0) mbar_arrive(turn + cw);
        const uint64_t da0 = desc_kmajor<128>(sa), da1 = desc_kmajor<128>(sa + 64 * 128);
        const uint64_t db =
            desc_kmajor<128>(RES ? smem + kt * WS_SLICE_BYTES : sa + WS_SLICE_BYTES);
        reg_fence(acc0);
        reg_fence(acc1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WS_BK / 16; ++kk) {  // +32 bytes per k16 step
          wgmma_ss_m64n128k16(acc0, da0 + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
          wgmma_ss_m64n128k16(acc1, da1 + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous k-step's wgmmas are done: release its stage
        reg_fence(acc0);
        reg_fence(acc1);
        if (kt > 0 && lane == 0) mbar_arrive(empty + (it - 1) % L::STAGES);
      }
      wgmma_wait<0>();
      reg_fence(acc0);
      reg_fence(acc1);
      if (lane == 0) mbar_arrive(empty + (it - 1) % L::STAGES);

      // epilogue, one 64-row half at a time: bias and activation into the
      // staging tile, then out in row chunks
      float2 bias[WS_BN / 8];
      if (ws_has_bias(EPI)) ws_load_bias(bias, t, n0, p);
      named_bar_sync(1 + cw, 128);  // the previous half has left the staging tile
      ws_stage_half<EPI>(acc0, bias, tile_c, warp, g, t, p);
      named_bar_sync(1 + cw, 128);
      ws_store_half<EPI>(tile_c, tid, m0, n0, p);
      named_bar_sync(1 + cw, 128);
      ws_stage_half<EPI>(acc1, bias, tile_c, warp, g, t, p);
      named_bar_sync(1 + cw, 128);
      ws_store_half<EPI>(tile_c, tid, m0 + 64, n0, p);
    }
  }
}

// host: the dynamic shared memory of a launch at depth K
inline int ws_smem_bytes(int K) {
  return K <= WS_KT_RES * WS_BK ? WsLayout<true>::SMEM : WsLayout<false>::SMEM;
}

// host: the tensor maps of A (M, K) and B (N, K), both row-major bf16, and
// the persistent launch of `grid` blocks (one per SM), a multiple of the
// column blocks; B stays resident when K <= 512
template <int EPI>
inline int launch_gemm_ws(const bf16* A, const bf16* B, WsArgs p, int grid, cudaStream_t stream) {
  p.n_tiles = (p.N + WS_BN - 1) / WS_BN;
  if (p.K % WS_BK || p.N % 8 || p.M < 1 || p.N < 1 || grid < 1 || grid % p.n_tiles)
    return (int)cudaErrorInvalidValue;
  const uint64_t dims_a[2] = {(uint64_t)p.K, (uint64_t)p.M};
  const uint64_t dims_b[2] = {(uint64_t)p.K, (uint64_t)p.N};
  const uint64_t strides[1] = {(uint64_t)p.K * 2};
  const uint32_t box[2] = {(uint32_t)WS_BK, (uint32_t)WS_BM};
  CUtensorMap ta, tb;
  int rc = make_tmap_bf16(&ta, A, 2, dims_a, strides, box, 128);
  if (rc == 0) rc = make_tmap_bf16(&tb, B, 2, dims_b, strides, box, 128);
  if (rc != 0) return rc;
  const long long tiles = (long long)((p.M + WS_BM - 1) / WS_BM) * p.n_tiles;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  if (p.K <= WS_KT_RES * WS_BK) {
    cudaFuncSetAttribute(gemm_ws_kernel<EPI, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         WsLayout<true>::SMEM);
    gemm_ws_kernel<EPI, true><<<grid, 384, WsLayout<true>::SMEM, stream>>>(ta, tb, p);
  } else {
    cudaFuncSetAttribute(gemm_ws_kernel<EPI, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         WsLayout<false>::SMEM);
    gemm_ws_kernel<EPI, false><<<grid, 384, WsLayout<false>::SMEM, stream>>>(ta, tb, p);
  }
  return (int)cudaGetLastError();
}

}  // namespace sesa
