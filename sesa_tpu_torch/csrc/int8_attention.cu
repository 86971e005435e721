// I8: int8 attention, the SageAttention analogue, on Hopper.
//
// Replaces no Pallas kernel: sesa_tpu/ops/attention.py sdpa_int8 is plain
// JAX (an int8 dot_general that XLA lowers to the TPU's int8 matrix path).
// It stands beside K3 as the hand-written form of the port's sdpa_int8,
// which SESA_INT8_ATTN=1 routes every roformer attention through.
//
// Arithmetic, per sequence (b, h) of n rows:
//   km = mean(k over the sequence), summed in f32, rounded to bf16;
//   kc = k - km in bf16;
//   per row of q and kc: s = max(max|x| / 127, 1e-8) in f32 and the codes
//   round_half_even(x * (1 / s)) (|code| <= 127 by construction; the
//   multiply and the reciprocal within an ulp of JAX's divides, so a code may
//   differ by one where x / s lies within an ulp of a half);
//   S = q8 . k8^T exact in s32, the scores S * ks[key] * (qs[row] * scale);
//   an online softmax in f32 (exp2 of the scores in units of log2 e: the
//   row's q scale, the softmax scale and log2 e are one factor), the
//   probabilities rounded to bf16 before the row sum is known (unnormalised;
//   the sum is taken over the f32 values), O = P . V in bf16 with f32 sums,
//   normalised in f32 by one reciprocal per row and rounded once.
// These are JAX's rounding points (sesa_tpu/ops/attention.py:62-103) but
// one: JAX rounds p after normalising, this kernel before, as K3's core does
// against its Pallas kernel (flash_wgmma.cuh), which moves a result by about
// one bf16 ulp; the plain version (ops/attention.py sdpa_int8_plain) keeps
// JAX's point. A non-finite q row gives a non-finite scale (a NaN-propagating
// max) and so a non-finite output row; a non-finite k value does the same
// to every row through the mean, as in JAX.
//
// Bound on the H100: bytes. At the flagship's legs (BH 2976 x n 690 and
// 33120 x 62, D 64) q, k, v and o are 1.05 GB, 0.31 ms at 3.35 TB/s; the
// int8 product (2 * BH * n^2 * D ops, 0.09 ms at 1979 TOPS on the time leg)
// and the bf16 P . V (0.18 ms at 989 TFLOP/s) lie below it, and so does the
// one exp2 per score on the special-function unit (1.45 G scores on the
// time leg, about 0.39 ms at 16 a clock per SM), which the design overlaps
// with the products.
//
// Design: warp-specialised persistent blocks, one per SM. A producer warp
// issues every copy by TMA into a ring of stages (mbarriers); consumer
// warpgroups of 64 query rows run S = Q8 . K8^T as wgmma m64nNk32 s8 x s8
// -> s32 (both operands K-major in shared memory, swizzled by their row of
// D bytes, the only layout 8-bit wgmma takes) and O += P . V as bf16 wgmma
// with P from registers and V MN-major, as flash_wgmma.cuh does. q, k and v
// are read through tensor maps where they lie (the roformer's strided views
// of its qkv projection as (d, s, h, b) maps, contiguous (BH, n, D) input as
// (d, s, bh)); their zero fill pads the sequence and the head to D 32, 64 or
// 128. Two routes, chosen by the host (ops/attention.py i8_plan):
// - fused, n <= 64 (the freq leg's 62 bands): one key tile holds the
//   sequence. Each stage holds one sequence's bf16 q, k and v; one consumer
//   takes the k mean, the k codes and scales and the q codes and scales in
//   shared memory, then both products. No code reaches device memory: q, k,
//   v are read once and o written once.
// - tiles, n > 64: a pre-pass (i8_prepass_kernel, a cluster of four blocks
//   per sequence that reads k once) writes k's codes and scales as the
//   images of the attention kernel's key tiles (128 keys, swizzled), which
//   its producer brings with one bulk copy each beside the V tile. A tile of 64 x NCW query rows (q's bf16 once,
//   quantised by each consumer into its own int8 tile in the prologue) walks
//   over the key tiles with flash_wgmma.cuh's overlap: S_j and P_{j-1} . V
//   are issued together, the softmax of S_j runs while P . V is in flight,
//   and the consumers take turns to issue.
#include <cooperative_groups.h>

#include "hopper.cuh"

using namespace sesa;
namespace cg = cooperative_groups;

namespace {

constexpr int BQ = 64;           // query rows per consumer warpgroup
constexpr int FUSED_MAX_N = 64;  // the fused route's one key tile
constexpr int BK = 128;          // keys per tile of the tiles route
constexpr int PRE_THREADS = 256;
// the pre-pass: blocks of a sequence's cluster, and the most shared memory a
// block keeps its rows in (four blocks an SM)
constexpr int PRE_CLUSTER = 4;
constexpr int PRE_STAGE_MAX = 49152;

// the parts both routes share at head width DH
template <int DH>
struct I8Common {
  static constexpr int NCW = DH == 128 ? 2 : 3;  // consumer warpgroups
  static constexpr int THREADS = 128 * (NCW + 1);
  static constexpr int PRODUCER_REGS = NCW == 3 ? 24 : 40, CONSUMER_REGS = NCW == 3 ? 160 : 232;
  static constexpr int SW = DH >= 64 ? 128 : 64;  // bytes per row of a bf16 box (its swizzle)
  static constexpr int BOX = SW / 2;              // bf16 columns per box
  static constexpr int NBOX = DH / BOX;           // boxes across a row of DH
  static constexpr int Q8_BYTES = BQ * DH;        // one consumer's int8 tile of 64 rows
  static constexpr int OLD = DH + 8;              // output staging row, elements
  static constexpr int O_BYTES = BQ * OLD * 2;
};

// shared memory of the fused route: STAGES x (q, k, v of one sequence), then
// per consumer its Q8 and K8 tiles and output staging, then per consumer its
// floats (q scales, k scales, k mean, the mean's partial sums), the barriers
template <int DH>
struct FusedCfg : I8Common<DH> {
  using B = I8Common<DH>;
  // as many stages as fit beside the consumers' tiles: NCW of them are being
  // computed on while the rest load
  static constexpr int STAGES = DH == 128 ? 3 : DH == 64 ? 6 : 8;
  static constexpr int TILE = FUSED_MAX_N * DH * 2;  // one of q, k, v
  static constexpr int STAGE = 3 * TILE;
  static constexpr int OFF_C = STAGES * STAGE;
  static constexpr int C_TILES = 2 * B::Q8_BYTES + B::O_BYTES;
  static constexpr int OFF_F = OFF_C + B::NCW * C_TILES;
  static constexpr int C_FLOATS = BQ + FUSED_MAX_N + DH + 4 * DH;
  static constexpr int OFF_BAR = OFF_F + B::NCW * C_FLOATS * 4;
  static constexpr int SMEM = OFF_BAR + 8 * 2 * STAGES + 1024;  // + alignment slack
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// shared memory of the tiles route: QBUF bf16 Q tiles of 64 x NCW rows, the
// key stages (codes, then V), per consumer its Q8 tile and output staging,
// the key scales of each stage, per consumer its q scales, the barriers
template <int DH>
struct TilesCfg : I8Common<DH> {
  using B = I8Common<DH>;
  static constexpr int BQT = BQ * B::NCW;  // query rows per tile
  static constexpr int STAGES = DH == 128 ? 2 : 3;
  static constexpr int QBUF = DH == 128 ? 1 : 2;
  static constexpr int Q_BYTES = BQT * DH * 2, KC_BYTES = BK * DH, KS_BYTES = BK * 4;
  static constexpr int V_BYTES = BK * DH * 2;
  static constexpr int OFF_KC = QBUF * Q_BYTES;
  static constexpr int OFF_V = OFF_KC + STAGES * KC_BYTES;
  static constexpr int OFF_C = OFF_V + STAGES * V_BYTES;
  static constexpr int C_TILES = B::Q8_BYTES + B::O_BYTES;
  static constexpr int OFF_KS = OFF_C + B::NCW * C_TILES;
  static constexpr int OFF_QS = OFF_KS + STAGES * KS_BYTES;
  static constexpr int OFF_BAR = OFF_QS + B::NCW * BQ * 4;
  static constexpr int NBARS = 2 * QBUF + 3 * STAGES;
  static constexpr int SMEM = OFF_BAR + 8 * NBARS + 1024;  // + alignment slack
  static_assert(SMEM <= 232448, "shared memory of one block");
};

struct I8Args {
  bf16* o;
  long long ob, oh, os;  // output strides in elements: batch, head, row
  int heads, n;
  int units;    // fused: sequences; tiles: (sequence, 64 x NCW queries) tiles
  int q_tiles;  // tiles: query tiles per sequence
  int n_kt;     // tiles: key tiles per sequence
  int rank;     // of the tensor maps: 4 (d, s, h, b) or 3 (d, s, bh)
  int dv;       // the columns of o that are stored (the maps' innermost dim)
  float scale_log2;  // scale * log2(e), > 0
  const unsigned char* codes;  // tiles: the pre-pass's key tile images
  const float* kscales;        // tiles: their key scales
};

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;  // NaN in a propagates; b's is kept below
}

// byte offset of 16-byte chunk `ch` (8 bf16 columns) of row `row` of a bf16
// tile as TMA writes it: NBOX boxes of `rows` rows of SW bytes, swizzled
template <int DH>
__device__ __forceinline__ int bf16_chunk(int row, int ch, int rows) {
  constexpr int SW = I8Common<DH>::SW, CPB = SW / 16;
  const int x = SW == 128 ? (row & 7) : ((row >> 1) & 3);
  return (ch / CPB) * rows * SW + row * SW + (((ch % CPB) ^ x) << 4);
}

// byte offset of 16-byte chunk `c` of row `row` of an int8 tile of DH-byte
// rows swizzled by DH bytes (what desc_kmajor<DH> reads)
template <int DH>
__device__ __forceinline__ int s8_chunk(int row, int c) {
  const int x = DH == 128 ? (row & 7) : DH == 64 ? ((row >> 1) & 3) : ((row >> 2) & 1);
  return row * DH + ((c ^ x) << 4);
}

// x * inv rounded half to even, in the low byte of the result: 1.5 * 2^23
// puts the units in the last place (|x * inv| <= 127)
__device__ __forceinline__ uint32_t code_bits(float x, float inv) {
  return __float_as_uint(fmaf(x, inv, 12582912.0f));
}
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// the scale of a row of values whose NaN-propagating max |x| is amax (one
// multiply for JAX's divide by 127: within an ulp)
__device__ __forceinline__ float row_scale(float amax) {
  return nan_max(amax * (1.0f / 127.0f), 1e-8f);
}

// The codes and scales of 64 rows [row0, row0 + 64) of a bf16 tile of
// `rows` rows per box into the int8 tile dst (64 rows) and sc[64], by the
// 128 threads of a warpgroup; with CENTER each value is first less km[col],
// rounded to bf16 (k's centring).
template <int DH, bool CENTER>
__device__ __forceinline__ void quantise_rows(const unsigned char* src, int rows, int row0,
                                              const float* km, unsigned char* dst, float* sc,
                                              int tid) {
  constexpr int TPR = DH / 8;     // threads per row, 8 columns each
  constexpr int RPP = 128 / TPR;  // rows per pass
  const int ch = tid % TPR;
#pragma unroll
  for (int r = tid / TPR; r < BQ; r += RPP) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src + bf16_chunk<DH>(row0 + r, ch, rows));
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
    float x[8], amax = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      x[e] = bf2f(h[e]);
      if (CENTER) x[e] = rbf(x[e] - km[ch * 8 + e]);
      amax = nan_max(fabsf(x[e]), amax);
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float s = row_scale(amax), inv = fast_rcp(s);
    uint2 w;
    w.x = pack4(code_bits(x[0], inv), code_bits(x[1], inv), code_bits(x[2], inv),
                code_bits(x[3], inv));
    w.y = pack4(code_bits(x[4], inv), code_bits(x[5], inv), code_bits(x[6], inv),
                code_bits(x[7], inv));
    *reinterpret_cast<uint2*>(dst + s8_chunk<DH>(r, ch >> 1) + (ch & 1) * 8) = w;
    if (ch == 0) sc[r] = s;
  }
}

// km[c] = bf16(sum of the first n rows of column c / n) of a bf16 tile of 64
// rows (TMA's zero fill past n), by the 128 threads of a warpgroup; part
// holds 4 x DH floats; `bar` is the warpgroup's named barrier
template <int DH>
__device__ __forceinline__ void k_mean(const unsigned char* tile, int n, float* part, float* km,
                                       int tid, int bar) {
  constexpr int CPR = DH / 8, G = 128 / CPR;  // chunks per row, row groups
  const int ch = tid % CPR;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int r = tid / CPR; r < n; r += G) {
    const uint4 raw = *reinterpret_cast<const uint4*>(tile + bf16_chunk<DH>(r, ch, FUSED_MAX_N));
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += bf2f(h[e]);
  }
#pragma unroll
  for (int o = CPR; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  if ((tid & 31) < CPR)
#pragma unroll
    for (int e = 0; e < 8; ++e) part[(tid >> 5) * DH + ch * 8 + e] = acc[e];
  named_bar_sync(bar, 128);
  if (tid < DH)
    km[tid] = rbf(__fdiv_rn(part[tid] + part[DH + tid] + part[2 * DH + tid] + part[3 * DH + tid],
                            (float)n));
  named_bar_sync(bar, 128);
}

// S[64 x N] = Q8[64 x DH] . K8[N x DH]^T in s32 (one commit group)
template <int DH, int N>
__device__ __forceinline__ void i8_qk(int (&acc)[N / 2], const unsigned char* q8,
                                      const unsigned char* k8) {
  const uint64_t da = desc_kmajor<DH>(q8), db = desc_kmajor<DH>(k8);
  if constexpr (N == 64) {
    wgmma_s8_m64n64k32_first(acc, da, db);
#pragma unroll
    for (int kk = 1; kk < DH / 32; ++kk) wgmma_s8_m64n64k32(acc, da + 2 * kk, db + 2 * kk);
  } else {
    wgmma_s8_m64n128k32_first(acc, da, db);
#pragma unroll
    for (int kk = 1; kk < DH / 32; ++kk) wgmma_s8_m64n128k32(acc, da + 2 * kk, db + 2 * kk);
  }
  wgmma_commit();
}

// O[64 x DH] += P[64 x N] . V[N x DH]; P as bf16 A fragments, 4 registers per
// 16 keys; V's boxes of N key rows are atoms N * SW bytes apart (one commit
// group)
template <int DH, int N>
__device__ __forceinline__ void i8_pv(float (&o)[DH / 2], const uint32_t (&pa)[N / 4],
                                      const unsigned char* v) {
  constexpr int SW = I8Common<DH>::SW;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
    const uint64_t db = desc_mnmajor<SW>(v + kk * 16 * SW, N * SW);
    if constexpr (DH == 32)
      wgmma_rs_m64n32k16(o, a, db);
    else if constexpr (DH == 64)
      wgmma_rs_m64n64k16(o, a, db);
    else
      wgmma_rs_m64n128k16(o, a, db);
  }
  wgmma_commit();
}

// The online softmax of one block of N keys (k0..): the s32 products acc
// (accumulator layout: thread rows g and g + 8, columns 8j + 2t (+1)) times
// the keys' scales ks, keys >= n masked; m_run is the row max in those
// units, qf the row's q scale x scale x log2 e. Leaves this block's f32
// probabilities in p, adds them to this thread's part of the row sums, and
// returns the correction of earlier sums in corr.
template <int N>
__device__ __forceinline__ void i8_softmax(const int (&acc)[N / 2], float (&p)[N / 2],
                                           const float* ks, int k0, int n, int t,
                                           const float (&qf)[2], float (&m_run)[2],
                                           float (&l_run)[2], float (&corr)[2]) {
  // M + acc is exact as a float for M = 1.5 * 2^23 (|acc| <= 127^2 * 128 <
  // 2^22), so (M + acc) * ks - M * ks is acc * ks to within one step of the
  // product, in one FFMA
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 kc = *reinterpret_cast<const float2*>(ks + 8 * j + 2 * t);
    const float off[2] = {-12582912.0f * kc.x, -12582912.0f * kc.y};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[4 * j + e] = fmaf(__int_as_float(acc[4 * j + e] + 0x4B400000), (e & 1) ? kc.y : kc.x,
                          off[e & 1]);
  }
  if (k0 + N > n) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + 2 * t + (e & 1) >= n) p[4 * j + e] = -INFINITY;
  }
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], p[i]);
  float mq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = fast_exp2((m_run[r] - mx[r]) * qf[r]);  // 2^-inf = 0 on the first block
    m_run[r] = mx[r];
    mq[r] = mx[r] * qf[r];
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    // a NaN factor (a non-finite q row) makes every probability of its row NaN
    p[i] = fast_exp2(fmaf(p[i], qf[(i >> 1) & 1], -mq[(i >> 1) & 1]));
    ls[(i >> 1) & 1] += p[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + ls[r];
}

// the probabilities as bf16 A fragments of P . V, 4 registers per 16 keys
template <int N>
__device__ __forceinline__ void i8_pack(const float (&p)[N / 2], uint32_t (&pa)[N / 4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[4 * kk + i] = pack_bf16x2(p[8 * kk + 2 * i], p[8 * kk + 2 * i + 1]);
}

// O normalised by one reciprocal per row and stored: the rows row0.. below
// n, the columns below dv, through the warpgroup's staging tile in 16-byte
// chunks
template <int DH>
__device__ __forceinline__ void i8_store(const float (&o)[DH / 2], const float (&l_run)[2],
                                         bf16* stage_o, bf16* og, long long os, int row0, int n,
                                         int dv, int tid, int bar) {
  constexpr int OLD = I8Common<DH>::OLD;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.0f / l;
  }
  named_bar_sync(bar, 128);  // the previous rows have left the staging tile
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(stage_o + (warp * 16 + g + 8 * h) * OLD + 8 * j + 2 * t) =
          pack_bf16x2(o[4 * j + 2 * h] * inv[h], o[4 * j + 2 * h + 1] * inv[h]);
  named_bar_sync(bar, 128);
  for (int ci = tid; ci < BQ * (DH / 8); ci += 128) {
    const int r = ci / (DH / 8), ch = ci % (DH / 8), pos = row0 + r;
    if (pos < n && ch * 8 < dv)
      *reinterpret_cast<uint4*>(og + (long long)pos * os + ch * 8) =
          *reinterpret_cast<const uint4*>(stage_o + r * OLD + ch * 8);
  }
}

// one box of rows [row, row + box rows) at column `col` of head (hi, bi):
// rank 4 maps are (d, s, h, b), rank 3 maps (d, s, bh) with bi the sequence
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* m, uint64_t* bar, int col,
                                         int row, int hi, int bi, int rank) {
  if (rank == 4)
    tma_load_4d(dst, m, bar, col, row, hi, bi);
  else
    tma_load_3d(dst, m, bar, col, row, bi);
}

// ---- the fused route: one sequence of n <= 64 per consumer at a time ------

template <int DH>
__global__ void __launch_bounds__(FusedCfg<DH>::THREADS, 1)
i8_fused_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const I8Args p) {
  using C = FusedCfg<DH>;
  extern __shared__ unsigned char i8f_smem_raw[];
  // swizzled tiles start on 1024-byte boundaries
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(i8f_smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + C::STAGES;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 4);  // one arrival per warp of the stage's consumer
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int n = p.n;
  if (threadIdx.x < 128) {
    // ---- producer: stage i % STAGES gets this block's i-th sequence ----
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      for (int i = 0, u = blockIdx.x; u < p.units; ++i, u += gridDim.x) {
        const int st = i % C::STAGES, bi = u / p.heads, hi = u % p.heads;
        mbar_wait(empty + st, ((i / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(full + st, C::STAGE);
        unsigned char* base = smem + st * C::STAGE;
#pragma unroll
        for (int j = 0; j < C::NBOX; ++j) {
          const int off = j * FUSED_MAX_N * C::SW;
          load_box(base + off, &tq, full + st, j * C::BOX, 0, hi, bi, p.rank);
          load_box(base + C::TILE + off, &tk, full + st, j * C::BOX, 0, hi, bi, p.rank);
          load_box(base + 2 * C::TILE + off, &tv, full + st, j * C::BOX, 0, hi, bi, p.rank);
        }
      }
    }
  } else {
    // ---- consumers: consumer cw takes the block's sequences cw, cw + NCW, ...
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int cw = (threadIdx.x >> 7) - 1, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int bar = 1 + cw;
    unsigned char* q8 = smem + C::OFF_C + cw * C::C_TILES;
    unsigned char* k8 = q8 + C::Q8_BYTES;
    bf16* stage_o = reinterpret_cast<bf16*>(k8 + C::Q8_BYTES);
    float* qs = reinterpret_cast<float*>(smem + C::OFF_F) + cw * C::C_FLOATS;
    float* ks = qs + BQ;
    float* km = ks + FUSED_MAX_N;
    float* part = km + DH;
    for (int i = cw, u = blockIdx.x + cw * gridDim.x; u < p.units;
         i += C::NCW, u += C::NCW * gridDim.x) {
      const int st = i % C::STAGES;
      const long long bi = u / p.heads, hi = u % p.heads;
      const unsigned char* base = smem + st * C::STAGE;
      mbar_wait(full + st, (i / C::STAGES) & 1);
      k_mean<DH>(base + C::TILE, n, part, km, tid, bar);
      quantise_rows<DH, true>(base + C::TILE, FUSED_MAX_N, 0, km, k8, ks, tid);
      quantise_rows<DH, false>(base, FUSED_MAX_N, 0, nullptr, q8, qs, tid);
      fence_proxy_async();  // the codes, written by threads, are read by wgmma
      named_bar_sync(bar, 128);
      const float qf[2] = {qs[warp * 16 + g] * p.scale_log2, qs[warp * 16 + g + 8] * p.scale_log2};
      int acc[FUSED_MAX_N / 2];
      float s[FUSED_MAX_N / 2], o[DH / 2], m_run[2] = {-INFINITY, -INFINITY};
      float l_run[2] = {0.f, 0.f}, corr[2];
      uint32_t pa[FUSED_MAX_N / 4];
#pragma unroll
      for (int j = 0; j < DH / 2; ++j) o[j] = 0.f;
      wgmma_fence();
      i8_qk<DH, FUSED_MAX_N>(acc, q8, k8);
      wgmma_wait<0>();
      reg_fence(acc);
      i8_softmax<FUSED_MAX_N>(acc, s, ks, 0, n, t, qf, m_run, l_run, corr);
      i8_pack<FUSED_MAX_N>(s, pa);
      reg_fence(o);
      reg_fence(pa);
      wgmma_fence();
      i8_pv<DH, FUSED_MAX_N>(o, pa, base + 2 * C::TILE);
      wgmma_wait<0>();
      reg_fence(o);
      if (lane == 0) mbar_arrive(empty + st);
      i8_store<DH>(o, l_run, stage_o, p.o + bi * p.ob + hi * p.oh, p.os, 0, n, p.dv, tid, bar);
    }
  }
}

// ---- the tiles route: the pre-pass, then the attention kernel -------------

// k's column means, then per row the codes of k less its mean and the row's
// scale, written as the images of the attention kernel's key tiles (BK rows
// of DH bytes, swizzled as s8_chunk lays them out, one 16-byte store per
// thread and row) and their scales; rows n .. n_kt * BK are zero. k is read
// at byte strides (row, head, batch) with d real columns (a multiple of 8),
// 16 bytes a load. With CLUSTER a cluster of PRE_CLUSTER blocks takes one
// sequence, block `rank` the R rows from rank * R: each keeps its rows in
// shared memory between the two passes (k is read from device memory once)
// and sums its columns, and every block of the cluster adds the blocks' sums
// in one order through distributed shared memory, so all take one mean.
// Without, one block takes the whole sequence (R = n_kt * BK) and its second
// pass reads k again (sequences too long to stage).
template <int DH, bool CLUSTER>
__global__ void __launch_bounds__(PRE_THREADS) i8_prepass_kernel(
    const unsigned char* __restrict__ k, long long rs, long long hs, long long bs, int heads,
    int n, int d, int n_kt, int R, unsigned char* __restrict__ codes,
    float* __restrict__ kscales) {
  constexpr int CPR = DH / 8;  // 8-column chunks per row
  constexpr int WARPS = PRE_THREADS / 32;
  __shared__ float part[WARPS][DH];
  __shared__ float colsum[DH];
  __shared__ float km[DH];
  extern __shared__ uint4 rows[];  // CLUSTER: row r0 + i's chunk c at i * CPR + c
  const int rank = CLUSTER ? (int)cg::this_cluster().block_rank() : 0;
  const int seq = CLUSTER ? blockIdx.x / PRE_CLUSTER : blockIdx.x, tid = threadIdx.x;
  const int r0 = rank * R;
  const unsigned char* kg = k + (long long)(seq / heads) * bs + (long long)(seq % heads) * hs;
  {
    const int ch = tid % CPR;
    const bool real = ch * 8 < d;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const int r_end = min(r0 + R, n);
#pragma unroll 4
    for (int r = r0 + tid / CPR; r < r_end; r += PRE_THREADS / CPR) {
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (real) raw = *reinterpret_cast<const uint4*>(kg + r * rs + ch * 16);
      if (CLUSTER) rows[(r - r0) * CPR + ch] = raw;
      const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += bf2f(h[e]);
    }
#pragma unroll
    for (int o = CPR; o < 32; o <<= 1)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    if ((tid & 31) < CPR)
#pragma unroll
      for (int e = 0; e < 8; ++e) part[tid >> 5][ch * 8 + e] = acc[e];
  }
  __syncthreads();
  if (tid < DH) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += part[w][tid];
    colsum[tid] = sum;
  }
  if (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's sums are there
    if (tid < DH) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < PRE_CLUSTER; ++j) sum += cluster.map_shared_rank(colsum, j)[tid];
      km[tid] = rbf(__fdiv_rn(sum, (float)n));
    }
    cluster.sync();  // the mean is there, and no block leaves while its sums are read
  } else {
    __syncthreads();
    if (tid < DH) km[tid] = rbf(__fdiv_rn(colsum[tid], (float)n));
    __syncthreads();
  }

  constexpr int TPR = DH / 16;            // threads per row, 16 columns each
  constexpr int RPP = PRE_THREADS / TPR;  // rows per pass; divides R
  const int c = tid % TPR, n_rows = n_kt * BK;
  unsigned char* cg_ = codes + (long long)seq * n_rows * DH;
  float* sg = kscales + (long long)seq * n_rows;
  for (int r = r0 + tid / TPR; r < r0 + R; r += RPP) {
    float x[16], amax = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = c * 16 + half * 8;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (r < n && col < d)
        raw = CLUSTER ? rows[(r - r0) * CPR + 2 * c + half]
                      : *reinterpret_cast<const uint4*>(kg + r * rs + col * 2);
      const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float v = (r < n && col < d) ? rbf(bf2f(h[e]) - km[col + e]) : 0.f;
        x[half * 8 + e] = v;
        amax = nan_max(fabsf(v), amax);
      }
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float s = row_scale(amax), inv = fast_rcp(s);
    uint4 w;
    w.x = pack4(code_bits(x[0], inv), code_bits(x[1], inv), code_bits(x[2], inv),
                code_bits(x[3], inv));
    w.y = pack4(code_bits(x[4], inv), code_bits(x[5], inv), code_bits(x[6], inv),
                code_bits(x[7], inv));
    w.z = pack4(code_bits(x[8], inv), code_bits(x[9], inv), code_bits(x[10], inv),
                code_bits(x[11], inv));
    w.w = pack4(code_bits(x[12], inv), code_bits(x[13], inv), code_bits(x[14], inv),
                code_bits(x[15], inv));
    if (r < n_rows) {
      *reinterpret_cast<uint4*>(cg_ + (long long)(r / BK) * BK * DH + s8_chunk<DH>(r % BK, c)) =
          w;
      if (c == 0) sg[r] = r < n ? s : 0.f;
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(TilesCfg<DH>::THREADS, 1)
i8_tiles_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tv,
                const I8Args p) {
  using C = TilesCfg<DH>;
  extern __shared__ unsigned char i8t_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(i8t_smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* q_empty = q_full + C::QBUF;
  uint64_t* k_full = q_empty + C::QBUF;
  uint64_t* v_full = k_full + C::STAGES;
  uint64_t* kv_empty = v_full + C::STAGES;
  unsigned char* sQ = smem;
  unsigned char* sKC = smem + C::OFF_KC;
  unsigned char* sV = smem + C::OFF_V;
  float* sKS = reinterpret_cast<float*>(smem + C::OFF_KS);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < C::QBUF; ++b) {
      mbar_init(q_full + b, 1);
      mbar_init(q_empty + b, 4 * C::NCW);  // one arrival per consumer warp
    }
#pragma unroll
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(k_full + st, 1);
      mbar_init(v_full + st, 1);
      mbar_init(kv_empty + st, 4 * C::NCW);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int n = p.n, n_kb = p.n_kt;
  if (threadIdx.x < 128) {
    // ---- producer ----
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tv);
      int it = 0;  // key tiles loaded so far
      for (int ti = 0, tile = blockIdx.x; tile < p.units; ++ti, tile += gridDim.x) {
        const int seq = tile / p.q_tiles, q0 = (tile % p.q_tiles) * C::BQT;
        const int bi = seq / p.heads, hi = seq % p.heads;
        const int qb = ti % C::QBUF;
        mbar_wait(q_empty + qb, ((ti / C::QBUF) & 1) ^ 1);
        mbar_expect_tx(q_full + qb, C::Q_BYTES);
#pragma unroll
        for (int j = 0; j < C::NBOX; ++j)
          load_box(sQ + qb * C::Q_BYTES + j * C::BQT * C::SW, &tq, q_full + qb, j * C::BOX, q0,
                   hi, bi, p.rank);
        for (int kb = 0; kb < n_kb; ++kb, ++it) {
          const int st = it % C::STAGES;
          const long long key0 = ((long long)seq * n_kb + kb) * BK;  // the tile's first key
          mbar_wait(kv_empty + st, ((it / C::STAGES) & 1) ^ 1);
          mbar_expect_tx(k_full + st, C::KC_BYTES + C::KS_BYTES);
          bulk_load(sKC + st * C::KC_BYTES, p.codes + key0 * DH, C::KC_BYTES, k_full + st);
          bulk_load(sKS + st * BK, p.kscales + key0, C::KS_BYTES, k_full + st);
          mbar_expect_tx(v_full + st, C::V_BYTES);
#pragma unroll
          for (int j = 0; j < C::NBOX; ++j)
            load_box(sV + st * C::V_BYTES + j * BK * C::SW, &tv, v_full + st, j * C::BOX,
                     kb * BK, hi, bi, p.rank);
        }
      }
    }
  } else {
    // ---- consumers ----
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int cw = (threadIdx.x >> 7) - 1;  // query rows 64 * cw .. of each tile
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    unsigned char* q8 = smem + C::OFF_C + cw * C::C_TILES;
    bf16* stage_o = reinterpret_cast<bf16*>(q8 + C::Q8_BYTES);
    float* qs = reinterpret_cast<float*>(smem + C::OFF_QS) + cw * BQ;
    // issue turns, round robin, as in flash_wgmma.cuh (barriers NCW + 1 ..
    // 2 NCW; 1..NCW are each consumer's own)
    auto my_turn = [&]() { named_bar_sync(1 + C::NCW + cw, 256); };
    auto next_turn = [&]() { named_bar_arrive(1 + C::NCW + (cw + 1) % C::NCW, 256); };
    if (cw == C::NCW - 1) next_turn();  // consumer 0 issues first
    int it = 0;  // key tiles consumed so far
    for (int ti = 0, tile = blockIdx.x; tile < p.units; ++ti, tile += gridDim.x) {
      const int seq = tile / p.q_tiles;
      const long long bi = seq / p.heads, hi = seq % p.heads;
      const int row0 = (tile % p.q_tiles) * C::BQT + cw * BQ;
      const int qb = ti % C::QBUF;
      mbar_wait(q_full + qb, (ti / C::QBUF) & 1);
      quantise_rows<DH, false>(sQ + qb * C::Q_BYTES, C::BQT, cw * BQ, nullptr, q8, qs, tid);
      fence_proxy_async();  // the codes, written by threads, are read by wgmma
      named_bar_sync(1 + cw, 128);
      if (lane == 0) mbar_arrive(q_empty + qb);
      const float qf[2] = {qs[warp * 16 + g] * p.scale_log2, qs[warp * 16 + g + 8] * p.scale_log2};
      int acc[BK / 2];
      float s[BK / 2], o[DH / 2], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
      float corr[2];
      uint32_t pa[BK / 4];
#pragma unroll
      for (int j = 0; j < DH / 2; ++j) o[j] = 0.f;

      // block 0: S = Q8 . K8_0^T, then its softmax (nothing to overlap yet)
      int st = it % C::STAGES;
      mbar_wait(k_full + st, (it / C::STAGES) & 1);
      my_turn();
      wgmma_fence();
      i8_qk<DH, BK>(acc, q8, sKC + st * C::KC_BYTES);
      next_turn();
      wgmma_wait<0>();
      reg_fence(acc);
      i8_softmax<BK>(acc, s, sKS + st * BK, 0, n, t, qf, m_run, l_run, corr);
      i8_pack<BK>(s, pa);

      for (int kb = 1; kb < n_kb; ++kb) {
        const int it_n = it + 1, sn = it_n % C::STAGES;
        mbar_wait(k_full + sn, (it_n / C::STAGES) & 1);
        mbar_wait(v_full + st, (it / C::STAGES) & 1);
        reg_fence(o);
        reg_fence(pa);
        my_turn();
        wgmma_fence();
        i8_qk<DH, BK>(acc, q8, sKC + sn * C::KC_BYTES);
        i8_pv<DH, BK>(o, pa, sV + st * C::V_BYTES);
        next_turn();
        wgmma_wait<1>();  // S_kb is done; P_{kb-1} . V_{kb-1} may still run
        reg_fence(acc);
        i8_softmax<BK>(acc, s, sKS + sn * BK, kb * BK, n, t, qf, m_run, l_run, corr);
        wgmma_wait<0>();
        reg_fence(o);
        reg_fence(pa);
        if (lane == 0) mbar_arrive(kv_empty + st);
#pragma unroll
        for (int j = 0; j < DH / 2; ++j) o[j] *= corr[(j >> 1) & 1];
        i8_pack<BK>(s, pa);
        it = it_n;
        st = sn;
      }
      mbar_wait(v_full + st, (it / C::STAGES) & 1);
      reg_fence(o);
      reg_fence(pa);
      my_turn();
      wgmma_fence();
      i8_pv<DH, BK>(o, pa, sV + st * C::V_BYTES);
      next_turn();
      wgmma_wait<0>();
      reg_fence(o);
      if (lane == 0) mbar_arrive(kv_empty + st);
      ++it;
      i8_store<DH>(o, l_run, stage_o, p.o + bi * p.ob + hi * p.oh, p.os, row0, n, p.dv, tid,
                   1 + cw);
    }
  }
}

// ---- host ------------------------------------------------------------------

int core_width(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : 128; }

template <int DH>
int launch_fused(I8Args a, const void* q, const void* k, const void* v, const uint64_t* dims,
                 const uint64_t* qs, const uint64_t* ks, const uint64_t* vs, int grid, int smem,
                 cudaStream_t stream) {
  using C = FusedCfg<DH>;
  if (smem != C::SMEM || grid < 1 || grid > a.units) return (int)cudaErrorInvalidValue;
  const uint32_t box[4] = {(uint32_t)C::BOX, (uint32_t)FUSED_MAX_N, 1, 1};
  CUtensorMap tq, tk, tv;
  int rc = make_tmap_bf16(&tq, q, a.rank, dims, qs, box, C::SW);
  if (rc == 0) rc = make_tmap_bf16(&tk, k, a.rank, dims, ks, box, C::SW);
  if (rc == 0) rc = make_tmap_bf16(&tv, v, a.rank, dims, vs, box, C::SW);
  if (rc != 0) return rc;
  cudaFuncSetAttribute(i8_fused_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  i8_fused_kernel<DH><<<grid, C::THREADS, C::SMEM, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_tiles(I8Args a, const void* q, const void* v, const uint64_t* dims, const uint64_t* qs,
                 const uint64_t* vs, int grid, int smem, cudaStream_t stream) {
  using C = TilesCfg<DH>;
  a.q_tiles = (a.n + C::BQT - 1) / C::BQT;
  const long long units = (long long)a.units * a.q_tiles;  // a.units: sequences on entry
  if (smem != C::SMEM || units > 0x7fffffffLL || grid < 1 || grid > units)
    return (int)cudaErrorInvalidValue;
  a.units = (int)units;
  const uint32_t box_q[4] = {(uint32_t)C::BOX, (uint32_t)C::BQT, 1, 1};
  const uint32_t box_v[4] = {(uint32_t)C::BOX, (uint32_t)BK, 1, 1};
  CUtensorMap tq, tv;
  int rc = make_tmap_bf16(&tq, q, a.rank, dims, qs, box_q, C::SW);
  if (rc == 0) rc = make_tmap_bf16(&tv, v, a.rank, dims, vs, box_v, C::SW);
  if (rc != 0) return rc;
  cudaFuncSetAttribute(i8_tiles_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  i8_tiles_kernel<DH><<<grid, C::THREADS, C::SMEM, stream>>>(tq, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The pre-pass of the tiles route: for batch x heads sequences of n rows of
// k (d real columns, a multiple of 8 up to 128, read at byte strides rs, hs,
// bs for row, head and batch, all multiples of 16, the base 16-byte
// aligned), the images of the attention kernel's n_kt = ceil(n / 128) key
// tiles per sequence in `codes` (batch * heads * n_kt * 128 * dh bytes; dh
// the core width 32, 64 or 128 that holds d) and their scales in `kscales`
// (batch * heads * n_kt * 128 f32). n > 64: shorter sequences take the
// fused route. The host's plan: `cluster` PRE_CLUSTER blocks a sequence of
// `rows` rows each (ceil(n_kt * 128 / PRE_CLUSTER) rounded up to a whole
// pass), each keeping them in `smem` = rows * dh * 2 bytes (at most
// PRE_STAGE_MAX); or 1 block a sequence, rows n_kt * 128 and smem 0.
int sesa_i8_prepass(const void* k, void* codes, void* kscales, long long rs, long long hs,
                    long long bs, int batch, int heads, int n, int d, int dh, int n_kt,
                    int cluster, int rows, int smem, void* stream) {
  const int rpp = PRE_THREADS / (dh / 16);
  const int want_rows = cluster == 1 ? n_kt * BK
                                     : ((n_kt * BK + cluster - 1) / cluster + rpp - 1) / rpp * rpp;
  if (d < 8 || d > 128 || d % 8 || dh != core_width(d) || n <= FUSED_MAX_N || batch < 1 ||
      heads < 1 || n_kt != (n + BK - 1) / BK || rs % 16 || hs % 16 || bs % 16 ||
      ((uintptr_t)k & 15) || (long long)batch * heads * cluster > 0x7fffffffLL ||
      (cluster != 1 && cluster != PRE_CLUSTER) || rows != want_rows ||
      smem != (cluster == 1 ? 0 : rows * dh * 2) || smem > PRE_STAGE_MAX)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)batch * heads * cluster));
  cfg.blockDim = dim3(PRE_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const unsigned char* kp = (const unsigned char*)k;
  unsigned char* cp = (unsigned char*)codes;
  float* sp = (float*)kscales;
  auto run = [&](auto kernel) {
    if (smem) cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    return (int)cudaLaunchKernelEx(&cfg, kernel, kp, rs, hs, bs, heads, n, d, n_kt, rows, cp, sp);
  };
  if (dh == 32)
    return cluster == 1 ? run(i8_prepass_kernel<32, false>) : run(i8_prepass_kernel<32, true>);
  if (dh == 64)
    return cluster == 1 ? run(i8_prepass_kernel<64, false>) : run(i8_prepass_kernel<64, true>);
  return cluster == 1 ? run(i8_prepass_kernel<128, false>) : run(i8_prepass_kernel<128, true>);
}

// o = int8 attention of q, k, v over batch x heads sequences of n rows of
// dims[0] columns (a multiple of 8 up to 128, run at the core width dh 32,
// 64 or 128, TMA's zero fill padding each head). route 0 (fused, n <= 64)
// or 1 (tiles, n > 64, after sesa_i8_prepass filled codes and kscales).
// rank 4: dims (d, n, heads, batch); rank 3: dims (d, n, batch), heads 1.
// *_s1..3: byte strides of dims 1..rank-1 of q, k, v (multiples of 16); ob,
// oh, os: output strides in elements for (batch, head, row), unit stride
// along d; scale > 0. grid and smem are the host's plan (ops/attention.py
// i8_plan): one block per SM and never more than the work units, and the
// dynamic shared memory of the route's layout at dh; a plan that does not
// match is refused.
int sesa_i8_attn(int route, const void* q, const void* k, const void* v, void* o,
                 const void* codes, const void* kscales, int rank, long long d0, long long d1,
                 long long d2, long long d3, long long q_s1, long long q_s2, long long q_s3,
                 long long k_s1, long long k_s2, long long k_s3, long long v_s1, long long v_s2,
                 long long v_s3, long long ob, long long oh, long long os, int batch, int heads,
                 int n, int dh, float scale, int grid, int smem, void* stream) {
  if ((rank != 3 && rank != 4) || !(scale > 0.f) || d0 < 8 || d0 > 128 || d0 % 8 ||
      dh != core_width((int)d0) || d1 != n || n < 1 ||
      (rank == 4 && (d2 != heads || d3 != batch)) || (rank == 3 && (d2 != batch || heads != 1)) ||
      route != (n <= FUSED_MAX_N ? 0 : 1) || (route == 1 && (codes == nullptr || !kscales)) ||
      (long long)batch * heads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const uint64_t dims[4] = {(uint64_t)d0, (uint64_t)d1, (uint64_t)d2, (uint64_t)d3};
  const uint64_t qs[3] = {(uint64_t)q_s1, (uint64_t)q_s2, (uint64_t)q_s3};
  const uint64_t ks[3] = {(uint64_t)k_s1, (uint64_t)k_s2, (uint64_t)k_s3};
  const uint64_t vs[3] = {(uint64_t)v_s1, (uint64_t)v_s2, (uint64_t)v_s3};
  I8Args a = {};
  a.o = (bf16*)o;
  a.ob = ob;
  a.oh = oh;
  a.os = os;
  a.heads = heads;
  a.n = n;
  a.units = batch * heads;
  a.n_kt = (n + BK - 1) / BK;
  a.rank = rank;
  a.dv = (int)d0;
  a.scale_log2 = scale * 1.4426950408889634f;
  a.codes = (const unsigned char*)codes;
  a.kscales = (const float*)kscales;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 0) {
    if (dh == 32) return launch_fused<32>(a, q, k, v, dims, qs, ks, vs, grid, smem, st);
    if (dh == 64) return launch_fused<64>(a, q, k, v, dims, qs, ks, vs, grid, smem, st);
    return launch_fused<128>(a, q, k, v, dims, qs, ks, vs, grid, smem, st);
  }
  if (dh == 32) return launch_tiles<32>(a, q, v, dims, qs, vs, grid, smem, st);
  if (dh == 64) return launch_tiles<64>(a, q, v, dims, qs, vs, grid, smem, st);
  return launch_tiles<128>(a, q, v, dims, qs, vs, grid, smem, st);
}

}  // extern "C"
