// K8: the Mamba-2 SSD chunked scan on Hopper.
//
// Replaces: sesa_tpu/ops/ssd.py ssd_pallas (Pallas kernel _ssd_kernel). For
// x (B, L, H, P), log-decays a (B, L, H) and the head-shared projections b,
// c (B, L, 1, N) it computes, chunk by chunk of Q steps with the (P, N)
// state of every (batch, head) carried in f32,
//   acum  = inclusive prefix sum of a over the chunk
//   y     = (C . B^T * exp(min(acum_l - acum_s, 0)) [s <= l]) . X
//           + exp(acum_l) * C . state^T
//   state = exp(acum_last) * state + X^T . (exp(acum_last - acum) * B)
// with every input cast to f32, f32 products and sums, and the result
// rounded to the input dtype (f32 or bf16) on the way out.
//
// Bound on the H100: the products on the tensor cores, or bytes. An f32
// operand keeps about 21 bits only as a high and a low TF32 part, so the f32
// form needs three TF32 passes (494.7 TFLOP/s dense each) of every product
// (lo . hi, hi . lo, hi . hi). bf16 values are exact in TF32 and in bf16: in
// the bf16 form C . B^T needs one bf16 pass (989 TFLOP/s), and the three
// products with one f32 operand (the decayed C . B^T with X, the state with
// C, w * X with B) the cheaper of two TF32 passes and three bf16 passes. The
// function needs per sequence row C . B^T once for the heads together and,
// per head, the masked product with X, both over the lower triangle of each
// chunk only (Q (Q + 1) / 2 pairs, times N and P), and, in every chunk but
// the first and but the last respectively, the two state products
// (2 * N * P per step each). At band_rnn (B 684, L 704 = 11 chunks, H 8)
// that is 4.0e9 FLOP of C . B^T and 1.31e11 of the others: 0.40 ms in bf16
// (0.82 ms in f32, three TF32 passes of 1.35e11) against 1.24 GB of bf16
// traffic (0.37 ms). At band_comm (B 8280, L 64, one chunk, no state
// product) the bytes bound it: 1.37 GB in bf16 (0.41 ms), 2.73 GB in f32
// (0.82 ms). chip_smoke.py k8_bound counts the same.
//
// Shapes. The kernels are built for (P, N, Q) = (64, 128, 64), Mamba-2's
// sizes in TS-BS-Mamba2; the wrapper (ops/ssd.py ssd_fused, k8_plan) takes
// every (P, N, chunk) the Pallas kernel's gate fuses (P % 8, N % 128,
// chunk % 8) exactly around them, since every column p of x has its own
// state rows and the scan's result does not depend on the chunk:
// * P: x zero-padded per head to whole 64-column pseudo-heads, each with
//   its head's decays, and y sliced back;
// * chunk: L zero-padded (x = a = b = c = 0, an exact no-op for the steps
//   before it) to a multiple of 64 and scanned in chunks of 64;
// * N: one launch per 128-column slice of B and C (both products over N,
//   C . B^T and C . state^T, split into their slices' sums, each slice with
//   its own state); each launch adds its slice's f32 y to an f32 sum
//   (`part`: first, middle, last), and the last rounds it to the output
//   dtype once. The 64 x 128 f32 state a block keeps in registers stays as
//   it is: the f32 carried kernel already takes 236 of its 255 registers.
//
// Design. Two kernels behind one entry point; the wrapper's plan
// (ops/ssd.py k8_plan) picks one from L and passes its grid and shared
// memory, which the kernel checks.
// * Carried (L > 64): one block of 8 warps per (batch, head) walks the
//   chunks; the 64 x 128 f32 state lives in the accumulators of its update
//   product across the sequence, a 16 x 64 tile per warp (row tile wm, half
//   wn). The accumulator layout of an m16n8 tile is the A-fragment layout of
//   the next product when k is permuted (slot t <-> step 2t, slot t + 4 <->
//   2t + 1), so C . state^T runs as state . C^T from registers, each state
//   element split into its TF32 parts once per chunk by its owner; the two
//   warps of a row tile sum half the state columns each. For G . X the two
//   warps of row tile wm split the steps s up to the diagonal instead: each
//   computes its half of G = C . B^T, masks it, keeps it in registers as the
//   A operand and multiplies it by all 64 columns of X. The halves meet in
//   shared memory, where each warp of the pair stores its 32 columns of y.
//   Each row tile's G phase is compiled with its own tile count (with_nt).
//   Warp 0 scans the next chunk's decays after its G phase, the shortest.
//   In bf16 one stage of tiles lets two blocks share an SM and hide each
//   other's phases (faster than two stages and one block); the next
//   chunk's copy (cp.async) starts once every warp is past its last read of
//   the tiles. In f32 two blocks do not fit: two stages, the next
//   chunk copied while this one's products run.
// * Rows (L = 64, one chunk, no state): one block per batch row loads B and
//   C once, computes C . B^T once, and loops over the heads, masking it
//   with each head's decays and multiplying by that head's x, whose next
//   tile is copied meanwhile (as the TPU kernel shares C . B^T).
// Splits are masks, not conversions: hi = bits & 0xffffe000 and lo = v - hi
// (exact) masked the same way, |v - hi - lo| < 2^-20 |v|. Operands stay in
// shared memory in their input dtype; a bf16 value shifted into the high
// half of a 32-bit word is its TF32 pattern, so bf16 fragments come straight
// from ldmatrix (.trans for the operands read down their columns) and need
// no split. C . B^T in bf16 runs as mma.sync m16n8k16 on bf16, whose products
// are exact. Above the diagonal the decay matrix is zero: those tiles are
// not computed, and G . X stops at the diagonal tile.
//
// What holds it back: the products run on mma.sync, short of the rate
// wgmma reaches, and the phases of a warp (state . C^T, the state update,
// the G phase, the combine) run one after the other between two block
// barriers, with four warps per SM sub-partition in bf16 (two in f32) to
// hide each other's latency; the row tiles' G phases differ four to one; B
// and C are read from L2 once per head.
//
// Shared memory: carried, x (64 x 72 bf16 / 68 f32) and B, C (64 x 136 each)
// in one stage (bf16) or two (f32), the two halves of state . C^T and one of
// G . X (64 x 72 f32 each) and two stages of three decay vectors: 100,864
// bytes in bf16, two blocks per SM (at 128 registers), 230,912 in f32, one
// block per SM. Rows: B, C, two stages of x and 8 heads'
// decay sums: 55,296 bytes in bf16, 106,496 in f32, two blocks per SM. The
// row pads keep the ldmatrix phases and the pair loads free of bank
// conflicts (in f32, B read down its columns has two-way conflicts).
#include "common.cuh"

namespace sesa {

constexpr int SS_Q = 64, SS_P = 64, SS_N = 128, SS_THREADS = 256;
constexpr int SS_LDY = SS_Q + 8;  // the f32 partial sums met in shared memory
constexpr int SS_HG = SS_THREADS / 32;  // heads whose decays the rows kernel scans at once
constexpr uint32_t TF32_HI = 0xffffe000u;  // sign, exponent and 10 mantissa bits

// per input dtype: whether its values are exact in TF32, the shared-memory
// row strides (elements) of x (LDX) and of B and C (LDN), and the stages of
// the carried kernel's tiles: bf16 keeps one, which lets two blocks share an
// SM to hide each other's phases; f32 keeps two, one block per SM, and
// copies the next chunk while this one's products run
template <typename T> struct SsType;
template <> struct SsType<bf16> {
  static constexpr bool EXACT = true;
  static constexpr int LDX = SS_P + 8, LDN = SS_N + 8, STAGES = 1;
};
template <> struct SsType<float> {
  static constexpr bool EXACT = false;
  static constexpr int LDX = SS_P + 4, LDN = SS_N + 8, STAGES = 2;
};
template <typename T>
__host__ __device__ constexpr int ss_tile_elems() {  // x, B and C of one chunk
  return SS_Q * SsType<T>::LDX + 2 * SS_Q * SsType<T>::LDN;
}
template <typename T>
__host__ __device__ constexpr int ss_carried_smem() {
  return SsType<T>::STAGES * ss_tile_elems<T>() * (int)sizeof(T) + 3 * SS_P * SS_LDY * 4 +
         2 * 3 * SS_Q * 4;
}
template <typename T>
__host__ __device__ constexpr int ss_rows_smem() {
  return (2 * SS_Q * SsType<T>::LDN + 2 * SS_Q * SsType<T>::LDX) * (int)sizeof(T) +
         SS_HG * SS_Q * 4;
}

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const bf16* p) { return bf2f(*p); }
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}
// y's element pair at offset o. Without SUM the launch is the only slice
// (y = v); with SUM, by its part of the sum over N slices: 1 the first
// (ysum = v), 2 a middle one (ysum += v), 3 the last (y = ysum + v, rounded
// once); ysum is an f32 buffer of y's shape
template <bool SUM, typename T>
__device__ __forceinline__ void put_y(T* y, float* ysum, long long o, int part, float v0,
                                      float v1) {
  if (SUM) {
    float2* q = reinterpret_cast<float2*>(ysum + o);
    if (part >= 2) {
      const float2 prev = *q;
      v0 += prev.x;
      v1 += prev.y;
    }
    if (part != 3) {
      *q = make_float2(v0, v1);
      return;
    }
  }
  st2(y + o, v0, v1);
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// p[0], p[1] as f32 bit patterns
__device__ __forceinline__ void ld_pair(const float* p, uint32_t& v0, uint32_t& v1) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  v0 = __float_as_uint(f.x);
  v1 = __float_as_uint(f.y);
}
__device__ __forceinline__ void ld_pair(const bf16* p, uint32_t& v0, uint32_t& v1) {
  const uint32_t r = ld32(p);
  v0 = r << 16;
  v1 = r & 0xffff0000u;
}

// four 8 x 8 blocks of a row-major tile m read down their columns, k-permuted
// fragments: v[q] = (m[r + 2t][c + g], m[r + 2t + 1][c + g]) as f32 bit
// patterns, with block q at (r, c) = (r0, c0 + 8q), or with SQ at
// (r0 + 8 (q / 2), c0 + 8 (q % 2)). bf16 through ldmatrix.trans.
template <bool SQ>
__device__ __forceinline__ int blk_r(int q) { return SQ ? 8 * (q >> 1) : 0; }
template <bool SQ>
__device__ __forceinline__ int blk_c(int q) { return SQ ? 8 * (q & 1) : 8 * q; }

template <bool SQ>
__device__ __forceinline__ void ld_cols(const bf16* m, int ld, int r0, int c0, int lane,
                                        uint32_t (*v)[2]) {
  const int q = lane >> 3;
  uint32_t r[4];
  ldmatrix_x4_trans(r, m + (r0 + blk_r<SQ>(q) + (lane & 7)) * ld + c0 + blk_c<SQ>(q));
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j][0] = r[j] << 16;
    v[j][1] = r[j] & 0xffff0000u;
  }
}
template <bool SQ>
__device__ __forceinline__ void ld_cols(const float* m, int ld, int r0, int c0, int lane,
                                        uint32_t (*v)[2]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float* p = m + (r0 + blk_r<SQ>(j) + 2 * t) * ld + c0 + blk_c<SQ>(j) + g;
    v[j][0] = __float_as_uint(p[0]);
    v[j][1] = __float_as_uint(p[ld]);
  }
}

// two 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(s));
}

// four 8 x 8 blocks of a row-major tile m read along their rows: v[q] =
// (m[r0 + 8q + g][c0 + 2t], m[r0 + 8q + g][c0 + 2t + 1]) as f32 bit
// patterns. bf16 through ldmatrix.
__device__ __forceinline__ void ld_rows(const bf16* m, int ld, int r0, int c0, int lane,
                                        uint32_t (*v)[2]) {
  uint32_t r[4];
  ldmatrix_x4(r, m + (r0 + lane) * ld + c0);  // lane 8q + i: row 8q + i of block q
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j][0] = r[j] << 16;
    v[j][1] = r[j] & 0xffff0000u;
  }
}
__device__ __forceinline__ void ld_rows(const float* m, int ld, int r0, int c0, int lane,
                                        uint32_t (*v)[2]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) ld_pair(m + (r0 + 8 * j + g) * ld + c0 + 2 * t, v[j][0], v[j][1]);
}

// v = hi + lo, both TF32 patterns: hi keeps v's top 11 significant bits, lo
// = v - hi (exact) its own; |v - hi - lo| < 2^-20 |v|
__device__ __forceinline__ void split_tf32(uint32_t v, uint32_t& hi, uint32_t& lo) {
  hi = v & TF32_HI;
  lo = __float_as_uint(__uint_as_float(v) - __uint_as_float(hi)) & TF32_HI;
}
// an operand's two parts; an exact one is its own high part
template <bool EXACT>
__device__ __forceinline__ void parts(uint32_t v, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = v;
    lo = 0u;
  } else {
    split_tf32(v, hi, lo);
  }
}

// m16n8k8, TF32 operands, f32 sums. With g = lane / 4 and t = lane % 4:
//   A (16x8, row): a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//   B (8x8, col):  b0 (k t, n g)   b1 (k t+4, n g)
//   C (16x8):      c0, c1 (g, 2t..2t+1)   c2, c3 (g+8, 2t..2t+1)
// Every product here permutes k: slot t is step 2t of the 8, slot t + 4 step
// 2t + 1, in both operands. Not volatile, so that the compiler may schedule
// independent products freely.
__device__ __forceinline__ void mma_tf32_1688(float c[4], const uint32_t a[4],
                                              const uint32_t b[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// m16n8k16 on bf16 (the layouts of common.cuh), not volatile
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c[j] += a . b[j] for the NT tiles, in the passes the operands need (EA,
// EB: exact), small terms first; b holds raw values, split here unless exact
template <bool EA, bool EB, int NT>
__device__ __forceinline__ void mma_tiles(float (*c)[4], const uint32_t ah[4],
                                          const uint32_t al[4], const uint32_t (*b)[2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t bh[2], bl[2];
    parts<EB>(b[j][0], bh[0], bl[0]);
    parts<EB>(b[j][1], bh[1], bl[1]);
    if (!EA) mma_tf32_1688(c[j], al, bh);
    if (!EB) mma_tf32_1688(c[j], ah, bl);
    mma_tf32_1688(c[j], ah, bh);
  }
}
// the A fragment of the C-layout tile c (k-permuted), split into its parts
__device__ __forceinline__ void a_from_acc(const float c[4], uint32_t ah[4], uint32_t al[4]) {
  split_tf32(__float_as_uint(c[0]), ah[0], al[0]);
  split_tf32(__float_as_uint(c[2]), ah[1], al[1]);
  split_tf32(__float_as_uint(c[1]), ah[2], al[2]);
  split_tf32(__float_as_uint(c[3]), ah[3], al[3]);
}

// rows [0, 64) of a W-wide tile at src (rows src_ld elements apart) into dst
// (rows ld apart), in 16-byte cp.async copies
template <int W, typename T>
__device__ __forceinline__ void stage_tile64(T* dst, int ld, const T* src, long long src_ld) {
  // opaque to the compiler, so that it computes the copies' addresses here
  // instead of keeping all of them in registers across the caller's loop
  // (which spilled the f32 carried kernel)
  asm volatile("" : "+l"(dst), "+l"(src), "+l"(src_ld));
  constexpr int PER = 16 / (int)sizeof(T), CPR = W / PER;
  static_assert(SS_Q * CPR % SS_THREADS == 0, "whole rounds of copies");
#pragma unroll
  for (int k = 0; k < SS_Q * CPR / SS_THREADS; ++k) {
    const int i = threadIdx.x + k * SS_THREADS, r = i / CPR, c = (i % CPR) * PER;
    cp_async16(dst + r * ld + c, src + r * src_ld + c);
  }
}

// inclusive prefix sum of the 64 values (a0 of lanes 0..31, a1 of lanes 0..31)
__device__ __forceinline__ void warp_scan64(float& a0, float& a1, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u0 = __shfl_up_sync(0xffffffffu, a0, o);
    const float u1 = __shfl_up_sync(0xffffffffu, a1, o);
    if (lane >= o) {
      a0 += u0;
      a1 += u1;
    }
  }
  a1 += __shfl_sync(0xffffffffu, a0, 31);
}

// acc[j] (C layout) += C[m0..m0+16) . B[8j..8j+8)^T over the 128 state
// columns, for the column tiles j < NT of b. bf16: one m16n8k16 pass, exact
// products; f32: three TF32 passes.
template <int NT>
__device__ __forceinline__ void cbt(float (*acc)[4], const bf16* c, const bf16* b, int ld, int m0,
                                    int lane) {
  const int q = lane >> 3, r = lane & 7;
#pragma unroll 2
  for (int k0 = 0; k0 < SS_N; k0 += 16) {
    uint32_t a[4];  // blocks (m0, k0), (m0 + 8, k0), (m0, k0 + 8), (m0 + 8, k0 + 8)
    ldmatrix_x4(a, c + (m0 + r + 8 * (q & 1)) * ld + k0 + 8 * (q >> 1));
#pragma unroll
    for (int j = 0; j + 1 < NT; j += 2) {
      uint32_t bb[4];  // blocks (8j, k0), (8j, k0 + 8), (8j + 8, k0), (8j + 8, k0 + 8)
      ldmatrix_x4(bb, b + (8 * j + r + 8 * (q >> 1)) * ld + k0 + 8 * (q & 1));
      mma_bf16(acc[j], a, bb[0], bb[1]);
      mma_bf16(acc[j + 1], a, bb[2], bb[3]);
    }
    if (NT % 2) {
      uint32_t bb[2];  // blocks (8j, k0), (8j, k0 + 8) of the last tile
      ldmatrix_x2(bb, b + (8 * (NT - 1) + r) * ld + k0 + 8 * (q & 1));
      mma_bf16(acc[NT - 1], a, bb[0], bb[1]);
    }
  }
}
template <int NT>
__device__ __forceinline__ void cbt(float (*acc)[4], const float* c, const float* b, int ld,
                                    int m0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < SS_N; k0 += 8) {
    uint32_t v[4], ah[4], al[4];
    ld_pair(c + (m0 + g) * ld + k0 + 2 * t, v[0], v[2]);
    ld_pair(c + (m0 + g + 8) * ld + k0 + 2 * t, v[1], v[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(v[e], ah[e], al[e]);
    uint32_t w[8][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) ld_pair(b + (8 * j + g) * ld + k0 + 2 * t, w[j][0], w[j][1]);
    mma_tiles<false, false, NT>(acc, ah, al, w);
  }
}

// y[i] (16 x 8, columns p0 + 8i, i < NP) += G . X over the steps 8j.. of G's
// column tiles j < NT, x's rows; gv(j, e) is element e of G's C-layout tile j
template <int NT, int NP, typename T, typename GV>
__device__ __forceinline__ void gx(float (*y)[4], GV gv, const T* x, int p0, int lane) {
  constexpr bool EX = SsType<T>::EXACT;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float c[4] = {gv(j, 0), gv(j, 1), gv(j, 2), gv(j, 3)};
    uint32_t ah[4], al[4];
    a_from_acc(c, ah, al);
#pragma unroll
    for (int i = 0; i < NP; i += 4) {  // four tiles at a time: fewer live fragments
      uint32_t xv[4][2];
      ld_cols<false>(x, SsType<T>::LDX, 8 * j, p0 + 8 * i, lane, xv);
      mma_tiles<false, EX, 4>(y + i, ah, al, xv);
    }
  }
}

// f(IntTag<NT>) with NT = 2 (wm + 1), the column tiles of row tile wm up to the
// diagonal: each row tile's products compiled with their own trip counts
template <int N>
struct IntTag {
  static constexpr int value = N;
};
template <typename F>
__device__ __forceinline__ void with_nt(int wm, F f) {
  switch (wm) {
    case 0: f(IntTag<2>{}); break;
    case 1: f(IntTag<4>{}); break;
    case 2: f(IntTag<6>{}); break;
    default: f(IntTag<8>{}); break;
  }
}

// decay mask of G: s <= l ? exp(min(acum_l - acum_s, 0)) : 0, by ex2.approx
// (a few ulp; the exact expf made the carried kernel 2-4% slower)
__device__ __forceinline__ float decay(const float* acum, float acum_l, int l, int s) {
  return s <= l ? __expf(fminf(acum_l - acum[s], 0.f)) : 0.f;
}

// one block per (batch, head); b_sb, b_sl, c_sb, c_sl: batch and row strides
// of b and c in elements; 8 warps as 4 row tiles (wm) x 2 halves (wn)
template <typename T, bool SUM>
__global__ void __launch_bounds__(SS_THREADS, 3 - SsType<T>::STAGES)
ssd_carried(const T* __restrict__ x, const T* __restrict__ a, const T* __restrict__ bm,
            const T* __restrict__ cm, T* __restrict__ y, float* __restrict__ ysum, int part,
            long long b_sb, long long b_sl, long long c_sb, long long c_sl, int L, int H) {
  using S = SsType<T>;
  constexpr bool EX = S::EXACT;
  constexpr int LDX = S::LDX, LDN = S::LDN, TILE = ss_tile_elems<T>(), ST = S::STAGES;
  extern __shared__ __align__(16) unsigned char ss_raw[];
  T* tiles = reinterpret_cast<T*>(ss_raw);  // [ST][x Q x LDX, B Q x LDN, C Q x LDN]
  float* sYo = reinterpret_cast<float*>(ss_raw + ST * TILE * sizeof(T));  // [2][P][LDY]
  float* sGx = sYo + 2 * SS_P * SS_LDY;   // [Q][LDY]
  float* sVec = sGx + SS_Q * SS_LDY;      // [2][acum, w, e][Q]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1, m0 = 16 * wm;
  const long long row = (long long)H * SS_P;  // elements between two steps of x and y
  const int nc = L / SS_Q;
  // this block's batch row and head, and so its offsets into x, y and a;
  // with one stage worked out where they are used from an opaque copy of
  // blockIdx: held across the chunk loop they took registers that two blocks
  // per SM lack (with two stages the f32 kernel ran 9% slower that way)
  auto row_head = [&](long long& bi, long long& off) {
    unsigned bx = blockIdx.x;
    if (ST == 1) asm volatile("" : "+r"(bx));
    bi = bx / H;
    off = bi * L * H + bx % H;  // of step 0 in a; x and y: times P
  };
  auto stage = [&](int c) {
    long long bi, off;
    row_head(bi, off);
    T* d = tiles + (c % ST) * TILE;
    const long long l0 = (long long)c * SS_Q;
    stage_tile64<SS_P>(d, LDX, x + off * SS_P + l0 * row, row);
    stage_tile64<SS_N>(d + SS_Q * LDX, LDN, bm + bi * b_sb + l0 * b_sl, b_sl);
    stage_tile64<SS_N>(d + SS_Q * LDX + SS_Q * LDN, LDN, cm + bi * c_sb + l0 * c_sl, c_sl);
  };

  // this warp's 16 x 64 tile of the state: rows p = m0.., columns n = 64 wn..
  float st[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
  // warp 0: chunk c's decay vectors into stage c % 2. Its log-decays are
  // loaded a chunk ahead into a0, a1 with two stages (one block per SM hides
  // no load latency); with one, where two more registers would spill, here.
  float a0 = 0.f, a1 = 0.f;
  auto load_a = [&](int c) {
    long long bi, off;
    row_head(bi, off);
    const T* ac = a + off + (long long)c * SS_Q * H;
    a0 = ld1(ac + (long long)lane * H);
    a1 = ld1(ac + (long long)(lane + 32) * H);
  };
  auto decays = [&](int c) {
    if (ST == 1) load_a(c);
    warp_scan64(a0, a1, lane);
    const float last = __shfl_sync(0xffffffffu, a1, 31);
    float* v = sVec + (c & 1) * 3 * SS_Q;
    v[lane] = a0;
    v[lane + 32] = a1;
    v[SS_Q + lane] = expf(last - a0);
    v[SS_Q + lane + 32] = expf(last - a1);
    v[2 * SS_Q + lane] = expf(a0);
    v[2 * SS_Q + lane + 32] = expf(a1);
    if (ST == 2 && c + 1 < nc) load_a(c + 1);
  };
  stage(0);
  cp_async_commit();
  if (warp == 0) {
    if (ST == 2) load_a(0);
    decays(0);
  }

  for (int c = 0; c < nc; ++c) {
    if (ST == 2) {
      if (c + 1 < nc) stage(c + 1);  // into the buffer chunk c - 1 left
      cp_async_commit();
    }
    const float* vec = sVec + (c & 1) * 3 * SS_Q;
    const float* acum = vec;          // prefix sums of a
    const float* w = vec + SS_Q;      // exp(acum_last - acum)
    const float* ex = vec + 2 * SS_Q;  // exp(acum)
    cp_async_wait<ST - 1>();
    __syncthreads();  // chunk c's tiles and decays are in
    const T* sx = tiles + (c % ST) * TILE;
    const T* sb = sx + SS_Q * LDX;
    const T* sc = sb + SS_Q * LDN;

    if (c > 0) {
      // state . C^T over this warp's half of n: rows p = m0.., columns l
      float yo[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) yo[i][e] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // steps n = 64 wn + 8j..
        uint32_t ah[4], al[4];
        a_from_acc(st[j], ah, al);
#pragma unroll
        for (int i = 0; i < 8; i += 4) {  // columns l = 8i.., four tiles at a time
          uint32_t v[4][2];
          ld_rows(sc, LDN, 8 * i, 64 * wn + 8 * j, lane, v);
          mma_tiles<false, EX, 4>(yo + i, ah, al, v);
        }
      }
      float* dst = sYo + wn * SS_P * SS_LDY;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(dst + (m0 + g + 8 * hf) * SS_LDY + 8 * i + 2 * t) =
              make_float2(yo[i][2 * hf], yo[i][2 * hf + 1]);
    }

    if (c + 1 < nc) {
      // state = exp(acum_last) * state + (w * X)^T . B
      const float dk = ex[SS_Q - 1];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] *= dk;
#pragma unroll
      for (int k0 = 0; k0 < SS_Q; k0 += 16) {
        uint32_t xa[4][2];  // X[k0 (+8) + 2t (+1)][m0 (+8) + g]
        ld_cols<true>(sx, LDX, k0, m0, lane, xa);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const int kk = k0 + 8 * ks;
          const float2 wv = *reinterpret_cast<const float2*>(w + kk + 2 * t);
          uint32_t ah[4], al[4];
          split_tf32(__float_as_uint(__uint_as_float(xa[2 * ks][0]) * wv.x), ah[0], al[0]);
          split_tf32(__float_as_uint(__uint_as_float(xa[2 * ks + 1][0]) * wv.x), ah[1], al[1]);
          split_tf32(__float_as_uint(__uint_as_float(xa[2 * ks][1]) * wv.y), ah[2], al[2]);
          split_tf32(__float_as_uint(__uint_as_float(xa[2 * ks + 1][1]) * wv.y), ah[3], al[3]);
#pragma unroll
          for (int i = 0; i < 8; i += 4) {  // four tiles at a time
            uint32_t bv[4][2];
            ld_cols<false>(sb, LDN, kk, 64 * wn + 8 * i, lane, bv);
            mma_tiles<false, EX, 4>(st + i, ah, al, bv);
          }
        }
      }
    }

    // G = C . B^T * decay, rows l = m0.., the steps s of this warp's half of
    // the column tiles up to the diagonal, kept in registers; its part of
    // G . X over all 64 columns p
    float yd[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) yd[i][e] = 0.f;
    with_nt(wm, [&](auto tag) {
      constexpr int NH = decltype(tag)::value / 2;
      const int s0 = 8 * NH * wn;
      float ga[NH][4];
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ga[j][e] = 0.f;
      cbt<NH>(ga, sc, sb + s0 * LDN, LDN, m0, lane);
      const float acl[2] = {acum[m0 + g], acum[m0 + g + 8]};
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ga[j][e] *=
              decay(acum, acl[e >> 1], m0 + g + 8 * (e >> 1), s0 + 8 * j + 2 * t + (e & 1));
      gx<NH, 8>(yd, [&](int j, int e) { return ga[j][e]; }, sx + s0 * LDX, 0, lane);
    });
    // each warp of the pair hands the other the half of its G . X partial
    // that the other stores
    auto hand = [&](auto tag) {
      constexpr int I0 = decltype(tag)::value;
#pragma unroll
      for (int i = I0; i < I0 + 4; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(sGx + (m0 + g + 8 * hf) * SS_LDY + 8 * i + 2 * t) =
              make_float2(yd[i][2 * hf], yd[i][2 * hf + 1]);
    };
    if (wn == 0) hand(IntTag<4>{}); else hand(IntTag<0>{});
    // warp 0, whose G . X is the shortest: the next chunk's decays, into the
    // stage chunk c - 1 read before this chunk's first barrier
    if (warp == 0 && c + 1 < nc) decays(c + 1);
    __syncthreads();  // both halves of state . C^T and of G . X are in
    if (ST == 1 && c + 1 < nc) {  // every warp is done with the tiles
      stage(c + 1);
      cp_async_commit();
    }

    // y = G . X (both halves) + exp(acum_l) * (state . C^T)^T (both halves),
    // columns p = 32 wn..
    long long bi, yoff;
    row_head(bi, yoff);
    auto store = [&](auto tag) {
      constexpr int I0 = decltype(tag)::value;
#pragma unroll
      for (int i = I0; i < I0 + 4; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int l = m0 + g + 8 * hf, p = 8 * i + 2 * t;
          const float2 o = *reinterpret_cast<const float2*>(sGx + l * SS_LDY + p);
          float v0 = yd[i][2 * hf] + o.x, v1 = yd[i][2 * hf + 1] + o.y;
          if (c > 0) {
            const float* y0 = sYo + p * SS_LDY + l;
            const float* y1 = y0 + SS_P * SS_LDY;
            v0 += ex[l] * (y0[0] + y1[0]);
            v1 += ex[l] * (y0[SS_LDY] + y1[SS_LDY]);
          }
          put_y<SUM>(y, ysum, yoff * SS_P + ((long long)c * SS_Q + l) * row + p, part, v0, v1);
        }
    };
    if (wn == 0) store(IntTag<0>{}); else store(IntTag<4>{});
  }
}

// L = 64: one block per batch row, looping over the heads
template <typename T, bool SUM>
__global__ void __launch_bounds__(SS_THREADS, 2)
ssd_rows(const T* __restrict__ x, const T* __restrict__ a, const T* __restrict__ bm,
         const T* __restrict__ cm, T* __restrict__ y, float* __restrict__ ysum, int part,
         long long b_sb, long long b_sl, long long c_sb, long long c_sl, int H) {
  using S = SsType<T>;
  constexpr int LDX = S::LDX, LDN = S::LDN;
  extern __shared__ __align__(16) unsigned char ss_raw[];
  T* sb = reinterpret_cast<T*>(ss_raw);  // [Q][LDN]
  T* sc = sb + SS_Q * LDN;               // [Q][LDN]
  T* sxs = sc + SS_Q * LDN;              // [2][Q][LDX]
  float* sAc = reinterpret_cast<float*>(sxs + 2 * SS_Q * LDX);  // [HG][Q]

  const long long bi = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1, m0 = 16 * wm;
  const long long row = (long long)H * SS_P;
  const T* xg = x + bi * SS_Q * row;
  const T* ag = a + bi * SS_Q * H;

  stage_tile64<SS_N>(sb, LDN, bm + bi * b_sb, b_sl);
  stage_tile64<SS_N>(sc, LDN, cm + bi * c_sb, c_sl);
  stage_tile64<SS_P>(sxs, LDX, xg, row);
  cp_async_commit();
  float ga[8][4];  // C . B^T, rows l = m0.., shared by the heads
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ga[j][e] = 0.f;

  for (int h = 0; h < H; ++h) {
    if (h + 1 < H)
      stage_tile64<SS_P>(sxs + ((h + 1) & 1) * SS_Q * LDX, LDX, xg + (h + 1) * SS_P, row);
    cp_async_commit();
    if (h % SS_HG == 0 && h + warp < H) {  // the decay sums of heads h..h+7, a warp each
      float a0 = ld1(ag + (long long)lane * H + h + warp);
      float a1 = ld1(ag + (long long)(lane + 32) * H + h + warp);
      warp_scan64(a0, a1, lane);
      sAc[warp * SS_Q + lane] = a0;
      sAc[warp * SS_Q + lane + 32] = a1;
    }
    cp_async_wait<1>();
    __syncthreads();  // head h's x (and at h = 0 B and C) and the decays are in
    if (h == 0)
      with_nt(wm, [&](auto tag) { cbt<decltype(tag)::value>(ga, sc, sb, LDN, m0, lane); });
    const float* acum = sAc + (h % SS_HG) * SS_Q;
    const float acl[2] = {acum[m0 + g], acum[m0 + g + 8]};
    float ya[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[i][e] = 0.f;
    with_nt(wm, [&](auto tag) {
      gx<decltype(tag)::value, 4>(
          ya,
          [&](int j, int e) {
            return ga[j][e] *
                   decay(acum, acl[e >> 1], m0 + g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1));
          },
          sxs + (h & 1) * SS_Q * LDX, 32 * wn, lane);
    });
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int l = m0 + g + 8 * hf;
        put_y<SUM>(y, ysum, bi * SS_Q * row + l * row + h * SS_P + 32 * wn + 8 * i + 2 * t,
                   part, ya[i][2 * hf], ya[i][2 * hf + 1]);
      }
    __syncthreads();  // every warp is done with head h's x and decays
  }
}

}  // namespace sesa

using namespace sesa;

template <typename T>
static int launch_ssd(const void* x, const void* a, const void* b, const void* c, void* y,
                      void* ysum, int part, long long b_sb, long long b_sl, long long c_sb,
                      long long c_sl, int batch, int L, int H, int rows, int smem,
                      long long grid, cudaStream_t s) {
  if (batch < 1 || H < 1 || L < SS_Q || L % SS_Q || (rows && L != SS_Q) || part < 0 ||
      part > 3 || (part != 0 && (ysum == nullptr || ysum == y)))
    return (int)cudaErrorInvalidValue;
  const long long want_grid = rows ? (long long)batch : (long long)batch * H;
  const int want_smem = rows ? ss_rows_smem<T>() : ss_carried_smem<T>();
  if (grid != want_grid || grid > 0x7fffffffLL || smem != want_smem)
    return (int)cudaErrorInvalidValue;
  const T *xt = (const T*)x, *at = (const T*)a, *bt = (const T*)b, *ct = (const T*)c;
  if (rows) {
    auto kernel = part ? ssd_rows<T, true> : ssd_rows<T, false>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    kernel<<<(unsigned)grid, SS_THREADS, smem, s>>>(xt, at, bt, ct, (T*)y, (float*)ysum, part,
                                                     b_sb, b_sl, c_sb, c_sl, H);
  } else {
    auto kernel = part ? ssd_carried<T, true> : ssd_carried<T, false>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    kernel<<<(unsigned)grid, SS_THREADS, smem, s>>>(xt, at, bt, ct, (T*)y, (float*)ysum, part,
                                                     b_sb, b_sl, c_sb, c_sl, L, H);
  }
  return (int)cudaGetLastError();
}

extern "C" {

// y (B, L, H, 64) from x (B, L, H, 64), a (B, L, H), both contiguous, and
// b, c (B, L, 128), a 128-column slice of the state's columns, with the
// given batch and row strides in elements; all f32, or all bf16 when
// is_bf16; L a multiple of 64. part: this slice's place in the f32 sum
// ysum (B, L, H, 64) over the slices (put_y; 0: one slice, ysum unused).
// rows, smem and grid are the wrapper's plan (ops/ssd.py k8_plan): the
// one-chunk kernel (rows = 1, L = 64, a block per batch row) or the carried
// one (a block per batch row and head); a plan that does not match the
// kernel's is refused
int sesa_ssd(const void* x, const void* a, const void* b, const void* c, void* y, void* ysum,
             int part, long long b_sb, long long b_sl, long long c_sb, long long c_sl,
             int batch, int L, int H, int is_bf16, int rows, int smem, long long grid,
             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_ssd<bf16>(x, a, b, c, y, ysum, part, b_sb, b_sl, c_sb, c_sl, batch, L, H,
                            rows, smem, grid, s);
  return launch_ssd<float>(x, a, b, c, y, ysum, part, b_sb, b_sl, c_sb, c_sl, batch, L, H,
                           rows, smem, grid, s);
}

}  // extern "C"
