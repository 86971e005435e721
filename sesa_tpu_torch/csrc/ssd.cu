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
// Bound on the H100: f32 operations at the 67 TFLOP/s of the f32 pipes, or
// bytes. The function needs per sequence row C . B^T once for the heads
// together (2 * Q * N), per head the masked product with X (2 * Q * P) and,
// in every chunk but the first and but the last respectively, the two state
// products (2 * N * P each). At the band_rnn shape (B 684, L 704 = 11 chunks,
// H 8) that is 1.54e11 FLOP, 2.30 ms, against 1.24 GB of bf16 traffic (0.37
// ms; f32 0.74 ms). At band_comm (B 8280, L 64, one chunk, no state product)
// it is 4.3e10 FLOP, 0.65 ms, against 1.37 GB in bf16 (0.41 ms) and 2.73 GB
// in f32 (0.82 ms: f32 is bound by bytes there).
//
// Design. The TPU kernel batches all heads of a batch row into one program
// and walks the chunks on a sequential grid. Here the heads are independent
// apart from sharing B and C, so one block of 8 warps takes one (batch,
// head) pair and walks its chunks in a loop, the 64 x 128 f32 state living
// in the accumulator registers of its update product across the whole
// sequence (a copy in shared memory feeds the next chunk's C . state^T).
// C . B^T is therefore recomputed by each of a row's heads (+25% work); the
// heads of a row are neighbours in the grid, so B and C come from L2.
// The prefix sum is a warp scan (the TPU kernel multiplies by a triangular
// matrix because Mosaic has no cumsum). The four products per chunk run on
// the tensor cores as 3xTF32: each f32 operand is split into a TF32 high
// part and a TF32 low part, and a . b is summed as a_lo . b_hi + a_hi . b_lo
// + a_hi . b_hi in the f32 accumulators, which keeps about 21 bits of each
// operand (a plain TF32 or bf16 product would not be the same function).
// Above the diagonal the decay matrix is zero: its tiles are not computed,
// and G . X stops at the diagonal tile. The last chunk updates no state.
//
// Shared memory per block (f32): x 64 x 72, B and C 64 x 132 each (C's
// buffer is reused for the masked C . B^T), the state 64 x 132, three
// 64-vectors: 120,576 bytes, one block per SM. The row pads (4 mod 32 for
// operands read along their rows, 8 mod 32 for x, read down its columns)
// keep the fragment loads free of bank conflicts, except B in the state
// update (two-way).
#include "common.cuh"

namespace sesa {

constexpr int SS_Q = 64, SS_P = 64, SS_N = 128, SS_THREADS = 256;
constexpr int SS_LDN = SS_N + 4, SS_LDP = SS_P + 8, SS_LDG = SS_Q + 4;
constexpr int SS_SMEM_FLOATS = SS_Q * SS_LDP + 2 * SS_Q * SS_LDN + SS_P * SS_LDN + 3 * SS_Q;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const bf16* p) { return bf2f(*p); }
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}

// x = hi + lo with hi and lo representable in TF32 (up to 2^-22 |x|)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// m16n8k8, TF32 operands, f32 sums. With g = lane / 4 and t = lane % 4:
//   A (16x8, row): a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//   B (8x8, col):  b0 (k t, n g)   b1 (k t+4, n g)
//   C (16x8):      c0, c1 (g, 2t..2t+1)   c2, c3 (g+8, 2t..2t+1)
__device__ __forceinline__ void mma_tf32_1688(float c[4], const uint32_t a[4],
                                              const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc (16 x 8 NT, C layout) += A (16 x k_len) . B (k_len x 8 NT) as 3xTF32;
// a_at(m, k) and b_at(k, n) read f32 operands from shared memory
template <int NT, typename FA, typename FB>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], int k_len, FA a_at, FB b_at,
                                          int g, int t) {
  for (int k0 = 0; k0 < k_len; k0 += 8) {
    uint32_t ah[4], al[4];
    split_tf32(a_at(g, k0 + t), ah[0], al[0]);
    split_tf32(a_at(g + 8, k0 + t), ah[1], al[1]);
    split_tf32(a_at(g, k0 + t + 4), ah[2], al[2]);
    split_tf32(a_at(g + 8, k0 + t + 4), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bh[2], bl[2];
      split_tf32(b_at(k0 + t, j * 8 + g), bh[0], bl[0]);
      split_tf32(b_at(k0 + t + 4, j * 8 + g), bh[1], bl[1]);
      mma_tf32_1688(acc[j], al, bh);  // the small terms first
      mma_tf32_1688(acc[j], ah, bl);
      mma_tf32_1688(acc[j], ah, bh);
    }
  }
}

// one block per (batch, head); b_sb, b_sl, c_sb, c_sl: batch and row strides
// of b and c in elements
template <typename T>
__global__ void __launch_bounds__(SS_THREADS, 1)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ a, const T* __restrict__ bm,
           const T* __restrict__ cm, T* __restrict__ y, long long b_sb, long long b_sl,
           long long c_sb, long long c_sl, int L, int H) {
  extern __shared__ __align__(16) float ss_smem[];
  float* sX = ss_smem;                // [Q][LDP]  x of the chunk
  float* sB = sX + SS_Q * SS_LDP;     // [Q][LDN]
  float* sC = sB + SS_Q * SS_LDN;     // [Q][LDN], then the masked C . B^T as [Q][LDG]
  float* sS = sC + SS_Q * SS_LDN;     // [P][LDN]  the state at the start of the chunk
  float* sAcum = sS + SS_P * SS_LDN;  // [Q] inclusive prefix sums of a
  float* sW = sAcum + SS_Q;           // [Q] exp(acum_last - acum)
  float* sE = sW + SS_Q;              // [Q] exp(acum)
  float* sG = sC;

  const int h = blockIdx.x % H;
  const long long bi = blockIdx.x / H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1, m0 = wm * 16;  // 4 x 2 warps
  const long long row = (long long)H * SS_P;  // elements between two steps of x and y
  const T* xg = x + (bi * L * H + h) * SS_P;
  T* yg = y + (bi * L * H + h) * SS_P;
  const T* ag = a + bi * L * H + h;
  const T* bg = bm + bi * b_sb;
  const T* cg = cm + bi * c_sb;

  // this warp's 16 x 64 tile of the state: rows p = m0.., columns n = 64 wn..
  float st[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[j][e] = 0.f;

  for (int l0 = 0; l0 < L; l0 += SS_Q) {
    __syncthreads();  // the previous chunk's products are done with the tiles
    for (int i = tid; i < SS_Q * SS_P / 4; i += SS_THREADS) {
      const int r = i / (SS_P / 4), c4 = (i % (SS_P / 4)) * 4;
      *reinterpret_cast<float4*>(sX + r * SS_LDP + c4) = ld4(xg + (l0 + r) * row + c4);
    }
    for (int i = tid; i < SS_Q * SS_N / 4; i += SS_THREADS) {
      const int r = i / (SS_N / 4), c4 = (i % (SS_N / 4)) * 4;
      *reinterpret_cast<float4*>(sB + r * SS_LDN + c4) = ld4(bg + (l0 + r) * b_sl + c4);
      *reinterpret_cast<float4*>(sC + r * SS_LDN + c4) = ld4(cg + (l0 + r) * c_sl + c4);
    }
    if (warp == 0) {  // prefix sum of the chunk's 64 log-decays: two 32-lane scans
      float a0 = ld1(ag + (long long)(l0 + lane) * H);
      float a1 = ld1(ag + (long long)(l0 + 32 + lane) * H);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, a0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, a1, o);
        if (lane >= o) { a0 += u0; a1 += u1; }
      }
      a1 += __shfl_sync(0xffffffffu, a0, 31);
      const float a_last = __shfl_sync(0xffffffffu, a1, 31);
      sAcum[lane] = a0; sAcum[lane + 32] = a1;
      sW[lane] = expf(a_last - a0); sW[lane + 32] = expf(a_last - a1);
      sE[lane] = expf(a0); sE[lane + 32] = expf(a1);
    }
    __syncthreads();

    // G = C . B^T, rows l = m0.., columns s = 32 wn..; tiles above the
    // diagonal stay zero
    float gacc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[j][e] = 0.f;
    if (wn * 32 <= m0 + 15) {
      warp_gemm<4>(gacc, SS_N,
                   [&](int m, int k) { return sC[(m0 + m) * SS_LDN + k]; },
                   [&](int k, int n) { return sB[(wn * 32 + n) * SS_LDN + k]; }, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int l = m0 + g + (e >> 1) * 8, s = wn * 32 + j * 8 + 2 * t + (e & 1);
          gacc[j][e] = s <= l ? gacc[j][e] * expf(fminf(sAcum[l] - sAcum[s], 0.f)) : 0.f;
        }
    }
    // Y = exp(acum_l) * C . state^T, rows l = m0.., columns p = 32 wn..
    float yacc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;
    if (l0 > 0) {
      warp_gemm<4>(yacc, SS_N,
                   [&](int m, int k) { return sC[(m0 + m) * SS_LDN + k]; },
                   [&](int k, int n) { return sS[(wn * 32 + n) * SS_LDN + k]; }, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[j][e] *= sE[m0 + g + (e >> 1) * 8];
    }
    __syncthreads();  // every warp is done with C: G takes its buffer
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        st2(sG + (m0 + g + half * 8) * SS_LDG + wn * 32 + j * 8 + 2 * t, gacc[j][2 * half],
            gacc[j][2 * half + 1]);
    __syncthreads();

    // Y += G . X over the steps s up to the tile's last row
    warp_gemm<4>(yacc, m0 + 16,
                 [&](int m, int k) { return sG[(m0 + m) * SS_LDG + k]; },
                 [&](int k, int n) { return sX[k * SS_LDP + wn * 32 + n]; }, g, t);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        st2(yg + (l0 + m0 + g + half * 8) * row + wn * 32 + j * 8 + 2 * t, yacc[j][2 * half],
            yacc[j][2 * half + 1]);

    if (l0 + SS_Q < L) {
      // state = exp(acum_last) * state + (w * X)^T . B, and its copy for the
      // next chunk (nothing reads sS before the next chunk's barriers)
      const float decay = sE[SS_Q - 1];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] *= decay;
      warp_gemm<8>(st, SS_Q,
                   [&](int m, int k) { return sX[k * SS_LDP + m0 + m] * sW[k]; },
                   [&](int k, int n) { return sB[k * SS_LDN + wn * 64 + n]; }, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          st2(sS + (m0 + g + half * 8) * SS_LDN + wn * 64 + j * 8 + 2 * t, st[j][2 * half],
              st[j][2 * half + 1]);
    }
  }
}

}  // namespace sesa

using namespace sesa;

template <typename T>
static int launch_ssd(const void* x, const void* a, const void* b, const void* c, void* y,
                      long long b_sb, long long b_sl, long long c_sb, long long c_sl,
                      int batch, int L, int H, cudaStream_t s) {
  constexpr int smem = SS_SMEM_FLOATS * 4;
  cudaFuncSetAttribute(ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const long long blocks = (long long)batch * H;
  if (blocks < 1 || blocks > 0x7fffffffLL || L % SS_Q) return (int)cudaErrorInvalidValue;
  ssd_kernel<T><<<(unsigned)blocks, SS_THREADS, smem, s>>>(
      (const T*)x, (const T*)a, (const T*)b, (const T*)c, (T*)y, b_sb, b_sl, c_sb, c_sl, L, H);
  return (int)cudaGetLastError();
}

extern "C" {

// y (B, L, H, 64) from x (B, L, H, 64), a (B, L, H), both contiguous, and
// b, c (B, L, 128) with the given batch and row strides in elements; all
// f32, or all bf16 when is_bf16; L a multiple of 64
int sesa_ssd(const void* x, const void* a, const void* b, const void* c, void* y,
             long long b_sb, long long b_sl, long long c_sb, long long c_sl, int batch, int L,
             int H, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_ssd<bf16>(x, a, b, c, y, b_sb, b_sl, c_sb, c_sl, batch, L, H, s);
  return launch_ssd<float>(x, a, b, c, y, b_sb, b_sl, c_sb, c_sl, batch, L, H, s);
}

}  // extern "C"
