// I8: int8 attention, the SageAttention analogue, on Hopper.
//
// Replaces no Pallas kernel: sesa_tpu/ops/attention.py sdpa_int8 is plain
// JAX (an int8 dot_general that XLA lowers to the TPU's int8 matrix path).
// It stands beside K3 as the hand-written form of the port's sdpa_int8,
// which SESA_INT8_ATTN=1 routes every roformer attention through. The
// arithmetic and its rounding points are JAX's:
//   km = mean(k over the sequence), summed in f32, rounded to bf16;
//   kc = k - km in bf16;
//   per row of q and kc: s = max(max|x| / 127, 1e-8) in f32 and the codes
//   clip(round_half_even(x / s), -127, 127) (an IEEE divide);
//   sim = f32(q8 . k8^T) * (qs * ks^T) * scale, in that order;
//   p = exp(sim - max) / sum in f32, rounded to bf16; o = p . v in bf16 with
//   f32 sums, rounded once.
//
// Bound on the H100: bytes. At the flagship's legs (BH 2976 x n 690 and
// 33120 x 62, D 64) q, k, v and o are 1.05 GB, 0.31 ms at 3.35 TB/s; the
// int8 product (2 * BH * n^2 * D ops, 0.09 ms at 1979 TOPS on the time leg)
// and the bf16 P . V (0.18 ms at 989 TFLOP/s) lie below it.
//
// Design: two kernels.
// - quantise: one block per (b, h) sequence. The k mean by columns, then one
//   warp per row writes the row's int8 codes (zero-padded to DH, a multiple
//   of 32, so the padded product is exact) and its f32 scale. A non-finite
//   input makes its row's scale non-finite (a NaN-propagating max), so the
//   output carries it, as JAX's does: the session's bf16 -> f32 rescue must
//   see it.
// - attention: one block of 4 warps per (sequence, 64-query tile), each
//   warp 16 query rows with its q codes held as mma fragments. QK^T is
//   mma.sync.m16n8k32 s8 x s8 -> s32, exact. Two passes over the key tiles:
//   the first keeps each row's running max and sum of expf (online
//   rescaling), the second recomputes the cheap int8 product, forms
//   p = expf(s - max) / sum in f32, rounds it to bf16 and runs P . V as
//   mma.sync m16n8k16 bf16 into f32. Normalising before rounding is where
//   JAX rounds p; an online softmax would round it unnormalised. Key tiles
//   (codes and scales, then V) are double-buffered through cp.async; keys
//   at or past n are masked (score -inf, V rows zero-filled).
// The simple form: no TMA, no wgmma, no persistence.
#include "common.cuh"

using namespace sesa;

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 128;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;  // NaN in a propagates; b's is kept below
}

__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Strides {
  long long b, h, s;  // elements
};

// One block per sequence (blockIdx.x = b * heads + h), 256 threads.
template <int DH>
__global__ void __launch_bounds__(256) quantise_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, Strides qs_, Strides ks_,
    int heads, int n, int d, int8_t* __restrict__ q8, int8_t* __restrict__ k8,
    float* __restrict__ qscale, float* __restrict__ kscale) {
  __shared__ float part[2][128];
  __shared__ float km[128];
  const int seq = blockIdx.x, bi = seq / heads, hi = seq % heads;
  const bf16* qg = q + bi * qs_.b + hi * qs_.h;
  const bf16* kg = k + bi * ks_.b + hi * ks_.h;
  const int tid = threadIdx.x, col = tid & 127, half = tid >> 7;
  // the k mean: two partial f32 sums per column, then sum / n rounded to bf16
  float acc = 0.f;
  if (col < d)
    for (int r = half; r < n; r += 2) acc += bf2f(kg[(long long)r * ks_.s + col]);
  part[half][col] = acc;
  __syncthreads();
  if (tid < 128) km[tid] = tid < d ? rbf((part[0][tid] + part[1][tid]) / (float)n) : 0.f;
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  constexpr int PER = DH / 32;  // columns per lane
  for (int row = warp; row < 2 * n; row += 8) {
    const bool is_k = row >= n;
    const int r = is_k ? row - n : row;
    const bf16* src = is_k ? kg + (long long)r * ks_.s : qg + (long long)r * qs_.s;
    float x[PER];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      float v = 0.f;
      if (c < d) {
        v = bf2f(src[c]);
        if (is_k) v = rbf(v - km[c]);
      }
      x[i] = v;
      amax = nan_max(fabsf(v), amax);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float s = nan_max(amax / 127.0f, 1e-8f);
    int8_t* dst = (is_k ? k8 : q8) + ((long long)seq * n + r) * DH;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float code = fminf(fmaxf(rintf(__fdiv_rn(x[i], s)), -127.f), 127.f);
      dst[lane + 32 * i] = (int8_t)(int)code;
    }
    if (lane == 0) (is_k ? kscale : qscale)[(long long)seq * n + r] = s;
  }
}

// shared-memory rows: codes at DH + 16 bytes, V at (DH + 8) bf16, so the
// fragment loads of 8 rows fall in distinct banks
template <int DH>
struct Smem {
  static constexpr int K_LD = DH + 16, V_LD = DH + 8;
  static constexpr int K_BYTES = BK * K_LD, S_BYTES = BK * 4, V_BYTES = BK * V_LD * 2;
  static constexpr int STAGE = K_BYTES + S_BYTES + V_BYTES;
  static constexpr int TOTAL = 2 * STAGE;
};

// key tile kt's codes and scales (and with V its values) into stage buf;
// rows at or past n: codes and scales repeat row n - 1 (masked later), V is
// zero (p is 0 there, and a zero row keeps 0 * V finite)
template <int DH>
__device__ __forceinline__ void stage_keys(char* smem, int buf, const int8_t* k8,
                                           const float* ks, const bf16* vg, long long v_ld,
                                           int d, int n, int kt, bool with_v) {
  using S = Smem<DH>;
  char* base = smem + buf * S::STAGE;
  const int k0 = kt * BK;
  constexpr int KC = DH / 16;  // 16-byte chunks of a code row
  for (int c = threadIdx.x; c < BK * KC; c += THREADS) {
    const int r = c / KC, off = (c % KC) * 16, key = min(k0 + r, n - 1);
    cp_async16(base + r * S::K_LD + off, k8 + (long long)key * DH + off);
  }
  // the scales by plain loads (the stage is free: a barrier ends each tile)
  float* sdst = reinterpret_cast<float*>(base + S::K_BYTES);
  for (int c = threadIdx.x; c < BK; c += THREADS) sdst[c] = ks[min(k0 + c, n - 1)];
  if (with_v) {
    bf16* vs = reinterpret_cast<bf16*>(base + S::K_BYTES + S::S_BYTES);
    constexpr int VC = DH / 8;  // 16-byte chunks of a V row
    const int real = (d + 7) / 8;
    for (int c = threadIdx.x; c < BK * VC; c += THREADS) {
      const int r = c / VC, ch = c % VC, key = k0 + r;
      const bool in = key < n && ch < real;
      cp_async16_zfill(vs + r * S::V_LD + ch * 8,
                       vg + (long long)(in ? key : 0) * v_ld + (in ? ch * 8 : 0), in ? 16 : 0);
    }
  }
}

// The scores of this warp's 16 rows against key tile buf: int8 product,
// dequantised as f32(acc) * (qs * ks) * scale, keys >= n at -inf.
template <int DH>
__device__ __forceinline__ void scores(const char* smem, int buf, const uint32_t (&qf)[DH / 32][4],
                                       const float (&qsc)[2], float scale, int k0, int n,
                                       float (&s)[BK / 8][4]) {
  using S = Smem<DH>;
  const char* base = smem + buf * S::STAGE;
  const float* ksc = reinterpret_cast<const float*>(base + S::K_BYTES);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    int acc[4] = {0, 0, 0, 0};
    const char* krow = base + (j * 8 + g) * S::K_LD;
#pragma unroll
    for (int kk = 0; kk < DH / 32; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 32 + 4 * t);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 32 + 16 + 4 * t);
      mma_s8_16832(acc, qf[kk], b0, b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kl = j * 8 + 2 * t + (e & 1);
      const float v = ((float)acc[e] * (qsc[e >> 1] * ksc[kl])) * scale;
      s[j][e] = (k0 + kl < n) ? v : -INFINITY;
    }
  }
}

// One block per (sequence, 64-query tile): blockIdx.x = seq * qtiles + tile.
template <int DH>
__global__ void __launch_bounds__(THREADS) attention_kernel(
    const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
    const float* __restrict__ qscale, const float* __restrict__ kscale,
    const bf16* __restrict__ v, Strides vs_, bf16* __restrict__ o, int heads, int n, int d,
    int qtiles, float scale) {
  extern __shared__ __align__(16) char smem[];
  const int seq = blockIdx.x / qtiles, tile = blockIdx.x % qtiles;
  const int bi = seq / heads, hi = seq % heads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int8_t* kq = k8 + (long long)seq * n * DH;
  const float* kss = kscale + (long long)seq * n;
  const bf16* vg = v + bi * vs_.b + hi * vs_.h;

  // this warp's rows r0 = q0 + 16 warp + g and r0 + 8 (past n: row n - 1,
  // computed and not stored), their codes as m16n8k32 A fragments
  const int r0 = tile * BQ + warp * 16 + g;
  const int rows[2] = {min(r0, n - 1), min(r0 + 8, n - 1)};
  uint32_t qf[DH / 32][4];
  float qsc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int8_t* qr = q8 + ((long long)seq * n + rows[r]) * DH;
#pragma unroll
    for (int kk = 0; kk < DH / 32; ++kk) {
      qf[kk][r] = *reinterpret_cast<const uint32_t*>(qr + kk * 32 + 4 * t);
      qf[kk][2 + r] = *reinterpret_cast<const uint32_t*>(qr + kk * 32 + 16 + 4 * t);
    }
    qsc[r] = qscale[(long long)seq * n + rows[r]];
  }

  const int n_tiles = (n + BK - 1) / BK;
  // pass 1: each row's max and sum of exp(s - max)
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  stage_keys<DH>(smem, 0, kq, kss, vg, vs_.s, d, n, 0, false);
  cp_async_commit();
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) stage_keys<DH>(smem, buf ^ 1, kq, kss, vg, vs_.s, d, n, kt + 1, false);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[BK / 8][4];
    scores<DH>(smem, buf, qf, qsc, scale, kt * BK, n, s);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = nan_max(s[j][e], mx[e >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = nan_max(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = nan_max(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) lsum[e >> 1] += expf(s[j][e] - mx[e >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
      // exp(-inf - m) = 0 on the first tile
      l_run[r] = l_run[r] * expf(m_run[r] - mx[r]) + lsum[r];
      m_run[r] = mx[r];
    }
    __syncthreads();  // this stage is refilled next
  }

  // pass 2: p = exp(s - max) / sum rounded to bf16, then P . V
  float acc[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  stage_keys<DH>(smem, 0, kq, kss, vg, vs_.s, d, n, 0, true);
  cp_async_commit();
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) stage_keys<DH>(smem, buf ^ 1, kq, kss, vg, vs_.s, d, n, kt + 1, true);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[BK / 8][4];
    scores<DH>(smem, buf, qf, qsc, scale, kt * BK, n, s);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = __fdiv_rn(expf(s[j][e] - m_run[e >> 1]), l_run[e >> 1]);
    const bf16* v_s = reinterpret_cast<const bf16*>(smem + buf * Smem<DH>::STAGE +
                                                    Smem<DH>::K_BYTES + Smem<DH>::S_BYTES);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int ii = 0; ii < DH / 16; ++ii) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, v_s + (kk * 16 + a_row) * Smem<DH>::V_LD + ii * 16 + a_col);
        mma_bf16_16816(acc[2 * ii], pa, r[0], r[1]);
        mma_bf16_16816(acc[2 * ii + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();
  }

  // store the real rows' first d columns, (b, h, n, d) contiguous
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= n) continue;
    bf16* dst = o + ((long long)seq * n + row) * d;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      const int c = 8 * i + 2 * t;
      if (c < d) dst[c] = f2bf(acc[i][2 * r]);
      if (c + 1 < d) dst[c + 1] = f2bf(acc[i][2 * r + 1]);
    }
  }
}

template <int DH>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int8_t* q8, int8_t* k8,
           float* qs, float* ks, Strides sq, Strides sk, Strides sv, int batch, int heads,
           int n, int d, float scale, cudaStream_t st) {
  const long long seqs = (long long)batch * heads;
  const int qtiles = (n + BQ - 1) / BQ;
  quantise_kernel<DH><<<(unsigned)seqs, 256, 0, st>>>(q, k, sq, sk, heads, n, d, q8, k8, qs, ks);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  constexpr int smem = Smem<DH>::TOTAL;
  cudaFuncSetAttribute(attention_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  attention_kernel<DH><<<(unsigned)(seqs * qtiles), THREADS, smem, st>>>(
      q8, k8, qs, ks, v, sv, o, heads, n, d, qtiles, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// o (batch, heads, n, d) contiguous = int8 attention of q, k, v, each read
// at element strides (b, h, s) with unit stride along d. v's strides are
// multiples of 8 and its base 16-byte aligned, and its rows hold a multiple
// of 8 readable values (the wrapper pads d otherwise). Scratch: q8 and k8
// (batch * heads * n * dh int8, dh = the core width 32, 64 or 128 that holds
// d), qs and ks (batch * heads * n f32). 1 <= d <= 128, n >= 1.
int sesa_int8_attn(const void* q, const void* k, const void* v, void* o, void* q8, void* k8,
                   void* qs, void* ks, long long qb, long long qh, long long qs_,
                   long long kb, long long kh, long long ks_, long long vb, long long vh,
                   long long vs, int batch, int heads, int n, int d, int dh, float scale,
                   void* stream) {
  const int want = d <= 32 ? 32 : d <= 64 ? 64 : 128;
  if (d < 1 || d > 128 || dh != want || n < 1 || batch < 1 || heads < 1 || !(scale > 0.f) ||
      vb % 8 || vh % 8 || vs % 8 || ((uintptr_t)v & 15) ||
      (long long)batch * heads * ((n + BQ - 1) / BQ) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Strides sq = {qb, qh, qs_}, sk = {kb, kh, ks_}, sv = {vb, vh, vs};
  cudaStream_t st = (cudaStream_t)stream;
  auto args = [&](auto launcher) {
    return launcher((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (int8_t*)q8,
                    (int8_t*)k8, (float*)qs, (float*)ks, sq, sk, sv, batch, heads, n, d,
                    scale, st);
  };
  if (dh == 32) return args(launch<32>);
  if (dh == 64) return args(launch<64>);
  return args(launch<128>);
}

}  // extern "C"
