// The Mamba-2 mixer's glue around kernel K8 on Hopper: two passes over the
// token rows in place of the thirty-odd PyTorch kernels that ran between the
// mixer's in and out projections.
//
// Replaces no TPU kernel: the JAX package (sesa_tpu/models/bs_mamba2.py
// mamba2_apply) leaves this glue to XLA, which fuses it around the Pallas
// scan. In PyTorch each step was a kernel of its own (a transposed, padded
// copy, the generic grouped conv, SiLU, reshapes, zero pads to whole chunks,
// x·dt, a·dt, the scan's slice copy, the D skip, the gate, the norm's
// reductions and products), each a pass through device memory.
//
// For zxbcdt = u @ in_proj^T (B, L, 2 D + 2 N + H) of d_inner D, state N and
// H heads of P = D / H columns, laid out [z | x | b | c | dt]:
// * conv_kernel (ops/mamba.py mamba_conv): the causal depthwise conv of the
//   xBC columns (4 taps, the bias) and SiLU, dt = softplus(dt + dt_bias) and
//   a = -exp(A_log), all in f32, writing K8's operands where ssd_fused takes
//   them without a copy: x·dt (B, Lp, H, P), a·dt (B, Lp, H), b and c (B, Lp,
//   1, N), with Lp = L rounded up to whole chunks and the steps from L to Lp
//   zero; and x (B, L, D) for the D skip.
// * gate_kernel (ops/mamba.py mamba_gate_norm): from K8's y (B, Lp, H, P),
//   x and the z columns, the gated RMSNorm (y + D·x) · SiLU(z) · rsqrt(mean
//   over D of its square + eps) · norm_w in f32, written as the (B, L, D) rows
//   the out projection reads.
// Each output is rounded to the input dtype (f32 or bf16) once.
//
// reverse: the backward direction of a bidirectional block scans the
// sequence from its end. The conv reads row L - 1 - t as scan step t (so it
// is causal in the reversed order), and the gate reads scan step L - 1 - r
// for row r: the flips of input and output are index arithmetic, and the in
// projection, a per-row product, runs on the unflipped rows.
//
// Bound on the H100: bytes; a few FLOPs per byte. Per token of TS-BS-Mamba2
// (D 512, N 128, H 8) in bf16 the conv reads the xBC and dt columns (1,552
// bytes) and writes x·dt, x, b, c and a·dt (2,576); the gate reads y, x and
// z (3,072) and writes the row (1,024). At 3.35 TB/s that is 2.45 ns a token
// for both. The padded steps add writes: band_rnn's 684 rows of 690 steps
// (padded to 704) and band_comm's 8,280 of 57 (padded to 64) need 0.59 and
// 0.61 ms a call for the conv, 0.58 for the gate.
//
// Design. Every load and store moves 8 consecutive channels (16 bytes in
// bf16, two 16-byte halves in f32); zxbcdt's rows are read as 16-byte vectors
// where their stride allows it (2,576 bytes at D 512: xBC starts at byte
// 1,024 of a row and dt at byte 2,560), else value by value (VEC false).
// * conv: a block stages SEG scan steps of one batch row, and the conv's 3
//   steps of halo, for up to CT channels of xBC in shared memory (16-byte
//   loads, all issued before any arithmetic: 53.8 KB a block in bf16, four
//   blocks an SM), with the tile's dt already through the softplus. A thread
//   then owns 8 channels over SLICE consecutive steps, its 32 taps and 8
//   biases in registers, and reads each step's 4 taps from the tile (a
//   window carried in registers took 118 of them and left 2 blocks an SM);
//   neighbouring threads take neighbouring channels, so a warp reads and
//   writes 512 contiguous bytes a step. The first thread of each head writes
//   a·dt.
// * gate: one warp a row, 8 channels a lane per 256 columns (VPL groups a
//   lane, in registers), the sum of squares reduced with shuffles.
//
// Names: the kernels live in namespace mamba_mixer. h100_bench attributes
// every sesa:: kernel to a family of h100_bench/kernels/, each with a launch
// counter; these two have none there yet and are read as the model's glue
// outside K8 (mamba_glue_ms_per_chunk).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mamba_mixer {

typedef __nv_bfloat16 bf16;

constexpr int TAPS = 4;    // the causal conv's width (d_conv)
constexpr int SEG = 32;    // scan steps a conv block stages
constexpr int SLICE = 16;  // of them, the steps a conv thread walks
constexpr int CT = 768;    // xBC channels a conv block stages: 96 groups of 8
constexpr int CONV_THREADS = CT / 8 * (SEG / SLICE);
constexpr int THREADS = 256;        // a gate block
constexpr int ROWS = THREADS / 32;  // gate rows a block, one a warp

__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const bf16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// 8 consecutive values as f32: 16-byte loads where VEC, else one at a time
template <bool VEC>
__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  if (VEC) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = ld1(p + i);
  }
}

template <bool VEC>
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  if (VEC) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = ld1(p + i);
  }
}

// outputs are fresh, 16-byte aligned allocations with 16-byte rows
__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// F.softplus at its default threshold of 20
__device__ __forceinline__ float softplus(float v) { return v > 20.f ? v : log1pf(expf(v)); }

// 8 consecutive values as f32 from 16-byte aligned memory (the conv's tile
// in shared memory)
__device__ __forceinline__ void read8(const bf16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void read8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename T>
__host__ __device__ constexpr int conv_tile_bytes() {
  return (SEG + TAPS - 1) * CT * (int)sizeof(T);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(CONV_THREADS, 4) conv_kernel(
    const T* __restrict__ zx, const T* __restrict__ w, const T* __restrict__ bias,
    const T* __restrict__ dt_bias, const T* __restrict__ a_log, T* __restrict__ xdt,
    T* __restrict__ adt, T* __restrict__ bo, T* __restrict__ co, T* __restrict__ xo, int L,
    int Lp, int ld, int di, int n, int heads, int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  // tile row r: scan step s0 - (TAPS - 1) + r of this block's ct channels
  T* tile = reinterpret_cast<T*>(smem);
  float* dts = reinterpret_cast<float*>(smem + conv_tile_bytes<T>());  // SEG x heads
  const int tiles = (Lp + SEG - 1) / SEG;
  const long long bi = blockIdx.x / tiles;
  const int s0 = (int)(blockIdx.x % tiles) * SEG;
  const int c0 = blockIdx.y * CT, ct = min(CT, di + 2 * n - c0);
  const T* rows = zx + bi * L * (long long)ld;
  auto src = [&](int s) { return rows + (long long)(reverse ? L - 1 - s : s) * ld; };

  // stage the xBC rows of the tile's steps and the conv's halo, 0 outside [0, L)
  if (VEC) {
    const int units = ct * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < (SEG + TAPS - 1) * units; i += CONV_THREADS) {
      const int r = i / units, u = i % units, s = s0 - (TAPS - 1) + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (s >= 0 && s < L) v = __ldg(reinterpret_cast<const uint4*>(src(s) + di + c0) + u);
      reinterpret_cast<uint4*>(tile + r * ct)[u] = v;
    }
  } else {
    for (int i = threadIdx.x; i < (SEG + TAPS - 1) * ct; i += CONV_THREADS) {
      const int r = i / ct, c = i % ct, s = s0 - (TAPS - 1) + r;
      if (s >= 0 && s < L)
        tile[i] = src(s)[di + c0 + c];
      else
        st1(tile + i, 0.f);
    }
  }
  if (c0 < di) {  // dt of the tile's steps, for the x columns
    for (int i = threadIdx.x; i < SEG * heads; i += CONV_THREADS) {
      const int h = i % heads, s = s0 + i / heads;
      dts[i] = s < L ? softplus(ld1(src(s) + 2 * di + 2 * n + h) + ld1(dt_bias + h)) : 0.f;
    }
  }
  __syncthreads();

  // a thread: 8 channels over SLICE steps, each step's 4 taps read from the tile
  const int g = threadIdx.x % (CT / 8), first = threadIdx.x / (CT / 8) * SLICE;
  if (8 * g >= ct) return;
  const int ch = c0 + 8 * g;  // column within xBC
  float wt[TAPS][8], b0[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    b0[q] = ld1(bias + ch + q);
#pragma unroll
    for (int k = 0; k < TAPS; ++k) wt[k][q] = ld1(w + (ch + q) * TAPS + k);
  }
  const bool is_x = ch < di;
  const int h = is_x ? ch / (di / heads) : 0;
  const bool writes_a = is_x && ch % (di / heads) == 0;
  const float a = -expf(ld1(a_log + h));
  for (int j = first; j < first + SLICE && s0 + j < Lp; ++j) {
    const int s = s0 + j;
    const long long orow = bi * Lp + s;
    float out[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) out[q] = b0[q];
    if (s < L) {
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        float v[8];
        read8(tile + (j + k) * ct + 8 * g, v);
#pragma unroll
        for (int q = 0; q < 8; ++q) out[q] = fmaf(wt[k][q], v[q], out[q]);
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) out[q] = silu(out[q]);
    } else {  // the chunk padding from L to Lp
#pragma unroll
      for (int q = 0; q < 8; ++q) out[q] = 0.f;
    }
    if (!is_x) {
      store8(ch < di + n ? bo + orow * n + ch - di : co + orow * n + ch - di - n, out);
      continue;
    }
    const float dt = dts[j * heads + h];  // 0 from L on
    if (s < L) store8(xo + (bi * L + s) * di + ch, out);
#pragma unroll
    for (int q = 0; q < 8; ++q) out[q] *= dt;
    store8(xdt + orow * di + ch, out);
    if (writes_a) st1(adt + orow * heads + h, s < L ? a * dt : 0.f);
  }
}

template <typename T, bool VEC, int VPL>
__global__ void __launch_bounds__(THREADS) gate_kernel(
    const T* __restrict__ y, const T* __restrict__ x, const T* __restrict__ zx,
    const T* __restrict__ d, const T* __restrict__ norm_w, T* __restrict__ out, long long rows,
    int L, int Lp, int ld, int di, int heads, int reverse, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * ROWS + threadIdx.x / 32;
  if (row >= rows) return;
  const long long bi = row / L;
  const int r = (int)(row % L);
  const int t = reverse ? L - 1 - r : r;  // the scan step of row r
  const int p = di / heads;
  const T* yr = y + (bi * Lp + t) * di;
  const T* xr = x + (bi * L + t) * di;
  const T* zr = zx + row * ld;

  float g[VPL][8];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = 8 * (lane + 32 * i);
    if (c >= di) break;
    float yv[8], xv[8], zv[8];
    load8<true>(yr + c, yv);
    load8<true>(xr + c, xv);
    load8<VEC>(zr + c, zv);
    const float dd = ld1(d + c / p);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = fmaf(dd, xv[j], yv[j]) * silu(zv[j]);
      g[i][j] = v;
      ss = fmaf(v, v, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss / di + eps);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = 8 * (lane + 32 * i);
    if (c >= di) break;
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = g[i][j] * inv * ld1(norm_w + c + j);
    store8(out + row * di + c, o);
  }
}

template <typename T>
static int launch_conv(const void* zx, const void* w, const void* bias, const void* dt_bias,
                       const void* a_log, void* xdt, void* adt, void* b, void* c, void* x,
                       int batch, int L, int Lp, int ld, int di, int n, int heads, int reverse,
                       cudaStream_t s) {
  if (batch < 1 || L < 1 || Lp < L || heads < 1 || di % heads || (di / heads) % 8 ||
      n < 8 || n % 8 || ld < 2 * di + 2 * n + heads)
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)batch * ((Lp + SEG - 1) / SEG);
  const int smem = conv_tile_bytes<T>() + SEG * heads * (int)sizeof(float);
  if (grid > 0x7fffffffLL || smem > 232448) return (int)cudaErrorInvalidValue;
  const bool vec = (ld * sizeof(T)) % 16 == 0 && (uintptr_t)zx % 16 == 0;
  auto kernel = vec ? conv_kernel<T, true> : conv_kernel<T, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 blocks((unsigned)grid, (di + 2 * n + CT - 1) / CT);
  kernel<<<blocks, CONV_THREADS, smem, s>>>(
      (const T*)zx, (const T*)w, (const T*)bias, (const T*)dt_bias, (const T*)a_log, (T*)xdt,
      (T*)adt, (T*)b, (T*)c, (T*)x, L, Lp, ld, di, n, heads, reverse);
  return (int)cudaGetLastError();
}

template <typename T, int VPL>
static void gate_vpl(bool vec, unsigned grid, cudaStream_t s, const T* y, const T* x,
                     const T* zx, const T* d, const T* norm_w, T* out, long long rows, int L,
                     int Lp, int ld, int di, int heads, int reverse, float eps) {
  auto kernel = vec ? gate_kernel<T, true, VPL> : gate_kernel<T, false, VPL>;
  kernel<<<grid, THREADS, 0, s>>>(y, x, zx, d, norm_w, out, rows, L, Lp, ld, di, heads, reverse,
                                  eps);
}

template <typename T>
static int launch_gate(const void* y, const void* x, const void* zx, const void* d,
                       const void* norm_w, void* out, int batch, int L, int Lp, int ld, int di,
                       int heads, int reverse, float eps, cudaStream_t s) {
  if (batch < 1 || L < 1 || Lp < L || heads < 1 || di % heads || (di / heads) % 8 ||
      di > 8 * 32 * 8 || ld < di)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)batch * L;
  const long long grid = (rows + ROWS - 1) / ROWS;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = (ld * sizeof(T)) % 16 == 0 && (uintptr_t)zx % 16 == 0;
  const T *yt = (const T*)y, *xt = (const T*)x, *zt = (const T*)zx, *dt = (const T*)d,
          *nt = (const T*)norm_w;
  const int vpl = (di + 255) / 256;  // 8-channel groups a lane
  if (vpl == 1)
    gate_vpl<T, 1>(vec, (unsigned)grid, s, yt, xt, zt, dt, nt, (T*)out, rows, L, Lp, ld, di,
                   heads, reverse, eps);
  else if (vpl == 2)
    gate_vpl<T, 2>(vec, (unsigned)grid, s, yt, xt, zt, dt, nt, (T*)out, rows, L, Lp, ld, di,
                   heads, reverse, eps);
  else if (vpl <= 4)
    gate_vpl<T, 4>(vec, (unsigned)grid, s, yt, xt, zt, dt, nt, (T*)out, rows, L, Lp, ld, di,
                   heads, reverse, eps);
  else
    gate_vpl<T, 8>(vec, (unsigned)grid, s, yt, xt, zt, dt, nt, (T*)out, rows, L, Lp, ld, di,
                   heads, reverse, eps);
  return (int)cudaGetLastError();
}

}  // namespace mamba_mixer

using namespace mamba_mixer;

extern "C" {

// K8's operands and x from zxbcdt (batch, L, ld), ld >= 2 di + 2 n + heads
// columns [z | x | b | c | dt]; conv_w (di + 2 n, 1, 4), conv_b (di + 2 n),
// dt_bias and A_log (heads); outputs x·dt (batch, Lp, di), a·dt (batch, Lp,
// heads), b and c (batch, Lp, n), x (batch, L, di), all contiguous; every
// tensor f32, or bf16 when is_bf16. reverse: scan step t reads row L - 1 - t
int sesa_mamba_conv(const void* zx, const void* w, const void* bias, const void* dt_bias,
                    const void* a_log, void* xdt, void* adt, void* b, void* c, void* x,
                    int batch, int L, int Lp, int ld, int di, int n, int heads, int reverse,
                    int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_conv<bf16>(zx, w, bias, dt_bias, a_log, xdt, adt, b, c, x, batch, L, Lp, ld,
                             di, n, heads, reverse, s);
  return launch_conv<float>(zx, w, bias, dt_bias, a_log, xdt, adt, b, c, x, batch, L, Lp, ld,
                            di, n, heads, reverse, s);
}

// the gated RMSNorm's rows out (batch, L, di) from K8's y (batch, Lp, di), x
// (batch, L, di) and the first di columns of zxbcdt (batch, L, ld); D
// (heads), norm_w (di). reverse: row r reads scan step L - 1 - r of y and x
int sesa_mamba_gate(const void* y, const void* x, const void* zx, const void* d,
                    const void* norm_w, void* out, int batch, int L, int Lp, int ld, int di,
                    int heads, int reverse, float eps, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_gate<bf16>(y, x, zx, d, norm_w, out, batch, L, Lp, ld, di, heads, reverse, eps,
                             s);
  return launch_gate<float>(y, x, zx, d, norm_w, out, batch, L, Lp, ld, di, heads, reverse, eps,
                            s);
}

}  // extern "C"
