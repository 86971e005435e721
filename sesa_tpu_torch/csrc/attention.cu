// K1: the fused roformer attention block on Hopper, as a chain of four
// hand-written kernels (five with the value residual).
//
// Replaces: sesa_tpu/ops/attention.py fused_attention_block (Pallas kernel
// _attn_block_kernel), which computes
//   x + W_o . (sigmoid(W_g . xn + b_g) * softmax(rope(q) . rope(k)^T * scale) . v)
// with xn = rms_norm(x) * gamma and q, k, v = W_qkv . xn, f32 softmax, keys
// at padded positions masked. Its value-residual modes (vr_mode 1 and 2 of
// _attn_block_kernel) also return the pre-mix V and lerp V toward a given
// first-layer V by sigmoid(W_vr . xn + b_vr) per head; add_residual=False
// leaves x out of the sum.
//
// Bound on the H100: tensor-core operations. At the flagship shapes
// (d 512, 8 heads x 64, tokens 256,680) one call does about 5.4e11 FLOP of
// projections plus 3.6e11 (time leg, n 690) or 3.3e10 (freq leg, n 62) of
// attention, against ~0.16 ms of unavoidable traffic at 3.35 TB/s.
//
// Design. One TPU program held a (gb*690, 1536) qkv scratch and a 690x690
// f32 score tile in VMEM; an SM's 227 KB cannot, so the block is split:
//   1. norm: a row pass, two rows a warp: xn = RMSNorm(x) * gamma (f32
//      sums, the TPU kernel's bf16 rounding) and, while the warp holds the
//      rows, the per-head gates sigmoid(xn . W_g + b_g) (and the value-residual
//      mix, h more rows of W_g) as f32 dot products into a (tokens, side)
//      buffer. The gates are 8 or 16 columns: as a 13th column tile of the
//      projection (tried) they cost the product more than they cost here
//      (PERF.md, Findings).
//   2. proj: qkv = bf16(xn . W_qkv^T) on gemm_ws.cuh (persistent, TMA, two
//      ping-pong consumer warpgroups, W_qkv's column slice resident in shared
//      memory at d <= 512), rope on q and k as the rows leave the staging
//      tile (WS_QKV_ROPE: interleaved pairs, bf16 arithmetic as the TPU
//      kernel, the tables read a whole row a warp).
//   3. core: the gated attention, read from the qkv buffer where q, k and v
//      lie and written (b, s, h, d), the layout the out product reads; keys
//      >= n masked, rows >= n not written; the gate multiplied in as
//      bf16(bf16(o / l) * bf16(gate)). Sequences longer than 64 (the time
//      leg) run flash_wgmma.cuh with its gate option (persistent, TMA producer
//      warp, wgmma, three consumer warpgroups on (sequence, 192-query) tiles
//      as K3), reading through 4-D (d, s, h, b) tensor maps with no copy.
//      Sequences of at most 64 (the freq leg, n 62) run attn_core_kernel: one
//      block of four warps per (sequence, head) on flash_core.cuh's mma.sync
//      loop, many blocks per SM. A 192-query tile would leave two of its three
//      consumers on padding, and a wgmma form with one (sequence, head) per
//      consumer lost to this one on the card (PERF.md, Findings).
//   4. out: out = bf16(bf16(ao . W_o^T) + x) on gemm_ws.cuh (WS_OUT: no bias,
//      the residual optional).
// Value residual: between proj and core one elementwise pass copies the V
// columns of the qkv buffer out as the pre-mix V and overwrites them with
// bf16(v + (v_first - v) * mix), v and v_first read as f32, with the mix of
// the norm pass, before the core reads V. (Folded into the projection's
// store phase, the copy and lerp made that GEMM slower by more than the pass
// takes: PERF.md, Findings.)
// xn, the qkv tensor and the gated attention output cross device memory
// once each, which the fused TPU kernel avoided.
//
// The host plans every launch (ops/attention.py k1_plan): the GEMMs' grids,
// the core's route, tensor maps and grid, and each launch's shared memory;
// the entry points refuse a plan that does not match the layouts here.
#include "flash_core.cuh"
#include "flash_wgmma.cuh"
#include "gemm_ws.cuh"

namespace sesa {

// the core's routes (k1_plan's "route"): flash_wgmma tiles, or for n <= 64
// attn_core_kernel<DH, 64>
enum K1CoreRoute { K1_CORE_TILES = 0, K1_CORE_SHORT = 1 };
constexpr int K1_SHORT_MAX_N = 64;

// The short route: flash_core over one head's columns of the qkv buffer,
// then the per-head gate. BQ query rows per block (BQ / 16 warps);
// scale_log2 = scale * log2(e)
template <int DH, int BQ>
__global__ void __launch_bounds__(BQ * 2)
attn_core_kernel(const bf16* __restrict__ qkv, const float* __restrict__ gates,
                 bf16* __restrict__ ao, int n, int heads, int gate_ld, float scale_log2) {
  extern __shared__ __align__(16) unsigned char at_smem[];
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, seq0 = blockIdx.z * n;
  const int hd = heads * DH, stride = 3 * hd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qg = qkv + (size_t)seq0 * stride + h * DH;

  float o[DH / 8][4], l_run[2];
  flash_core<DH, BQ>(reinterpret_cast<bf16*>(at_smem), qg, qg + hd, qg + 2 * hd, stride,
                     stride, stride, q0, n, scale_log2, o, l_run);

  // normalise, gate (bf16 product of bf16 values, as the TPU kernel), store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = q0 + warp * 16 + g + r * 8;
    if (pos >= n) continue;
    const size_t tok = (size_t)seq0 + pos;
    const float gate = rbf(gates[tok * gate_ld + h]);
    const float inv_l = 1.0f / l_run[r];
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      const float v0 = rbf(o[i][2 * r] * inv_l) * gate;
      const float v1 = rbf(o[i][2 * r + 1] * inv_l) * gate;
      *reinterpret_cast<uint32_t*>(ao + tok * hd + h * DH + i * 8 + 2 * t) = pack_bf16x2(v0, v1);
    }
  }
}

// the sums over a warp's 32 lanes of the N values v[0..N-1] that each lane
// holds, reduce-scattered by exchanges of halves (about N shuffles instead of
// 5 N): lane L ends with the sums of values M * (L / S) + j in v[j], j < M,
// where M = max(N / 32, 1) and S = max(32 / N, 1) (the S lanes of a group
// hold the same sums). One template step per exchange distance O, so that
// every index into v is a constant and v stays in registers.
template <int O, int HALF, int N>
__device__ __forceinline__ void warp_reduce_scatter_step(float (&v)[N], int lane) {
  if constexpr (HALF >= 1) {
    const bool upper = lane & O;  // keeps the upper half of the 2 * HALF values
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float keep = upper ? v[i + HALF] : v[i], give = upper ? v[i] : v[i + HALF];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, give, O);
    }
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
  }
  if constexpr (O > 1) warp_reduce_scatter_step<O / 2, HALF / 2>(v, lane);
}

template <int N>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[N], int lane) {
  warp_reduce_scatter_step<16, N / 2>(v, lane);
}

// K1_NG_ROWS rows per warp: xn = bf16(bf16((x * sqrt(d)) / max(|x|, 1e-12))
// * gamma) (the TPU kernel's rounding, sesa_tpu/ops/attention.py:389-392;
// K2's RMSNorm multiplies by the inverse instead) and gates[row, s] =
// sigmoid(xn . wg[s] + bg[s]) in f32 for s < side, G gate rows a pass over
// the rows. A lane's 8 columns of a W_g row, loaded and converted once,
// serve the warp's rows; the lanes' sums are reduce-scattered.
constexpr int K1_NG_ROWS = 2;

template <int G>
__global__ void __launch_bounds__(256)
rms_norm_gates_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                      const bf16* __restrict__ wg, const bf16* __restrict__ bg,
                      bf16* __restrict__ xn, float* __restrict__ gates, int rows, int d,
                      int side) {
  constexpr int R = K1_NG_ROWS, N = R * G;
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * 8 + (threadIdx.x >> 5)) * R;
  if (row0 >= rows) return;
  const float sqrt_d = sqrtf((float)d);
  float ss[R];
#pragma unroll
  for (int r = 0; r < R; ++r) ss[r] = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row0 + r < rows) {
        uint4 v = *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * d + c);
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i) { const float f = bf2f(e[i]); ss[r] += f * f; }
      }
    }
  }
  float nrm[R];
#pragma unroll
  for (int r = 0; r < R; ++r) nrm[r] = fmaxf(sqrtf(warp_sum(ss[r])), 1e-12f);
  for (int g0 = 0; g0 < side; g0 += G) {
    float acc[N];
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] = 0.f;
    for (int c = lane * 8; c < d; c += 256) {
      uint4 gv = *reinterpret_cast<const uint4*>(gamma + c);
      const bf16* ge = reinterpret_cast<const bf16*>(&gv);
      float y[R][8];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool in = row0 + r < rows;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (in) v = *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * d + c);
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i) y[r][i] = rbf(rbf((bf2f(e[i]) * sqrt_d) / nrm[r]) * bf2f(ge[i]));
        if (g0 == 0 && in) {
          uint4 o;
          uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
          for (int i = 0; i < 4; ++i) op[i] = pack_bf16x2(y[r][2 * i], y[r][2 * i + 1]);
          *reinterpret_cast<uint4*>(xn + (size_t)(row0 + r) * d + c) = o;
        }
      }
      // (guarded, not cut short: a loop left by break is not unrolled, and
      // acc would go to local memory)
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (g0 + k < side) {
          const uint4 w = __ldg(reinterpret_cast<const uint4*>(wg + (size_t)(g0 + k) * d + c));
          const bf16* we = reinterpret_cast<const bf16*>(&w);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float wf = bf2f(we[i]);
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r * G + k] = fmaf(y[r][i], wf, acc[r * G + k]);
          }
        }
      }
    }
    warp_reduce_scatter(acc, lane);
    // lane L holds the sums of values M * (L / SHARE) + j
    constexpr int M = N >= 32 ? N / 32 : 1, SHARE = N >= 32 ? 1 : 32 / N;
    if (lane % SHARE == 0) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const int idx = M * (lane / SHARE) + j, r = idx / G, k = idx % G;
        if (row0 + r < rows && g0 + k < side)
          gates[(size_t)(row0 + r) * side + g0 + k] = sigmoidf_(acc[j] + bf2f(bg[g0 + k]));
      }
    }
  }
}

// The value-residual pass over the V columns of the qkv buffer, 8 values
// (16 bytes) per thread: v_pre = v; with v_first, v <- bf16(v + (v_first - v)
// * mix) in f32, mix = side[token, heads + head] (already through the sigmoid)
__global__ void __launch_bounds__(256)
attn_vr_kernel(bf16* __restrict__ qkv, const float* __restrict__ side,
               const bf16* __restrict__ v_first, bf16* __restrict__ v_pre, int tokens,
               int heads, int dim_head, int side_ld) {
  const int hd = heads * dim_head, per_row = hd / 8;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)tokens * per_row) return;
  const size_t tok = idx / per_row;
  const int c = (int)(idx % per_row) * 8;
  bf16* vp = qkv + tok * 3 * hd + 2 * hd + c;
  uint4 v = *reinterpret_cast<const uint4*>(vp);
  *reinterpret_cast<uint4*>(v_pre + tok * hd + c) = v;
  if (v_first == nullptr) return;
  const float mix = side[tok * side_ld + heads + c / dim_head];
  const uint4 f = *reinterpret_cast<const uint4*>(v_first + tok * hd + c);
  uint32_t* vw = reinterpret_cast<uint32_t*>(&v);
  const uint32_t* fw = reinterpret_cast<const uint32_t*>(&f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vw + i));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(fw + i));
    vw[i] = pack_bf16x2(a.x + (b.x - a.x) * mix, a.y + (b.y - a.y) * mix);
  }
  *reinterpret_cast<uint4*>(vp) = v;
}

// the core's launches: flash_wgmma tiles (n > 64), or one attn_core_kernel
// block per (sequence, head) (n <= 64); their shared memory and blocks
template <int DH>
inline int k1_core_smem(bool short_route) {
  return short_route ? flash_core_smem_bytes<DH, 64>() : FlashCfg<DH, 3>::SMEM;
}

template <int DH>
inline long long k1_core_blocks(bool short_route, long long batch, int heads, int n, int sms) {
  if (short_route) return batch * heads;
  const long long tiles = flash_tiles<DH, 3>(batch, heads, n);
  return tiles < sms ? tiles : sms;
}

template <int DH>
inline int k1_core_launch(bool short_route, const FlashArgs& a, const bf16* qkv,
                          const uint64_t* dims, const uint64_t* strides, int batch, int hd,
                          cudaStream_t s) {
  if (!short_route)
    return launch_flash_wgmma<DH, 3, true>(a, qkv, qkv + hd, qkv + 2 * hd, dims, strides,
                                           strides, strides, batch, s);
  constexpr int smem = flash_core_smem_bytes<DH, 64>();
  cudaFuncSetAttribute(attn_core_kernel<DH, 64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  attn_core_kernel<DH, 64><<<dim3(1, a.heads, batch), 128, smem, s>>>(
      qkv, a.gates, a.o, a.n, a.heads, a.gate_ld, a.scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace sesa

using namespace sesa;

extern "C" {

// xn = rms_norm(x) * gamma; gates = sigmoid(xn . wg^T + bg), (tokens, side)
// f32: wg (side, dim) and bg (side,) hold the heads' gate rows, then for the
// value-residual mix the heads' mix rows (side = heads or 2 * heads);
// qkv = bf16(xn . wqkv^T) with rope on q and k (cos_t/sin_t (seq_len,
// rot_width) or null). xn is (tokens, dim) scratch. grid, smem: the
// projection's persistent grid and shared memory (k1_plan)
int sesa_attn_proj(const void* x, const void* gamma, void* xn, const void* wqkv,
                   const void* wg, const void* bg, const void* cos_t, const void* sin_t,
                   void* qkv, void* gates, int tokens, int dim, int heads, int dim_head,
                   int seq_len, int rot_width, int side, int grid, int smem, void* stream) {
  const int hd = heads * dim_head;
  if (side < 1 || dim % 64 || (dim_head != 32 && dim_head != 64) || rot_width % 2 ||
      rot_width > dim_head || seq_len < 1 || smem != ws_smem_bytes(dim))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((tokens + 8 * K1_NG_ROWS - 1) / (8 * K1_NG_ROWS));
  if (side <= 8)
    rms_norm_gates_kernel<8><<<blocks, 256, 0, s>>>(
        (const bf16*)x, (const bf16*)gamma, (const bf16*)wg, (const bf16*)bg, (bf16*)xn,
        (float*)gates, tokens, dim, side);
  else
    rms_norm_gates_kernel<16><<<blocks, 256, 0, s>>>(
        (const bf16*)x, (const bf16*)gamma, (const bf16*)wg, (const bf16*)bg, (bf16*)xn,
        (float*)gates, tokens, dim, side);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  WsArgs p = {};
  p.C = (bf16*)qkv;
  p.M = tokens; p.N = 3 * hd; p.K = dim; p.out_scale = 1.0f;
  p.cos_t = (const bf16*)cos_t; p.sin_t = (const bf16*)sin_t;
  p.seq_len = seq_len; p.rot_w = rot_width; p.dim_head = dim_head; p.rope_cols = 2 * hd;
  return launch_gemm_ws<WS_QKV_ROPE>((const bf16*)xn, (const bf16*)wqkv, p, grid, s);
}

// v_pre = the V columns of qkv; with v_first (tokens, heads * dim_head) they
// are then lerped toward it by the mix columns of side (tokens, side_ld)
int sesa_attn_vr(void* qkv, const void* side, const void* v_first, void* v_pre, int tokens,
                 int heads, int dim_head, int side_ld, void* stream) {
  const size_t chunks = (size_t)tokens * heads * dim_head / 8;
  attn_vr_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (bf16*)qkv, (const float*)side, (const bf16*)v_first, (bf16*)v_pre, tokens, heads,
      dim_head, side_ld);
  return (int)cudaGetLastError();
}

// ao = gate * softmax(q . k^T * scale) . v per (sequence, head), (b, n, h,
// dh); q, k roped, read in place from qkv (batch * n, 3 * heads * dim_head)
// through the plan's (d, s, h, b) maps: dims d0..d3, byte strides s1..s3;
// output element strides ob, oh, os; gates (tokens, gate_ld) with the heads'
// gates first. route, grid, smem: the plan's core route (K1CoreRoute), its
// blocks (persistent: at most one per SM; short: one per (sequence, head))
// and shared memory
int sesa_attn_core(const void* qkv, const void* gates, void* ao, int batch, int n, int heads,
                   int dim_head, int gate_ld, float scale, int route, long long d0,
                   long long d1, long long d2, long long d3, long long s1, long long s2,
                   long long s3, long long ob, long long oh, long long os, int grid, int smem,
                   void* stream) {
  const int hd = heads * dim_head;
  const bool short_route = n <= K1_SHORT_MAX_N;
  const int sms = sm_count();
  if ((dim_head != 32 && dim_head != 64) || !(scale > 0.f) || n < 1 || batch < 1 || sms < 1 ||
      route != (short_route ? K1_CORE_SHORT : K1_CORE_TILES) || d0 != dim_head || d1 != n ||
      d2 != heads || d3 != batch || s1 != 2LL * 3 * hd || s2 != 2LL * dim_head ||
      s3 != 2LL * n * 3 * hd || ob != (long long)n * hd || oh != dim_head || os != hd)
    return (int)cudaErrorInvalidValue;
  const long long blocks = dim_head == 32 ? k1_core_blocks<32>(short_route, batch, heads, n, sms)
                                          : k1_core_blocks<64>(short_route, batch, heads, n, sms);
  const int want_smem = dim_head == 32 ? k1_core_smem<32>(short_route)
                                       : k1_core_smem<64>(short_route);
  if (grid != blocks || smem != want_smem) return (int)cudaErrorInvalidValue;
  const uint64_t dims[4] = {(uint64_t)d0, (uint64_t)d1, (uint64_t)d2, (uint64_t)d3};
  const uint64_t strides[3] = {(uint64_t)s1, (uint64_t)s2, (uint64_t)s3};
  FlashArgs a = {};
  a.o = (bf16*)ao; a.ob = ob; a.oh = oh; a.os = os;
  a.heads = heads; a.n = n; a.rank = 4; a.scale_log2 = scale * 1.4426950408889634f;
  a.gates = (const float*)gates; a.gate_ld = gate_ld;
  const bf16* q = (const bf16*)qkv;
  cudaStream_t s = (cudaStream_t)stream;
  return dim_head == 64 ? k1_core_launch<64>(short_route, a, q, dims, strides, batch, hd, s)
                        : k1_core_launch<32>(short_route, a, q, dims, strides, batch, hd, s);
}

// out = bf16(bf16(ao . wo^T) + x), or bf16(ao . wo^T) when x is null; grid,
// smem: the out product's persistent grid and shared memory (k1_plan)
int sesa_attn_out(const void* ao, const void* wo, const void* x, void* out, int tokens,
                  int dim, int hd, int grid, int smem, void* stream) {
  if (smem != ws_smem_bytes(hd)) return (int)cudaErrorInvalidValue;
  WsArgs p = {};
  p.resid = (const bf16*)x; p.C = (bf16*)out;
  p.M = tokens; p.N = dim; p.K = hd; p.out_scale = 1.0f;
  return launch_gemm_ws<WS_OUT>((const bf16*)ao, (const bf16*)wo, p, grid, (cudaStream_t)stream);
}

}  // extern "C"
