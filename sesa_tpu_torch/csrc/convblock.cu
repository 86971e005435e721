// K5: the fused conformer conv module on Hopper, as a chain of hand-written
// kernels.
//
// Replaces: sesa_tpu/ops/convblock.py fused_conformer_conv (Pallas kernel
// _conformer_conv_kernel), which computes
//   x + W2 . swish(BN_eval(dwconv_k(GLU(W1 . xn + b1)))) + b2
// with xn = LayerNorm(x) * gamma + beta, GLU over channels (a * sigmoid(g)),
// a depthwise convolution of k taps along each sequence, and the eval
// BatchNorm folded with the depthwise bias into a per-channel scale and
// shift (rounded to bf16, convblock.py:126-133).
//
// Bound on the H100: tensor-core operations. At the mel-band conformer shape
// (tokens 248,400, d 384, e 768, k 31) one call does 2 * T * (d * 2e + e * d)
// = 4.4e11 FLOP of pointwise products plus 2 * T * k * e = 1.2e10 of the
// depthwise taps (CUDA cores), about 0.46 ms at 989 TFLOP/s, against
// ~0.11 ms to read x and write the output at 3.35 TB/s.
//
// Design. One TPU program held a slab of whole sequences and the (rows, e)
// GLU and conv activations in VMEM. Here:
//   1. up:   LayerNorm row pass (rmsnorm.cuh) -> the persistent GEMM of
//            gemm_ws.cuh against W1 (WS_BIAS_GLU: W1's slice resident at
//            d <= 512), whose rows the wrapper interleaves (a0, g0, a1, g1,
//            ...) so that each thread's column pair is one (a, g): + b1, GLU
//            in f32, bf16 store of the (T, e) GLU output (convblock.py:93).
//   2. dw:   the depthwise stencil, bound by the bytes of the GLU output in
//            and y out (0.76 GB, 0.23 ms) and by its f32 FMAs on the CUDA
//            cores (2 * T * k * e, ~0.18 ms). A persistent grid walks over
//            tiles of up to 128 rows of one sequence (one whole sequence on
//            the freq leg, n 60) and 64 channels, two tiles in flight a
//            block: the tile plus its halo arrives in bf16 as one TMA box
//            while the previous tile is summed, rows outside [0, n) as TMA's
//            zeros (the lucidrains padding, k / 2 before, k / 2 - (k + 1) % 2
//            after: _conv_apply, conformer_core.py:143, also right for even
//            k), so no thread computes a staging address. Each lane keeps
//            a channel pair's taps in registers and slides them over its
//            warp's 16 consecutive rows (47 shared loads for 16 x 32 taps);
//            f32 sums in tap order, * scale + shift, swish in f32, bf16
//            store. Any number of taps: a kernel of k > 32 taps runs in
//            blocks of 32 taps, each one more step of the item with its
//            own box of the same rows + 31 rows, shifted 32 rows on, and
//            its own taps in the same registers; the sums carry across the
//            blocks, so the taps are still summed in tap order (the Pallas
//            kernel takes any k; this keeps the box within TMA's 256 rows and
//            the staging within static shared memory at every k).
//   3. down: the persistent GEMM with W2 (WS_RESID: + b2, bf16, + x).
// The GLU and conv activations cross device memory once each way (4 x 0.38 GB
// at the main path's shape, ~0.46 ms of traffic); keeping them on chip needs
// the stencil in the down product's producer, later work.
//
// The host plans every launch (ops/convblock.py k5_plan): the GEMMs' grids
// and shared memory and the stencil's tile rows; the entry points refuse a
// plan that does not match the layouts here.
#include "gemm_ws.cuh"
#include "rmsnorm.cuh"

namespace sesa {

constexpr int DW_CH = 64;     // channels per block: a channel pair per lane
constexpr int DW_KB = 32;     // taps of a block held in registers (taps >= k are zero)
constexpr int DW_RPT = 16;    // consecutive rows per warp
constexpr int DW_WARPS = 8;   // warps of the largest tile: 128 rows
constexpr int DW_SROWS = DW_WARPS * DW_RPT + DW_KB - 1;  // staged rows, halo included

// x * sigmoid(x) with ex2 and rcp on the special-function unit and no range
// fix-ups (x -> -inf: 1 / inf = 0): two of its instructions a value, the
// epilogue's share of that unit
__device__ __forceinline__ float swish_sfu(float x) {
  return x * fast_rcp(1.0f + fast_exp2(-1.4426950408889634f * x));
}

// A persistent grid of blocks of 16 rows a warp (rows = 16 * warps); block b
// takes a contiguous run of the work items (channel slice, sequence, row
// tile), in that order, so that its items share their taps and neighbouring
// tiles' halos meet in L2. An item is one step for each block of 32 taps
// (kb = ceil(k / 32) steps). Two staging buffers: one thread loads the next
// step's rows by TMA while the block sums the current one. The tensor map is
// (e, n, batch), so the rows outside [0, n) of a sequence, the padding,
// arrive as TMA's zero fill: staged row r of tap block j of an item is
// sequence row i0 - pad_l + 32 j + r. ONE: k <= 32, one step an item, the
// tap-block loop compiled away (as the kernel was before it took more taps).
template <bool ONE>
__global__ void __launch_bounds__(DW_WARPS * 32, 2)
dwconv_bn_swish_kernel(const __grid_constant__ CUtensorMap tg, const bf16* __restrict__ taps,
                       const bf16* __restrict__ scale, const bf16* __restrict__ shift,
                       bf16* __restrict__ y, int batch, int n, int e, int k, int pad_l,
                       int items) {
  __shared__ __align__(128) bf16 s[2][DW_SROWS][DW_CH];
  __shared__ uint64_t full[2];
  const int rows = blockDim.x / 32 * DW_RPT, tiles = (n + rows - 1) / rows;
  const int kb = ONE ? 1 : (k + DW_KB - 1) / DW_KB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (items + gridDim.x - 1) / gridDim.x;
  const int first = blockIdx.x * per, last = min(items, first + per);
  const uint32_t box_bytes = (rows + DW_KB - 1) * DW_CH * 2;

  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(full + 1, 1);
    mbar_init_fence();
  }
  __syncthreads();
  // an item's row tile, sequence and channel slice, stepped in order
  int tile = first % tiles, seq = first / tiles % batch, slice = first / (tiles * batch);
  auto load = [&](int buf, int t, int q, int c, int j) {
    mbar_expect_tx(full + buf, box_bytes);
    tma_load_3d(&s[buf][0][0], &tg, full + buf, c * DW_CH, t * rows - pad_l + j * DW_KB, q);
  };
  if (threadIdx.x == 0 && first < last) load(0, tile, seq, slice, 0);
  float2 tp[DW_KB], sc = make_float2(0.f, 0.f), sh = make_float2(0.f, 0.f);
  float2 acc[DW_RPT];
  int c_taps = -1;  // the (channel slice, tap block) whose taps tp holds
  int it = 0;       // the block's steps so far: its buffer and phase
  for (int item = first; item < last; ++item) {
    const int c0 = slice * DW_CH, i0 = tile * rows, rbase = warp * DW_RPT;
    const size_t seq0 = (size_t)seq * n;
    for (int j = 0; j < kb; ++j, ++it) {
      const int buf = it & 1;
      if (threadIdx.x == 0) {  // the next step: this item's next tap block, or the next item's first
        if (j + 1 < kb) {
          load(buf ^ 1, tile, seq, slice, j + 1);
        } else if (item + 1 < last) {
          int t = tile + 1, q = seq, c = slice;
          if (t == tiles) {
            t = 0;
            if (++q == batch) q = 0, ++c;
          }
          load(buf ^ 1, t, q, c, 0);
        }
      }
      if (slice * kb + j != c_taps) {
        c_taps = slice * kb + j;
#pragma unroll
        for (int t = 0; t < DW_KB; ++t)
          tp[t] = j * DW_KB + t < k
                      ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                            taps + (size_t)(j * DW_KB + t) * e + c0 + 2 * lane))
                      : make_float2(0.f, 0.f);
        sc = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(scale + c0 + 2 * lane));
        sh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(shift + c0 + 2 * lane));
      }
      if (j == 0) {
#pragma unroll
        for (int r = 0; r < DW_RPT; ++r) acc[r] = make_float2(0.f, 0.f);
      }
      mbar_wait(full + buf, (it >> 1) & 1);
      if (i0 + rbase < n) {
        // out[i] = sum_t taps[t] * h[i + t - pad_l]; tap block j adds
        // sum_{t < 32} taps[32 j + t] * s[i - i0 + t] over its staged rows,
        // summed in tap order as the TPU kernel; taps >= k are zero, so the
        // staged rows past the block's halo only need to be finite
#pragma unroll
        for (int jr = 0; jr < DW_RPT + DW_KB - 1; ++jr) {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&s[buf][rbase + jr][2 * lane]));
#pragma unroll
          for (int r = 0; r < DW_RPT; ++r) {
            const int t = jr - r;
            if (t >= 0 && t < DW_KB) {
              acc[r].x = fmaf(tp[t].x, v.x, acc[r].x);
              acc[r].y = fmaf(tp[t].y, v.y, acc[r].y);
            }
          }
        }
        if (j + 1 == kb) {
#pragma unroll
          for (int r = 0; r < DW_RPT; ++r) {
            const int i = i0 + rbase + r;
            if (i < n) {  // no `break`: the loop must stay unrolled (acc in registers)
              const float v0 = acc[r].x * sc.x + sh.x, v1 = acc[r].y * sc.y + sh.y;
              *reinterpret_cast<uint32_t*>(y + (seq0 + i) * e + c0 + 2 * lane) =
                  pack_bf16x2(swish_sfu(v0), swish_sfu(v1));
            }
          }
        }
      }
      __syncthreads();  // every warp has read this buffer before it is loaded again
    }
    if (++tile == tiles) {
      tile = 0;
      if (++seq == batch) seq = 0, ++slice;
    }
  }
}

// the stencil's tile: 16 rows a warp, as many warps as the sequence needs up
// to DW_WARPS
inline int dw_tile_rows(int n) {
  const int warps = (n + DW_RPT - 1) / DW_RPT;
  return DW_RPT * (warps < DW_WARPS ? warps : DW_WARPS);
}

// its persistent grid: 16 warps an SM (two blocks of 8 warps, or four of
// 4, ...), never more blocks than work items
inline long long dw_grid(int batch, int n, int e, int sms) {
  const int rows = dw_tile_rows(n);
  const long long items = (long long)batch * ((n + rows - 1) / rows) * (e / DW_CH);
  const long long fill = (long long)sms * (16 / (rows / DW_RPT));
  return items < fill ? items : fill;
}

}  // namespace sesa

using namespace sesa;

extern "C" {

// glu = bf16(GLU(layer_norm(x) * gamma + beta) . w1i^T + b1i)), with w1i and
// b1i interleaved (a0, g0, a1, g1, ...); xn is (tokens, dim) scratch, glu is
// (tokens, e2 / 2). grid, smem: the product's persistent grid and shared
// memory (k5_plan)
int sesa_conv_up(const void* x, const void* gamma, const void* beta, void* xn, const void* w1i,
                 const void* b1i, void* glu, int tokens, int dim, int e2, int grid, int smem,
                 void* stream) {
  if (smem != ws_smem_bytes(dim)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = launch_layer_norm((const bf16*)x, (const bf16*)gamma, (const bf16*)beta,
                                   (bf16*)xn, tokens, dim, s);
  if (rc != 0) return rc;
  WsArgs p = {};
  p.bias = (const bf16*)b1i; p.C = (bf16*)glu;
  p.M = tokens; p.N = e2; p.K = dim; p.out_scale = 1.0f;
  return launch_gemm_ws<WS_BIAS_GLU>((const bf16*)xn, (const bf16*)w1i, p, grid, s);
}

// y = bf16(swish(dwconv(glu) * scale + shift)) per sequence of n rows;
// taps (k, e), any k >= 1 (in blocks of 32); rows, grid: the plan's tile rows
// and persistent blocks (k5_plan). The work items, and their steps (an item
// a tap block), are counted in int; the grid is persistent, so no count of
// sequences is limited by a grid dimension
int sesa_conv_dw(const void* glu, const void* taps, const void* scale, const void* shift,
                 void* y, int batch, int n, int e, int k, int rows, int grid, void* stream) {
  const int sms = sm_count();
  const long long items = (long long)batch * ((n + rows - 1) / rows) * (e / DW_CH);
  const long long steps = items * ((k + DW_KB - 1LL) / DW_KB);
  if (k < 1 || e % DW_CH || n < 1 || batch < 1 || sms < 1 || rows != dw_tile_rows(n) ||
      grid != dw_grid(batch, n, e, sms) || steps > 0x7fffffffLL ||
      (long long)n + k > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // (e, n, batch): the rows of one step, an item's tile and the halo of its
  // tap block, are one box
  const uint64_t dims[3] = {(uint64_t)e, (uint64_t)n, (uint64_t)batch};
  const uint64_t strides[2] = {(uint64_t)e * 2, (uint64_t)n * e * 2};
  const uint32_t box[3] = {(uint32_t)DW_CH, (uint32_t)(rows + DW_KB - 1), 1};
  CUtensorMap tg;
  const int rc = make_tmap_bf16(&tg, glu, 3, dims, strides, box, 0);
  if (rc != 0) return rc;
  auto kernel = k <= DW_KB ? dwconv_bn_swish_kernel<true> : dwconv_bn_swish_kernel<false>;
  kernel<<<grid, rows / DW_RPT * 32, 0, (cudaStream_t)stream>>>(
      tg, (const bf16*)taps, (const bf16*)scale, (const bf16*)shift, (bf16*)y, batch, n, e, k,
      k / 2, (int)items);
  return (int)cudaGetLastError();
}

// out = bf16(bf16(y . w2^T + b2) + x); grid, smem: the product's persistent
// grid and shared memory (k5_plan)
int sesa_conv_down(const void* y, const void* w2, const void* b2, const void* x, void* out,
                   int tokens, int dim, int e, int grid, int smem, void* stream) {
  if (smem != ws_smem_bytes(e)) return (int)cudaErrorInvalidValue;
  WsArgs p = {};
  p.bias = (const bf16*)b2; p.resid = (const bf16*)x; p.C = (bf16*)out;
  p.M = tokens; p.N = dim; p.K = e; p.out_scale = 1.0f;
  return launch_gemm_ws<WS_RESID>((const bf16*)y, (const bf16*)w2, p, grid,
                                  (cudaStream_t)stream);
}

}  // extern "C"
