// K7: packed-qkv rope attention on Hopper, one hand-written kernel.
//
// Replaces: sesa_tpu/ops/attention.py fused_rope_attention (Pallas kernel
// _fused_attn_kernel), which takes the qkv projection's packed output
// (b, n, 3 * h * dh), component-major [q_0..q_H | k_0..k_H | v_0..v_H], rotates
// q and k with the interleaved rope (the leading w <= dh dims of each head),
// runs f32-softmax attention per head with padded keys masked, and writes
// (b, n, h * dh), the layout the out projection reads.
//
// Bound on the H100: bytes. At Apollo's shape (7,604 sequences of 80 bands,
// 8 heads x 32) one call does 4 * b * h * n^2 * dh = 5.0e10 FLOP (0.05 ms at
// 989 TFLOP/s) against 1.25 GB of qkv in and heads out (0.37 ms at
// 3.35 TB/s): 60,832 tiny (sequence, head) problems, so what matters is how
// the packed rows are read and written, not the tensor-core rate.
//
// Design. One block takes one sequence and a group of G heads whose q, k and
// v columns are G * dh * 2 >= 256 contiguous bytes of every packed row (G = 4
// at dh 32), so all loads and stores move whole 128-byte lines; the three
// (n, G * dh) slabs (61 KB at n 80, three blocks per SM, so one block's loads
// overlap another's products) are staged with cp.async, rows >= n zero. Rope
// runs in place on the staged q and k in the TPU kernel's bf16 arithmetic,
// y = bf16(bf16(x * cos) + bf16(rot(x) * sin)). Then each warp takes (head,
// 16-query tile) tasks: q fragments by ldmatrix, keys in tiles of 32 (16-key
// halves with no valid key skipped: n 80 costs exactly 80 keys) with
// mma.sync, an online softmax in f32 (base 2, logits pre-scaled), p rounded
// to bf16 before p . v, V fragments by ldmatrix.trans. The finished tile
// overwrites its own q rows in shared memory and the block writes the
// (n, G * dh) result in 16-byte chunks of whole rows. Sequences longer than
// one key tile take more trips of the same loop; the limit is the slabs'
// shared memory (the host lowers G to fit, n up to ~530 at dh 64).
#include "common.cuh"

namespace sesa {

constexpr int RA_THREADS = 256, RA_BK = 32;

template <int DH>
__global__ void __launch_bounds__(RA_THREADS)
rope_attn_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ cos_t,
                 const bf16* __restrict__ sin_t, bf16* __restrict__ out, int n, int heads,
                 int group, int rot_w, float scale_log2) {
  extern __shared__ __align__(16) unsigned char ra_smem[];
  const int n_pad = (n + 15) & ~15, LD = group * DH + 8;
  bf16* sQ = reinterpret_cast<bf16*>(ra_smem);
  bf16* sK = sQ + (size_t)n_pad * LD;
  bf16* sV = sK + (size_t)n_pad * LD;

  const size_t seq0 = (size_t)blockIdx.x * n;
  const int h0 = blockIdx.y * group, gcount = min(group, heads - h0);
  const int hd = heads * DH, stride = 3 * hd, gw = gcount * DH, cpr = gw / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix.x4 lane addressing, as the attention cores of K1 and K4
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;

  // Each warp takes rows warp, warp + NW, ...; a lane takes the same 16-byte
  // chunks of every row (chunk index lane + 32 j of the row's 3 * cpr <= 48),
  // so the divisions that place a chunk are done once, outside the row loops.
  constexpr int NW = RA_THREADS / 32;
  int comp[2], c8[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int idx = lane + 32 * j;
    comp[j] = idx < 3 * cpr ? idx / cpr : -1;
    c8[j] = (idx % cpr) * 8;
  }

  // stage this group's q, k and v columns of every row; rows >= n are zero
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (comp[j] < 0) continue;
    bf16* dst = (comp[j] == 0 ? sQ : comp[j] == 1 ? sK : sV) + c8[j];
    const bf16* src = qkv + seq0 * stride + (comp[j] * heads + h0) * DH + c8[j];
    for (int r = warp; r < n_pad; r += NW)
      cp_async16_zfill(dst + (size_t)r * LD, src + (size_t)min(r, n - 1) * stride,
                       r < n ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // interleaved rope on the leading rot_w dims of each head of q and k
  if (cos_t != nullptr) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d0 = c8[j] % DH;
      if (comp[j] < 0 || comp[j] > 1 || d0 >= rot_w) continue;
      bf16* base = (comp[j] == 0 ? sQ : sK) + c8[j];
      const int pairs = min(4, (rot_w - d0) / 2);
      for (int r = warp; r < n; r += NW) {
        bf16* p = base + (size_t)r * LD;
        uint4 v = *reinterpret_cast<uint4*>(p);
        uint32_t* vp = reinterpret_cast<uint32_t*>(&v);
        const bf16* cr = cos_t + (size_t)r * rot_w + d0;
        const bf16* sr = sin_t + (size_t)r * rot_w + d0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i >= pairs) break;
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vp + i));
          const float2 cs =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cr + 2 * i));
          const float2 sn =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sr + 2 * i));
          vp[i] = pack_bf16x2(rbf(x.x * cs.x) + rbf(-x.y * sn.x),
                              rbf(x.y * cs.y) + rbf(x.x * sn.y));
        }
        *reinterpret_cast<uint4*>(p) = v;
      }
    }
    __syncthreads();
  }

  const int qtiles = n_pad / 16, tasks = gcount * qtiles;
  for (int task = warp; task < tasks; task += NW) {
    const int hc = (task / qtiles) * DH, q0 = (task % qtiles) * 16;
    uint32_t qf[DH / 16][4];
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      ldmatrix_x4(qf[kk], sQ + (size_t)(q0 + a_row) * LD + hc + kk * 16 + a_col);
    float o[DH / 8][4];
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

    for (int k0 = 0; k0 < n; k0 += RA_BK) {
      const int halves = (n - k0 > 16) ? 2 : 1;  // 16-key halves with a valid key
      float s[RA_BK / 8][4];
#pragma unroll
      for (int j = 0; j < RA_BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int jj = 0; jj < RA_BK / 16; ++jj) {
        if (jj >= halves) break;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          uint32_t r[4];
          ldmatrix_x4(r, sK + (size_t)(k0 + jj * 16 + b_row) * LD + hc + kk * 16 + b_col);
          mma_bf16_16816(s[2 * jj], qf[kk], r[0], r[1]);
          mma_bf16_16816(s[2 * jj + 1], qf[kk], r[2], r[3]);
        }
      }

      // online softmax in base 2; thread rows g (c0, c1) and g + 8 (c2, c3)
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < RA_BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + 2 * t + (e & 1);
          s[j][e] = key < n ? s[j][e] * scale_log2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f(m_run[r] - mx[r]);  // 2^-inf = 0 on the first tile
        m_run[r] = mx[r];
        l_run[r] *= corr[r];  // this thread's share of the row sum
      }
#pragma unroll
      for (int j = 0; j < RA_BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(s[j][e] - mx[e >> 1]);
          l_run[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        o[i][0] *= corr[0]; o[i][1] *= corr[0];
        o[i][2] *= corr[1]; o[i][3] *= corr[1];
      }

      // P (bf16, C layout reused as A fragments) . V (B fragments by ldmatrix.trans)
#pragma unroll
      for (int kk = 0; kk < RA_BK / 16; ++kk) {
        if (kk >= halves) break;
        uint32_t pa[4];
        pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int ii = 0; ii < DH / 16; ++ii) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, sV + (size_t)(k0 + kk * 16 + a_row) * LD + hc + ii * 16 + a_col);
          mma_bf16_16816(o[2 * ii], pa, r[0], r[1]);
          mma_bf16_16816(o[2 * ii + 1], pa, r[2], r[3]);
        }
      }
    }

    // normalise; the tile replaces its own q rows (read by this warp alone)
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv_l = 1.0f / l;
      bf16* dst = sQ + (size_t)(q0 + g + r * 8) * LD + hc + 2 * t;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i)
        *reinterpret_cast<uint32_t*>(dst + i * 8) =
            pack_bf16x2(o[i][2 * r] * inv_l, o[i][2 * r + 1] * inv_l);
    }
  }
  __syncthreads();

  if (comp[0] == 0) {  // the q chunks: lanes below cpr
    bf16* dst = out + seq0 * hd + h0 * DH + c8[0];
    for (int r = warp; r < n; r += NW)
      *reinterpret_cast<uint4*>(dst + (size_t)r * hd) =
          *reinterpret_cast<const uint4*>(sQ + (size_t)r * LD + c8[0]);
  }
}

}  // namespace sesa

using namespace sesa;

template <int DH>
static int launch_rope_attn(const void* qkv, const void* cos_t, const void* sin_t, void* out,
                            int batch, int n, int heads, int group, int rot_w,
                            float scale_log2, cudaStream_t s) {
  const int n_pad = (n + 15) & ~15;
  const int smem = 3 * n_pad * (group * DH + 8) * 2;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(rope_attn_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(batch, (heads + group - 1) / group);
  rope_attn_kernel<DH><<<grid, RA_THREADS, smem, s>>>(
      (const bf16*)qkv, (const bf16*)cos_t, (const bf16*)sin_t, (bf16*)out, n, heads, group,
      rot_w, scale_log2);
  return (int)cudaGetLastError();
}

extern "C" {

// out (batch, n, heads * dim_head) = softmax(rope(q) . rope(k)^T * scale) . v
// per (sequence, head) of the packed, component-major qkv (batch, n,
// 3 * heads * dim_head); cos_t/sin_t (n, rot_width) or null; group = heads
// per block, chosen by the caller so that the slabs fit in shared memory
int sesa_rope_attn(const void* qkv, const void* cos_t, const void* sin_t, void* out, int batch,
                   int n, int heads, int dim_head, int group, int rot_width, float scale,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float sl2 = scale * 1.4426950408889634f;
  if (batch < 1 || n < 1 || group < 1 || (heads + group - 1) / group > 65535 ||
      rot_width % 2 || rot_width > dim_head)
    return (int)cudaErrorInvalidValue;
  int (*launch)(const void*, const void*, const void*, void*, int, int, int, int, int, float,
                cudaStream_t) = nullptr;
  if (dim_head == 16) launch = &launch_rope_attn<16>;
  if (dim_head == 32) launch = &launch_rope_attn<32>;
  if (dim_head == 64) launch = &launch_rope_attn<64>;
  if (dim_head == 128) launch = &launch_rope_attn<128>;
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  return launch(qkv, cos_t, sin_t, out, batch, n, heads, group, rot_width, sl2, s);
}

}  // extern "C"
