// K7: packed-qkv rope attention on Hopper, one hand-written persistent kernel.
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
// 989 TFLOP/s) against 1.25 GB of qkv in and heads out (0.372 ms at
// 3.35 TB/s): 60,832 tiny (sequence, head) problems, so what matters is that
// loads, products and stores overlap, not the tensor-core rate. mma.sync
// m16n8k16 keeps up with the bytes; wgmma would buy nothing here.
//
// Design. A persistent grid, one block per SM, walks the (sequence, head
// group) items in a static stride. A group is G heads whose q, k and v
// columns, G * dh, are whole 64-column TMA boxes (G = 4 at dh 32: 128
// columns), so each item is 3 * G * dh / 64 boxes of a 3-D (3 h dh, n, b)
// tensor map with the 128-byte swizzle. The map's rows end at n: the rows of
// a box past n are TMA's zeros, never the next sequence's rows (a non-finite
// value there times p = 0 would leak NaN across sequences), and n > 256 takes
// several boxes along n. Three roles, each on its own mbarrier of a ring of
// stages (three at Apollo's shape), so that no role waits for another's
// latency:
//   - one producer thread loads each item into a free stage (full) and, once
//     the attention has left it (done), writes its output by TMA store
//     through a (h dh, n, b) map, which drops rows past n and columns past
//     h dh, and reloads the stage when the store has read it;
//   - rope warps rotate each landed item's q and k in place (roped) in the
//     TPU kernel's rounding, y = bf16(bf16(x * cos) + bf16(rot(x) * sin)),
//     as three bf16x2 fma.rn: a lane reads one (row, 16-byte chunk) of cos
//     and sin and rotates that chunk in q and k of every head of the item.
//     The block stages the tables once in shared memory where they fit.
//     Roping the q and k fragments inside the attention instead redid k's
//     rope once per query tile, and roping by the attention warps themselves
//     held their tasks behind the next item's load;
//   - attention warps take the items' (head, 16-query tile) tasks in one
//     rotation that carries over from item to item, so no warp waits at the
//     end of an item while another finishes it: q fragments by ldmatrix from
//     the swizzled slab (the swizzle, not row padding, makes every ldmatrix
//     phase conflict-free), keys in steps of 32 (16-key halves with no valid
//     key skipped) with mma.sync, an online softmax in f32 base 2 on
//     ex2.approx, p rounded to bf16 before p . v, V by ldmatrix.trans; the
//     finished tile overwrites its own q rows in the stage (no other task
//     reads them), which the producer then stores.
// Head widths. The kernel is built for a head width W, a multiple of 8 up to
// 128, and runs its products at DH = ceil(W / 16) * 16 (the mma.sync
// k-step): the slabs hold the real packed columns (head h from column h * W,
// 16-byte aligned), and where W % 16 = 8 the last 8 columns of a head's last
// 16-column step are another head's (or past the slab): the q fragment's
// half there is zeroed, so q . k^T is exact, the key and value addresses of
// that half are clamped into the head (finite values whose products are
// dropped), and only W output columns are stored. All of it is decided at
// compile time, so a width that is a multiple of 16 compiles to the kernel
// as it was before other widths were taken.
// A head width that is not a multiple of 8 has rows that are not 16-byte
// aligned; the host repacks it to the next multiple of 8 (ops/attention.py
// k7_plan, fused_rope_attention), or the caller pads its weights.
// The host plans group, boxes, stages, the tables' place, grid and shared
// memory (ops/attention.py k7_plan); the entry point refuses a plan that does
// not match the layout here.
#include <climits>

#include "hopper.cuh"

namespace sesa {

constexpr int RA_BK = 32;        // keys per online-softmax step
constexpr int RA_BOX_COLS = 64;  // columns of a TMA box: 128 bytes, the swizzle's span
constexpr int RA_SMEM_MAX = 232448;

// the warps of a block: one producer, ROPE that rope each staged item in
// place, ATTN that take its attention tasks (by head width: registers hold
// the q fragments, the f32 output tile and the scores)
template <int DH>
struct RaCfg {
  static constexpr int ROPE = DH <= 32 ? 4 : DH <= 64 ? 3 : 2;
  static constexpr int ATTN = DH <= 32 ? 11 : DH <= 64 ? 8 : 5;
  static constexpr int THREADS = 32 * (1 + ROPE + ATTN);
};

// the rope tables staged in shared memory: cos then sin, n rows each of
// rot_w values padded to an odd number of 16-byte chunks (ra_table_pitch
// elements), so that the 8 consecutive rows a quarter-warp of the rope reads
// of one chunk lie in 8 distinct bank groups
__host__ __device__ inline int ra_table_pitch(int rot_w) {
  return (((rot_w * 2 + 31) & ~31) + 16) / 2;
}
inline long long ra_table_bytes(int n, int rot_w) {
  return 2LL * n * ra_table_pitch(rot_w) * 2;
}
// dynamic shared memory of a plan: `stages` ring stages of three slabs (q, k,
// v) of `boxes` boxes of `rows` x 128 bytes and three mbarriers each (full,
// roped, done), the rope tables (`table` bytes, 0 where they are read from
// device memory) and 1024 bytes to align the ring for the 128-byte swizzle
inline long long ra_smem_bytes(int boxes, int rows, int stages, long long table) {
  return (long long)stages * (3LL * boxes * rows * 128 + 24) + table + 1024;
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// byte offset, in a slab of 64-column boxes of `rows` rows of 128 bytes, of
// the 16-byte chunk that holds (row, col), col a multiple of 8: TMA's
// 128-byte swizzle stores chunk c of a row at chunk c ^ (row % 8)
__device__ __forceinline__ uint32_t ra_swz(int row, int col, int rows) {
  return (uint32_t)((((col >> 6) * rows + row) << 7) + ((((col >> 3) ^ row) & 7) << 4));
}

// a * b and a + b on bf16 pairs, each rounded once (fma.rn with -0 and with 1)
__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}
__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(0x3f803f80u), "r"(b));
  return d;
}

// the interleaved rope of the pair x = (x_d, x_d+1) with the pairs c and s of
// cos and sin: bf16(bf16(x * cos) + bf16(rot(x) * sin)) with
// rot(x) = (-x_d+1, x_d), the TPU kernel's rounding
__device__ __forceinline__ uint32_t rope_pair(uint32_t x, uint32_t c, uint32_t s) {
  const uint32_t r = __byte_perm(x, 0u, 0x1032) ^ 0x8000u;
  return bf2_add(bf2_mul(x, c), bf2_mul(r, s));
}

// The rope, in place, of the item staged at `st`: rows < n of its q and k
// slabs, the leading rot_w columns of each of its gh heads of W columns. A quarter-warp
// takes 8 consecutive rows of one 16-byte column chunk of the rotary width
// (8 rows: the swizzle puts their chunks in 8 distinct bank groups), reads
// that (row, chunk) of cos and sin once and rotates it in q and k of every
// head of the item; the `nr` rope warps take the row blocks in turn. cos and
// sin come from shared memory where the plan stages them (through a generic
// pointer, else from device memory).
template <int W>
__device__ __forceinline__ void ra_rope_item(unsigned char* st, uint32_t slab, int rows, int n,
                                             int gh, const bf16* cos_t, const bf16* sin_t,
                                             int pitch, int rot_w, int rw, int nr, int lane) {
  const int rc = (rot_w + 7) >> 3;
  for (int cc = lane >> 3; cc < rc; cc += 4) {
    const int d0 = cc * 8, pairs = min(4, (rot_w - d0) >> 1);  // fewer: a partial width
    const bool whole = pairs == 4 && (rot_w & 7) == 0;  // 16-byte rows of cos and sin
    for (int r = rw * 8 + (lane & 7); r < n; r += 8 * nr) {
      const size_t o = (size_t)r * pitch + d0;
      uint32_t c[4], sn[4];
      if (whole) {
        *reinterpret_cast<uint4*>(c) = *reinterpret_cast<const uint4*>(cos_t + o);
        *reinterpret_cast<uint4*>(sn) = *reinterpret_cast<const uint4*>(sin_t + o);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < pairs) {
            c[i] = *reinterpret_cast<const uint32_t*>(cos_t + o + 2 * i);
            sn[i] = *reinterpret_cast<const uint32_t*>(sin_t + o + 2 * i);
          }
      }
      for (int comp = 0; comp < 2; ++comp)
        for (int h = 0; h < gh; ++h) {
          uint4* p = reinterpret_cast<uint4*>(st + comp * slab + ra_swz(r, h * W + d0, rows));
          uint4 v = *p;
          uint32_t* x = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (i < pairs) x[i] = rope_pair(x[i], c[i], sn[i]);
          *p = v;
        }
    }
  }
}

// One (head, 16-query tile) task of the item staged at `st` (shared address
// `st_s`): its head's W columns start at `hc` in each slab of `slab` bytes.
template <int W>
__device__ __forceinline__ void ra_task(unsigned char* st, uint32_t st_s, uint32_t slab, int rows,
                                        int n, int hc, int q0, float scale_log2, int lane) {
  constexpr int DH = (W + 15) / 16 * 16;
  // W % 16 = 8: the upper 8 columns of the last 16-column step belong to
  // another head; their addresses are clamped to the step's lower 8, and
  // q's half there is zeroed
  constexpr bool HALF = W != DH;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix.x4 lane addressing, as the attention cores of K1 and K4
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  auto col = [&](int kk, int c) {
    return hc + kk * 16 + (HALF && kk == DH / 16 - 1 ? 0 : c);
  };

  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    ldsm_x4(qf[kk], st_s + ra_swz(q0 + a_row, col(kk, a_col), rows));
    if (HALF && kk == DH / 16 - 1) qf[kk][2] = qf[kk][3] = 0u;  // A's k columns 8-15
  }
  // every step starts on a multiple of 16 rows, so row % 8 = lane % 8 and
  // each lane's swizzled column offsets are fixed: the step adds 128 a row
  uint32_t koff[DH / 16], voff[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    koff[kk] = st_s + slab + ra_swz(b_row, col(kk, b_col), rows);
    voff[kk] = st_s + 2 * slab + ra_swz(a_row, col(kk, a_col), rows);
  }
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
      if (jj < halves) {  // no `break`: the loop must stay unrolled (s in registers)
        const int kr = k0 + jj * 16;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          uint32_t r[4];
          ldsm_x4(r, koff[kk] + kr * 128);
          mma_bf16_16816(s[2 * jj], qf[kk], r[0], r[1]);
          mma_bf16_16816(s[2 * jj + 1], qf[kk], r[2], r[3]);
        }
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
      corr[r] = fast_exp2(m_run[r] - mx[r]);  // 2^-inf = 0 on the first step
      m_run[r] = mx[r];
      l_run[r] *= corr[r];  // this thread's share of the row sum
    }
#pragma unroll
    for (int j = 0; j < RA_BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = fast_exp2(s[j][e] - mx[e >> 1]);
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
      if (kk < halves) {
        uint32_t pa[4];
        pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int ii = 0; ii < DH / 16; ++ii) {
          uint32_t r[4];
          ldsm_x4_t(r, voff[ii] + (k0 + kk * 16) * 128);
          mma_bf16_16816(o[2 * ii], pa, r[0], r[1]);
          mma_bf16_16816(o[2 * ii + 1], pa, r[2], r[3]);
        }
      }
    }
  }

  // normalise; the tile replaces its own q rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv_l = 1.0f / l;
    const int row = q0 + g + 8 * r;
#pragma unroll
    for (int i = 0; i < W / 8; ++i)  // the columns past W are another head's q
      *reinterpret_cast<uint32_t*>(st + ra_swz(row, hc + i * 8, rows) + 4 * t) =
          pack_bf16x2(o[i][2 * r] * inv_l, o[i][2 * r + 1] * inv_l);
  }
}

template <int W>
__global__ void __launch_bounds__(RaCfg<(W + 15) / 16 * 16>::THREADS, 1)
rope_attn_kernel(const __grid_constant__ CUtensorMap tin, const __grid_constant__ CUtensorMap tout,
                 const bf16* cos_t, const bf16* sin_t, int n,
                 int heads, int group, int rot_w, int nbox, int box_rows, int stages, int table,
                 int items, float scale_log2) {
  using Cfg = RaCfg<(W + 15) / 16 * 16>;
  constexpr int ROPE = Cfg::ROPE, ATTN = Cfg::ATTN;
  extern __shared__ unsigned char ra_raw[];
  unsigned char* smem = ra_raw + ((1024 - (smem_u32(ra_raw) & 1023)) & 1023);
  const int rows = nbox * box_rows, boxes = group * W / RA_BOX_COLS, width = group * W;
  const int hd = heads * W, groups = (heads + group - 1) / group;
  const uint32_t slab = (uint32_t)boxes * rows * 128, stage_bytes = 3 * slab;
  unsigned char* tab = smem + (size_t)stages * stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(tab + table);
  uint64_t* roped = full + stages;
  uint64_t* done = roped + stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(roped + s, 32 * ROPE);
      mbar_init(done + s, 32 * ATTN);
    }
    mbar_init_fence();
  }
  int pitch = rot_w;
  if (table > 0) {  // the rope tables, once a block: the rope reads them for every item
    const int wpr = rot_w / 2, words = n * wpr;
    pitch = ra_table_pitch(rot_w);
    const uint32_t* gc = reinterpret_cast<const uint32_t*>(cos_t);
    const uint32_t* gs = reinterpret_cast<const uint32_t*>(sin_t);
    uint32_t* sc = reinterpret_cast<uint32_t*>(tab);
    uint32_t* ss = reinterpret_cast<uint32_t*>(tab + table / 2);
    for (int i = threadIdx.x; i < words; i += blockDim.x) {
      const int r = i / wpr, k = i - r * wpr;
      sc[r * (pitch / 2) + k] = __ldg(gc + i);
      ss[r * (pitch / 2) + k] = __ldg(gs + i);
    }
    cos_t = reinterpret_cast<const bf16*>(sc);
    sin_t = reinterpret_cast<const bf16*>(ss);
  }
  __syncthreads();

  if (warp == 0) {  // the producer: loads into the ring, stores out of it
    if (lane != 0) return;
    tma_prefetch(&tin);
    tma_prefetch(&tout);
    // an item's boxes along the columns: G * dh / 64, less those wholly past
    // the last head (a partial last group)
    auto item_boxes = [&](int grp) {
      return min(boxes, (hd - grp * width + RA_BOX_COLS - 1) / RA_BOX_COLS);
    };
    auto store = [&](int j) {  // the output of the block's j-th item, from its q slab
      const int item = blockIdx.x + j * gridDim.x, seq = item / groups, grp = item % groups;
      const unsigned char* sq = smem + (size_t)(j % stages) * stage_bytes;
      const int nb = item_boxes(grp);
      for (int bx = 0; bx < nb; ++bx)
        for (int rb = 0; rb < nbox; ++rb)
          tma_store_3d(&tout, sq + ((size_t)bx * rows + rb * box_rows) * 128,
                       grp * width + bx * RA_BOX_COLS, rb * box_rows, seq);
      bulk_commit();
    };
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      const int s = it % stages, seq = item / groups, grp = item % groups;
      const int nb = item_boxes(grp);
      if (it >= stages) {  // the stage's last item: done, then stored, then free
        mbar_wait(done + s, (it / stages - 1) & 1);
        store(it - stages);
        bulk_wait_read<0>();
      }
      unsigned char* st = smem + (size_t)s * stage_bytes;
      mbar_expect_tx(full + s, 3u * nb * nbox * box_rows * 128);
      for (int c = 0; c < 3; ++c)
        for (int bx = 0; bx < nb; ++bx)
          for (int rb = 0; rb < nbox; ++rb)
            tma_load_3d(st + c * slab + ((size_t)bx * rows + rb * box_rows) * 128, &tin,
                        full + s, c * hd + grp * width + bx * RA_BOX_COLS, rb * box_rows, seq);
    }
    for (int j = max(0, it - stages); j < it; ++j) {
      mbar_wait(done + j % stages, (j / stages) & 1);
      store(j);
    }
    bulk_wait<0>();
    return;
  }

  // every warp below waits for every item's barrier in order, so the parity
  // waits never skip a phase
  int s = 0;
  uint32_t phase = 0;
  if (warp <= ROPE) {  // the rope warps: rope each item as soon as it lands
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      mbar_wait(full + s, phase);
      if (rot_w > 0)
        ra_rope_item<W>(smem + (size_t)s * stage_bytes, slab, rows, n,
                        min(group, heads - item % groups * group), cos_t, sin_t, pitch, rot_w,
                        warp - 1, ROPE, lane);
      mbar_arrive(roped + s);
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }
  // the attention warps: the tasks whose place in the block's task stream is
  // their own modulo ATTN, so the rotation carries over from item to item
  const int aw = warp - 1 - ROPE, qtiles = (n + 15) >> 4;
  const uint32_t smem_s = smem_u32(smem);
  int rot = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tasks = min(group, heads - item % groups * group) * qtiles;
    mbar_wait(roped + s, phase);
    for (int task = (aw - rot + ATTN) % ATTN; task < tasks; task += ATTN)
      ra_task<W>(smem + (size_t)s * stage_bytes, smem_s + s * stage_bytes, slab, rows, n,
                 task / qtiles * W, task % qtiles * 16, scale_log2, lane);
    rot = (rot + tasks) % ATTN;
    fence_proxy_async();  // the output rows, to the producer's TMA store
    mbar_arrive(done + s);
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
}

}  // namespace sesa

using namespace sesa;

template <int W>
static int launch_rope_attn(const void* qkv, const void* cos_t, const void* sin_t, void* out,
                            int batch, int n, int heads, int group, int rot_w, int nbox,
                            int box_rows, int stages, int table, int grid, int smem,
                            float scale_log2, cudaStream_t s) {
  const int n16 = (n + 15) & ~15, rows = nbox * box_rows;
  const long long items = (long long)batch * ((heads + group - 1) / group);
  if (group < 1 || group * W % RA_BOX_COLS || nbox < 1 || box_rows < 8 || box_rows > 256 ||
      box_rows % 8 || rows < n16 || (nbox - 1) * box_rows >= n16 || stages < 1 ||
      (table != 0 && table != ra_table_bytes(n, rot_w)) ||
      smem != ra_smem_bytes(group * W / RA_BOX_COLS, rows, stages, table) || smem > RA_SMEM_MAX ||
      items > INT_MAX || grid < 1 || grid > items)
    return (int)cudaErrorInvalidValue;
  const uint64_t hd = (uint64_t)heads * W;
  // (3 h dh, n, b) in and (h dh, n, b) out: rows past n are outside the map
  const uint64_t din[3] = {3 * hd, (uint64_t)n, (uint64_t)batch};
  const uint64_t sin_b[2] = {3 * hd * 2, 3 * hd * 2 * n};
  const uint64_t dout[3] = {hd, (uint64_t)n, (uint64_t)batch};
  const uint64_t sout_b[2] = {hd * 2, hd * 2 * n};
  const uint32_t box[3] = {(uint32_t)RA_BOX_COLS, (uint32_t)box_rows, 1};
  CUtensorMap tin, tout;
  int rc = make_tmap_bf16(&tin, qkv, 3, din, sin_b, box, 128);
  if (rc != 0) return rc;
  rc = make_tmap_bf16(&tout, out, 3, dout, sout_b, box, 128);
  if (rc != 0) return rc;
  const cudaError_t e =
      cudaFuncSetAttribute(rope_attn_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  rope_attn_kernel<W><<<grid, RaCfg<(W + 15) / 16 * 16>::THREADS, smem, s>>>(
      tin, tout, (const bf16*)cos_t, (const bf16*)sin_t, n, heads, group, rot_w, nbox, box_rows,
      stages, table, (int)items, scale_log2);
  return (int)cudaGetLastError();
}

extern "C" {

// out (batch, n, heads * dim_head) = softmax(rope(q) . rope(k)^T * scale) . v
// per (sequence, head) of the packed, component-major qkv (batch, n,
// 3 * heads * dim_head), dim_head a multiple of 8 up to 128 (its products
// at the next multiple of 16); cos_t/sin_t (n, rot_width) or null
// (rot_width 0). group, nbox, box_rows, stages, table, grid, smem: the plan
// of ops/attention.py k7_plan
int sesa_rope_attn(const void* qkv, const void* cos_t, const void* sin_t, void* out, int batch,
                   int n, int heads, int dim_head, int group, int rot_width, int nbox,
                   int box_rows, int stages, int table, int grid, int smem, float scale,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float sl2 = scale * 1.4426950408889634f;
  if (batch < 1 || n < 1 || heads < 1 || rot_width < 0 || rot_width % 2 ||
      rot_width > dim_head || (rot_width > 0 && (cos_t == nullptr || sin_t == nullptr)))
    return (int)cudaErrorInvalidValue;
  int (*launch)(const void*, const void*, const void*, void*, int, int, int, int, int, int, int,
                int, int, int, int, float, cudaStream_t) = nullptr;
  switch (dim_head) {
    case 8: launch = &launch_rope_attn<8>; break;
    case 16: launch = &launch_rope_attn<16>; break;
    case 24: launch = &launch_rope_attn<24>; break;
    case 32: launch = &launch_rope_attn<32>; break;
    case 40: launch = &launch_rope_attn<40>; break;
    case 48: launch = &launch_rope_attn<48>; break;
    case 56: launch = &launch_rope_attn<56>; break;
    case 64: launch = &launch_rope_attn<64>; break;
    case 72: launch = &launch_rope_attn<72>; break;
    case 80: launch = &launch_rope_attn<80>; break;
    case 88: launch = &launch_rope_attn<88>; break;
    case 96: launch = &launch_rope_attn<96>; break;
    case 104: launch = &launch_rope_attn<104>; break;
    case 112: launch = &launch_rope_attn<112>; break;
    case 120: launch = &launch_rope_attn<120>; break;
    case 128: launch = &launch_rope_attn<128>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  return launch(qkv, cos_t, sin_t, out, batch, n, heads, group, rot_width, nbox, box_rows,
                stages, table, grid, smem, sl2, s);
}

}  // extern "C"
