"""The host side of K4 and K5 on the CPU: the launch plans ``k4_plan`` and
``k5_plan``, K4's expanded Shaw table against ``shaw_rel_index`` and the JAX
wrapper's ``e_exp``, the index arithmetic of K4's wgmma core (the table box,
the warp-private q.E tiles and the skew) and of K5's GLU epilogue and
stencil tiles, each replayed in numpy, and a tile-by-tile reference of the
skewed bias held against ``fused_conformer_attention_plain``. The kernels
themselves run only on the card (``chip_smoke.py``). These tests add about
4 s to the suite."""

import os
import re

import numpy as np
import pytest
import torch

from sesa_tpu_torch.ops import attention as attn_ops
from sesa_tpu_torch.ops.attention import (fused_conformer_attention_plain, k4_plan,
                                          shaw_rel_index, shaw_table)
from sesa_tpu_torch.ops.convblock import conv_pad, k5_plan
from sesa_tpu_torch.ops.ff import layer_norm_rounded

SMEM_BLOCK_MAX = 232_448  # dynamic shared memory one block may use on the H100
CSRC = os.path.join(os.path.dirname(attn_ops.__file__), "..", "csrc")

# (b, n, d, heads, dh, P): the mel-band conformer's time and freq legs, the
# two sides of the route boundary (n 64 and 65), P below and above n, the
# three head widths
K4_CASES = [(360, 690, 384, 8, 64, 512), (4140, 60, 384, 8, 64, 512),
            (3, 64, 128, 2, 64, 512), (3, 65, 128, 2, 64, 16), (2, 300, 64, 2, 32, 512),
            (3, 130, 64, 2, 32, 64), (2, 70, 128, 1, 128, 512), (2, 300, 256, 2, 128, 100),
            (1, 1, 64, 1, 32, 4)]


def _schedule(tiles, grid):
    """The tiles each block of a persistent launch takes: b, b + grid, ..."""
    return [np.arange(block, tiles, grid) for block in range(grid)]


@pytest.mark.parametrize("b,n,d,heads,dh,max_pos", K4_CASES)
def test_k4_plan(b, n, d, heads, dh, max_pos):
    """K4's plan: the route by n and dim_head (tiles iff n > 64 at dim_head 32
    or 64), every launch's shared memory within a block's limit and the sum
    of its buffers, one block per SM on the tiles route, the expanded table's
    rows (2 n_pad) and the (d, s, h, b) maps over the qkv buffer."""
    hd = heads * dh
    plan = k4_plan(b, n, d, heads, dh, 132)
    core = plan["core"]
    tiles_route = n > 64 and dh in (32, 64)
    assert core["route"] == ("tiles" if tiles_route else "mma")
    assert core["route_id"] == attn_ops._K4_ROUTES[core["route"]]
    n_pad = -(-n // 128) * 128
    if tiles_route:
        assert core["tiles"] == b * heads * -(-n // 128)
        assert core["grid"] == min(core["tiles"], 132)
        assert core["table_rows"] == 2 * n_pad and core["box_origin"] == n_pad - 128
    else:
        assert core["tiles"] == core["grid"] == b * heads * -(-n // 64)
        assert core["table_rows"] == 0
    assert core["smem"] == sum(core["buffers"].values())
    assert core["dims"] == (dh, n, heads, b)
    assert core["strides"] == (2 * 3 * hd, 2 * dh, 2 * n * 3 * hd)
    assert all(st % 16 == 0 for st in core["strides"])
    assert core["out_strides"] == (n * hd, dh, hd)
    for name, cols, depth in (("proj", 3 * hd, d), ("out", d, hd)):
        g = plan[name]
        assert g["tiles"] == -(-b * n // 128) * -(-cols // 128)
        assert g["grid"] % -(-cols // 128) == 0 and 1 <= g["grid"] <= g["tiles"]
        assert g["smem"] == (230_488 if depth <= 512 else 197_736)
    assert all(plan[k]["smem"] <= SMEM_BLOCK_MAX for k in ("proj", "out", "core"))


@pytest.mark.parametrize("dh,route,smem", [(64, "tiles", 226_368), (32, "tiles", 152_640),
                                           (64, "mma", 104_448), (32, "mma", 67_584),
                                           (128, "mma", 178_176)])
def test_k4_plan_is_the_kernels_layout(dh, route, smem):
    """The plan's shared memory and route ids are what csrc/flash_shaw.cuh
    (ShawCfg) and csrc/conformer_attention.cu (conf_attn_smem_bytes,
    K4CoreRoute, K4_MMA_MAX_N) lay out and check: a change to either side
    shows here."""
    n = 690 if route == "tiles" else 60
    assert k4_plan(4, n, 384, 8, dh, 132)["core"]["smem"] == smem
    src = open(os.path.join(CSRC, "conformer_attention.cu")).read()
    enum = re.search(r"enum K4CoreRoute \{ K4_CORE_TILES = (\d+), K4_CORE_MMA = (\d+) \}", src)
    assert enum and {"tiles": int(enum.group(1)), "mma": int(enum.group(2))} == attn_ops._K4_ROUTES
    assert int(re.search(r"K4_MMA_MAX_N = (\d+);", src).group(1)) == attn_ops._K4_MMA_MAX_N
    shaw = open(os.path.join(CSRC, "flash_shaw.cuh")).read()
    assert re.search(r"QE_COLS = (\d+), QE_LD = (\d+);", shaw).groups() == (
        str(_QE_COLS), str(_QE_LD))


@pytest.mark.parametrize("b,n,heads", [(3, 690, 2), (2, 65, 3), (4, 300, 1)])
def test_k4_plan_covers_every_tile_once(b, n, heads):
    """The tiles route's persistent grid covers every (sequence, head, query
    row) once, a consumer warpgroup's 64 rows each of a 128-query tile."""
    core = k4_plan(b, n, 128, heads, 64, 132)["core"]
    covered = np.zeros((b * heads, n), np.int64)
    q_tiles = -(-n // 128)
    for mine in _schedule(core["tiles"], core["grid"]):
        for tile in mine:
            for cw in range(2):
                seq, r0 = tile // q_tiles, (tile % q_tiles) * 128 + 64 * cw
                covered[seq, r0:min(r0 + 64, n)] += 1
    assert (covered == 1).all()


# csrc/flash_shaw.cuh: a warp's q.E tile keeps QE_COLS columns at a row
# stride of QE_LD f32; queries and keys in tiles of 128, 64 queries a consumer
_QE_COLS, _QE_LD, _BQ, _BK = 144, 152, 128, 128


def _box_row(i, j, n, origin):
    """The table row that the tiles route reads for query i and key j: the
    tile pair's box starts at q0 - k0 + origin, the consumer's 192 rows at
    64 cw of it, and q.E column a - c + 127 of that window."""
    q0, k0 = (i // _BQ) * _BQ, (j // _BK) * _BK
    cw, a, c = (i - q0) // 64, (i - q0) % 64, j - k0
    return q0 - k0 + origin + 64 * cw + a - c + _BK - 1


@pytest.mark.parametrize("n,max_pos", [(690, 512), (65, 16), (300, 512), (130, 64), (1, 4)])
def test_shaw_table_box_addressing(n, max_pos):
    """The device-side expanded table (shaw_table, run here on the CPU) read
    where the kernel's box addressing reads it gives, for every (i, j),
    rel[clip(i - j, -P, P) + P], the row shaw_rel_index names; every box lies
    inside the table."""
    rel = torch.arange(2 * max_pos + 1, dtype=torch.float32)[:, None].repeat(1, 8)
    table = shaw_table(rel, n)
    core = k4_plan(1, n, 64, 1, 32, 132)["core"]
    n_pad = -(-n // 128) * 128
    assert table.shape == (2 * n_pad, 8)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    rows = _box_row(i, j, n, n_pad - 128)
    np.testing.assert_array_equal(table[:, 0].numpy()[rows], shaw_rel_index(n, max_pos))
    if core["route"] == "tiles":
        assert core["table_rows"] == table.shape[0] and core["box_origin"] == n_pad - 128
    starts = [q0 - k0 + n_pad - 128 for q0 in range(0, n, 128) for k0 in range(0, n, 128)]
    assert min(starts) >= 0 and max(starts) + 256 <= 2 * n_pad


@pytest.mark.parametrize("n,max_pos", [(690, 512), (65, 16), (130, 64)])
def test_shaw_table_matches_jax_e_exp(n, max_pos):
    """The same rows as the JAX wrapper's pre-clipped expanded table
    (sesa_tpu/ops/attention.py fused_conformer_attention: row r of e_exp is
    E[clip((sp - 1) - r, -P, P) + P], sp = n padded to 64), in the opposite
    order: distance dist is row dist + n_pad - 1 here and (sp - 1) - dist
    there, for every distance of n positions."""
    rng = np.random.default_rng(n)
    rel = rng.standard_normal((2 * max_pos + 1, 16)).astype(np.float32)
    sp = n + (-n) % 64
    rel_idx = np.clip((sp - 1) - np.arange(2 * sp), -max_pos, max_pos) + max_pos
    e_exp = rel[rel_idx]
    table = shaw_table(torch.from_numpy(rel), n).numpy()
    n_pad = -(-n // 128) * 128
    dist = np.arange(-(n - 1), n)
    np.testing.assert_array_equal(table[dist + n_pad - 1], e_exp[(sp - 1) - dist])


def test_k4_skew_store_and_read_indices():
    """flash_shaw.cuh's shaw_qe_store and shaw_skew_add replayed for every
    thread of a consumer: the value a thread reads for S[a][c] is the one a
    thread of its warp stored for QE[a][a - c + 127], within the warp's tile,
    and every such value was stored."""
    qe = np.arange(64 * 192, dtype=np.int64).reshape(64, 192) + 1  # QE[a][m], nonzero
    for warp in range(4):
        tile = np.zeros(16 * _QE_LD, np.int64)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for jj in range(24):
                q = jj - 2 * warp
                if 0 <= q < _QE_COLS // 8:
                    for h in range(2):
                        for e in range(2):
                            idx = (g + 8 * h) * _QE_LD + 8 * q + 2 * t + e
                            assert tile[idx] == 0
                            tile[idx] = qe[16 * warp + g + 8 * h, 8 * jj + 2 * t + e]
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            base = g * (_QE_LD + 1) + (_BK - 1) - 2 * t
            for j in range(16):
                for h in range(2):
                    for e in range(2):
                        idx = base + 8 * h * (_QE_LD + 1) - 8 * j - e
                        a, c = 16 * warp + g + 8 * h, 8 * j + 2 * t + e
                        assert 0 <= idx < 16 * _QE_LD
                        assert tile[idx] == qe[a, a - c + _BK - 1]


def _tiles_attention_reference(x, ln_w, ln_b, wqkv, rel, wo, bo, heads):
    """K4 as the tiles route computes it, in f32: per (sequence, head, query
    tile, consumer, key tile) QE = Q_c . T_box^T over the consumer's 192 rows
    of the tile pair's table box, the skew S[a][c] += QE[a][a - c + 127], then
    the softmax over the assembled logits (keys >= n never read) and the
    products."""
    b, n, d = x.shape
    dh = wqkv.shape[0] // (3 * heads)
    xn = layer_norm_rounded(x, ln_w, ln_b)
    qkv = xn @ wqkv.T
    q, k, v = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    table = shaw_table(rel, n)
    n_pad = -(-n // 128) * 128
    qp = torch.zeros((b, heads, n_pad, dh))
    qp[:, :, :n] = q
    bias = torch.zeros((b, heads, n_pad, n_pad))
    for q0 in range(0, n_pad, _BQ):
        for k0 in range(0, n_pad, _BK):
            box = table[q0 - k0 + n_pad - 128:][:256]
            for cw in range(2):
                qe = qp[:, :, q0 + 64 * cw:q0 + 64 * cw + 64] @ box[64 * cw:64 * cw + 192].T
                a = torch.arange(64)[:, None]
                m = a - torch.arange(_BK)[None, :] + _BK - 1
                bias[:, :, q0 + 64 * cw:q0 + 64 * cw + 64, k0:k0 + _BK] = \
                    torch.gather(qe, -1, m.expand(b, heads, 64, _BK))
    s = (q @ k.transpose(-1, -2) + bias[:, :, :n, :n]) * dh ** -0.5
    o = torch.softmax(s, dim=-1) @ v
    return (o.permute(0, 2, 1, 3).reshape(b, n, heads * dh) @ wo.T + bo) + x


@pytest.mark.parametrize("n,max_pos", [(300, 100), (200, 512)])
def test_k4_tiles_reference_matches_plain(n, max_pos):
    """The tile-by-tile skewed bias of the tiles route gives the output of
    fused_conformer_attention_plain (the gathered (n, n) bias) in f32, with
    clipping (P 100 < n) and without (P 512 > n), across several query and
    key tiles. Tolerance: f32 sums in another order."""
    rng = np.random.default_rng(n + max_pos)
    b, d, heads, dh = 2, 64, 2, 32
    r = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.05).astype(np.float32))  # noqa: E731
    x = torch.from_numpy(rng.standard_normal((b, n, d)).astype(np.float32))
    args = (x, 1.0 + 2 * r(d), r(d), r(3 * heads * dh, d), r(2 * max_pos + 1, dh),
            r(d, heads * dh), r(d))
    got = _tiles_attention_reference(*args, heads)
    ref = fused_conformer_attention_plain(*args, heads)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=1e-5)


# (b, n, d, e): the mel-band conformer's legs, a sequence of one row, of one
# part-filled tile and of several tiles
K5_CASES = [(360, 690, 384, 768), (4140, 60, 384, 768), (5, 1, 64, 128), (3, 100, 64, 128),
            (2, 300, 64, 128), (2, 129, 128, 256)]


@pytest.mark.parametrize("b,n,d,e", K5_CASES)
def test_k5_plan(b, n, d, e):
    """K5's plan: both products' persistent grids (a multiple of the column
    blocks, never more blocks than tiles) and shared memory, the stencil's
    tile of 16 rows a warp (one whole sequence up to 128 rows), its work items
    and persistent grid of 16 warps an SM, each block a contiguous run of
    items; every launch within a block's shared memory."""
    plan = k5_plan(b, n, d, e, 132, 31)
    for name, cols, depth in (("up", 2 * e, d), ("down", d, e)):
        g = plan[name]
        assert g["tiles"] == -(-b * n // 128) * -(-cols // 128)
        assert g["grid"] % -(-cols // 128) == 0 and 1 <= g["grid"] <= g["tiles"]
        assert g["smem"] == (230_488 if depth <= 512 else 197_736)
        covered = np.zeros(g["tiles"], np.int64)
        for mine in _schedule(g["tiles"], g["grid"]):
            covered[mine] += 1
        assert (covered == 1).all()
    dw = plan["dw"]
    assert dw["rows"] % 16 == 0 and 16 <= dw["rows"] <= 128 and dw["threads"] == 2 * dw["rows"]
    assert dw["rows"] >= min(n, 128) and dw["rows"] - 16 < max(n, 16)
    assert dw["items"] == -(-n // dw["rows"]) * (e // 64) * b
    assert dw["tap_blocks"] == 1 and dw["steps"] == dw["items"] and dw["box_rows"] == dw["rows"] + 31
    assert dw["grid"] == min(dw["items"], 132 * (16 // (dw["rows"] // 16)))
    assert dw["smem"] <= 48 * 1024  # static shared memory
    # each block's contiguous run of items: every item once
    per = -(-dw["items"] // dw["grid"])
    runs = [range(blk * per, min(dw["items"], blk * per + per)) for blk in range(dw["grid"])]
    assert sorted(i for run in runs for i in run) == list(range(dw["items"]))
    assert all(plan[k]["smem"] <= SMEM_BLOCK_MAX for k in ("up", "down", "dw"))
    src = open(os.path.join(CSRC, "convblock.cu")).read()
    assert int(re.search(r"DW_RPT = (\d+);", src).group(1)) == 16
    assert int(re.search(r"DW_WARPS = (\d+);", src).group(1)) == 8


@pytest.mark.parametrize("n,k", [(300, 31), (60, 31), (33, 8), (130, 32), (1, 31), (5, 2),
                                 (60, 33), (130, 64), (100, 65), (60, 129), (690, 161)])
def test_k5_stencil_tiles_replay(n, k):
    """The stencil's tiles replayed in numpy as csrc/convblock.cu stages and
    sums them (each tile one step a block of 32 taps: staged row r of tap
    block j is sequence row i0 - k // 2 + 32 j + r, TMA's zeros outside
    [0, n), the block's 32 taps of which those >= k are zero, the sums
    carried across the blocks in tap order) give the depthwise convolution
    with the lucidrains padding, for odd and even k, at and past 32 taps."""
    rng = np.random.default_rng(n * 40 + k)
    h = rng.standard_normal((n, 4)).astype(np.float32)
    taps = rng.standard_normal((k, 4)).astype(np.float32)
    dw = k5_plan(1, n, 64, 64, 132, k)["dw"]
    rows, blocks = dw["rows"], dw["tap_blocks"]
    assert blocks == -(-k // 32) and dw["box_rows"] == rows + 31 <= 256
    padded = np.zeros((32 * blocks, 4), np.float32)
    padded[:k] = taps
    got = np.zeros_like(h)
    for i0 in range(0, n, rows):
        acc = np.zeros((rows, 4), np.float32)
        for j in range(blocks):
            staged = np.zeros((rows + 31, 4), np.float32)
            for r in range(rows + 31):
                pos = i0 - k // 2 + 32 * j + r
                if 0 <= pos < n:
                    staged[r] = h[pos]
            for t in range(32):  # every row of the tile at once, tap by tap
                acc = acc + padded[32 * j + t] * staged[t:t + rows]
        got[i0:i0 + rows] = acc[:min(rows, n - i0)]
    before, after = conv_pad(k)
    hp = np.pad(h, ((before, after), (0, 0)))
    want = sum(hp[t:t + n] * taps[t] for t in range(k))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_k5_glu_epilogue_columns():
    """gemm_ws.cuh's WS_BIAS_GLU replayed on every 128-column tile: the
    thread holding the interleaved column pair (8j + 2t, + 1) of tile n0
    stores output column n0 / 2 + 4j + t, which with the wrapper's
    interleaved W1 and b1 is the GLU a * sigmoid(g) of channel n0 / 2 + 4j +
    t."""
    rng = np.random.default_rng(0)
    tokens, d, e = 5, 16, 256
    w1 = rng.standard_normal((2 * e, d)).astype(np.float32)
    b1 = rng.standard_normal(2 * e).astype(np.float32)
    x = rng.standard_normal((tokens, d)).astype(np.float32)
    # the interleave of fused_conformer_conv: rows (a0, g0, a1, g1, ...)
    w1i = w1.reshape(2, e, d).transpose(1, 0, 2).reshape(2 * e, d)
    b1i = b1.reshape(2, e).T.reshape(2 * e)
    acc = x @ w1i.T + b1i
    got = np.full((tokens, e), np.nan, np.float32)
    for n0 in range(0, 2 * e, 128):
        for j in range(16):
            for t in range(4):
                col = n0 + 8 * j + 2 * t
                got[:, n0 // 2 + 4 * j + t] = acc[:, col] / (1 + np.exp(-acc[:, col + 1]))
    h = x @ w1.T + b1
    np.testing.assert_allclose(got, h[:, :e] / (1 + np.exp(-h[:, e:])), rtol=1e-5, atol=1e-5)
