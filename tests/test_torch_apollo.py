"""The port's Apollo kernels (K6, K7) and the Apollo model held against
sesa_tpu on the CPU: the plain versions against the Pallas kernels in
interpret mode and against the unfused JAX functions, the model in f32
against the JAX model with the same weights (through ``params_from_jax``)."""

import itertools
import json
import math
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_collections import ConfigDict

from sesa_tpu.models import apollo as jax_apollo
from sesa_tpu.ops.attention import fused_rope_attention as jax_fused_rope_attention
from sesa_tpu.ops.convblock import fused_apollo_conv as jax_fused_apollo_conv
from sesa_tpu.ops.rope import default_freqs, rope_tables
from sesa_tpu.ops.stft import hann_window as jax_hann_window
from sesa_tpu.ops.stft import istft_ri as jax_istft_ri
from sesa_tpu.ops.stft import stft_ri as jax_stft_ri
from sesa_tpu_torch import cli
from sesa_tpu_torch.audio_io import read_audio, write_audio
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.convert import convert_checkpoint
from sesa_tpu_torch.convert.from_jax import params_from_jax
from sesa_tpu_torch.models import apollo, get_model
from sesa_tpu_torch.ops import attention as attn_ops
from sesa_tpu_torch.ops.attention import (fused_rope_attention, fused_rope_attention_plain,
                                          k7_plan)
from sesa_tpu_torch.ops.convblock import (fused_apollo_conv, fused_apollo_conv_plain,
                                          k6_gemm_grids)
from sesa_tpu_torch.ops.ff import ff_gemm_schedule
from sesa_tpu_torch.ops.stft import hann_window, istft_ri, stft_ri
from sesa_tpu_torch.runtime.session import InferenceSession
from sesa_tpu_torch.tree import tree_map
from tests.test_apollo import export_state_dict


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch: with the tier-1 run's six workers on
    eight cores, torch's thread pools spin against each other (a session
    test of 0.5 s alone took 40 s beside five busy processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


HI = jax.lax.Precision.HIGHEST
# end-to-end f32 tolerance of the JAX package against its torch oracles
ATOL, RTOL = 5e-4, 1e-3
# win 20 ms at 16 kHz: win 320, 161 bins, 79 bands of 2 bins + one of 3
TINY = {"sr": 16000, "win": 20, "feature_dim": 16, "layer": 2}


def _to_t(tree, dtype=torch.float32):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype), tree)


def _to_j(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _within_one_ulp(got, ref):
    """The bf16 rule of the port's tests: the two sides round at the same
    points and differ only in f32 summation order, which can flip a rounded
    value by one bf16 ulp (2**-8 relative). Bound: max error <= 2% of the
    output's largest value, and 99% of elements within one output ulp."""
    assert np.abs(got - ref).max() <= 0.02 * np.abs(ref).max()
    ulp = np.maximum(np.abs(ref), 1e-3) * 2.0 ** -7
    assert np.mean(np.abs(got - ref) <= ulp) >= 0.99


# --------------------------------------------------------------------------
# K6: fused_apollo_conv
# --------------------------------------------------------------------------

def _conv_params(seed, dim, kernel=7):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.05  # noqa: E731
    return {"dw_w": r(dim, 1, kernel), "dw_b": r(dim), "norm": 1.0 + 0.1 * r(dim),
            "pw1_w": r(4 * dim, dim), "pw1_b": r(4 * dim), "pw2_w": r(dim, 4 * dim),
            "pw2_b": r(dim)}


def _conv_both(p, x, tdt, jdt):
    got = fused_apollo_conv(torch.from_numpy(x).to(tdt), _to_t(p, tdt)).float().numpy()
    ref = jax_fused_apollo_conv(jnp.asarray(x, jdt), _to_j(p, jdt), interpret=True)
    return got, np.asarray(ref.astype(jnp.float32))


# the shapes of the JAX package's own K6 test: short pad with the wrap masks
# active, long pad with the masks skipped, a sequence across a 64 boundary
K6_SHAPES = [(3, 62, 32), (2, 100, 32), (1, 257, 64)]


@pytest.mark.parametrize("b,n,dim", K6_SHAPES)
def test_k6_plain_matches_pallas_f32(b, n, dim):
    """f32, at the JAX test's tolerance for this kernel (atol 3e-5, rtol
    1e-4: summation order)."""
    x = np.random.default_rng(n + 1).standard_normal((b, n, dim)).astype(np.float32)
    got, ref = _conv_both(_conv_params(n + dim, dim), x, torch.float32, jnp.float32)
    assert got.shape == (b, n, dim)
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("b,n,dim", K6_SHAPES)
def test_k6_plain_matches_conv_act_norm_apply(b, n, dim):
    """Against the unfused JAX block (zero padding of 3 at both ends of each
    sequence), and the port's own f32 path against both."""
    p = _conv_params(n + dim, dim)
    x = np.random.default_rng(n + 1).standard_normal((b, n, dim)).astype(np.float32)
    ref = np.asarray(jax_apollo._conv_act_norm_apply(_to_j(p), jnp.asarray(x), kernel=7,
                                                     precision=HI))
    got = fused_apollo_conv_plain(torch.from_numpy(x), _to_t(p)).numpy()
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=1e-4)
    port = apollo._conv_act_norm_apply(_to_t(p), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(port, ref, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("b,n,dim", K6_SHAPES)
def test_k6_plain_matches_pallas_bf16(b, n, dim):
    x = np.random.default_rng(n + 1).standard_normal((b, n, dim)).astype(np.float32)
    _within_one_ulp(*_conv_both(_conv_params(n + dim, dim), x, torch.bfloat16, jnp.bfloat16))


def test_k6_sequences_do_not_leak_into_each_other():
    """The halo of one sequence is zero padding, not its neighbour's rows."""
    p = _to_t(_conv_params(5, 32))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 20, 32))
                         .astype(np.float32))
    whole = fused_apollo_conv_plain(x, p)
    for i in range(3):
        np.testing.assert_array_equal(fused_apollo_conv_plain(x[i:i + 1], p).numpy(),
                                      whole[i:i + 1].numpy())


def test_k6_refuses_even_kernels():
    p = _to_t(_conv_params(1, 32, kernel=8))
    x = torch.zeros((1, 20, 32))
    with pytest.raises(ValueError, match="odd"):
        fused_apollo_conv_plain(x, p)
    with pytest.raises(ValueError, match="odd"):
        apollo._conv_act_norm_apply(p, x, kernel=8)


# --------------------------------------------------------------------------
# K7: fused_rope_attention
# --------------------------------------------------------------------------

def _rope_both(b, n, heads, dh, rot, seed, tdt=torch.float32, jdt=jnp.float32):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, 3 * heads * dh)).astype(np.float32)
    rope_j = rope_t = None
    if rot is not None:
        rope_j = rope_tables(jnp.asarray(default_freqs(rot)), n)
        rope_t = tuple(torch.from_numpy(np.asarray(t).copy()) for t in rope_j)
    got = fused_rope_attention(torch.from_numpy(qkv).to(tdt), heads, dh ** -0.5, rope=rope_t)
    ref = jax_fused_rope_attention(jnp.asarray(qkv, jdt), heads, dh ** -0.5, rope=rope_j,
                                   interpret=True)
    return got.float().numpy(), np.asarray(ref.astype(jnp.float32))


# the cases of the JAX package's own K7 tests: no rope, full and partial
# rotary, an odd length, a sequence beyond 128, and a batch of 13 short
# sequences that no grouping divides; and dim_head 48 and 96 (Apollo at
# feature_dim 384 and 768)
@pytest.mark.parametrize("b,n,heads,dh,rot", [
    (3, 50, 2, 16, None), (3, 40, 2, 16, 16), (3, 33, 3, 32, 8), (3, 130, 1, 64, 64),
    (13, 12, 2, 8, None), (3, 33, 2, 48, 16), (2, 40, 2, 96, 96)])
def test_k7_plain_matches_pallas_f32(b, n, heads, dh, rot):
    """f32, at the JAX test's tolerance for this kernel (atol 2e-5)."""
    got, ref = _rope_both(b, n, heads, dh, rot, n)
    assert got.shape == (b, n, heads * dh)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("n,heads,dh,rot", [(33, 3, 32, 8), (80, 2, 32, 32)])
def test_k7_plain_matches_pallas_bf16(n, heads, dh, rot):
    _within_one_ulp(*_rope_both(3, n, heads, dh, rot, n, torch.bfloat16, jnp.bfloat16))


def test_k7_wrapper_is_the_plain_version_on_the_cpu():
    qkv = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 9, 48))
                           .astype(np.float32))
    before = fused_rope_attention.launches
    np.testing.assert_array_equal(fused_rope_attention(qkv, 2, 0.3).numpy(),
                                  fused_rope_attention_plain(qkv, 2, 0.3).numpy())
    assert fused_rope_attention.launches == before  # counts kernel launches only


def test_qkv_head_block_perm_matches_jax():
    np.testing.assert_array_equal(apollo._qkv_head_block_perm(64, 8).numpy(),
                                  np.asarray(jax_apollo._qkv_head_block_perm(64, 8)))


# --------------------------------------------------------------------------
# STFT at Apollo's window: n_fft 882 is not a power of two
# --------------------------------------------------------------------------

def test_stft_at_apollo_window_matches_jax():
    """n_fft 882, hop 441 against the JAX DFT-matrix transform: atol 2e-4 on
    spectra of magnitude up to ~60 (f32 summation order), 1e-5 on the round
    trip."""
    x = np.random.default_rng(3).standard_normal((2, 8820)).astype(np.float32)
    ref = np.asarray(jax_stft_ri(jnp.asarray(x), 882, 441, jax_hann_window(882)))
    got = stft_ri(torch.from_numpy(x), 882, 441, hann_window(882))
    assert got.shape == ref.shape == (2, 442, 21, 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)
    back_ref = np.asarray(jax_istft_ri(jnp.asarray(ref), 882, 441, jax_hann_window(882),
                                       length=8820))
    back = istft_ri(got, 882, 441, hann_window(882), length=8820).numpy()
    np.testing.assert_allclose(back, back_ref, atol=1e-5)
    np.testing.assert_allclose(back, x, atol=1e-5)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """JAX init with every leaf perturbed from a numpy seed (the norms leave
    their identity init), and the same weights in the port."""
    jcfg = ConfigDict({"model": TINY})
    rng = np.random.default_rng(0)
    params_np = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        jax_apollo.init(jax.random.PRNGKey(0), jcfg))
    config = AttrDict({"model": TINY})
    x = (0.1 * rng.standard_normal((2, 2, 4800))).astype(np.float32)
    return dict(jcfg=jcfg, config=config, params_np=params_np, x=x,
                params=params_from_jax(params_np, "apollo", config))


def test_dims_match_jax(tiny):
    assert apollo._dims(tiny["config"]) == jax_apollo._dims(tiny["jcfg"])
    full = {"model": {"sr": 44100, "win": 20, "feature_dim": 256, "layer": 6}}
    sr, win, stride, enc_dim, n, layer, bands = apollo._dims(AttrDict(full))
    assert (win, stride, enc_dim, n, layer) == (882, 441, 442, 256, 6)
    assert bands == [5] * 79 + [47]


def test_init_tree_matches_jax(tiny):
    mine = apollo.init(torch.Generator().manual_seed(0), tiny["config"])
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert shapes(mine) == shapes(tiny["params_np"])
    assert get_model("apollo") is apollo


def test_params_from_jax_rejects_other_trees(tiny):
    broken = dict(tiny["params_np"], out_norm_last=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="does not match"):
        params_from_jax(broken, "apollo", tiny["config"])


def test_apollo_matches_jax_f32(tiny):
    ref = np.asarray(jax_apollo.apply(_to_j(tiny["params_np"]), tiny["jcfg"],
                                      jnp.asarray(tiny["x"])))
    with torch.inference_mode():
        got = apollo.apply(tiny["params"], tiny["config"], torch.from_numpy(tiny["x"])).numpy()
    assert got.shape == ref.shape == (2, 1, 2, 4800)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_folded_path_matches_roformer_apply(tiny):
    """The K7 path (component-major weight, transposes folded away) against
    the head-major f32 path, in f32 through the plain kernel: atol 2e-5."""
    p = tiny["params"]["layers"][0]["band_net"]
    rng = np.random.default_rng(4)
    feat = torch.from_numpy(rng.standard_normal((2, 10, 7, 16)).astype(np.float32))
    z = feat.transpose(1, 2).reshape(-1, 10, 16)
    ref = apollo._roformer_apply(p, z).reshape(2, 7, 10, 16).transpose(1, 2)
    got = apollo._roformer_apply_folded(p, feat)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5)
    jref = jax_apollo._roformer_apply(_to_j(tiny["params_np"]["layers"][0]["band_net"]),
                                      jnp.asarray(z.numpy()), precision=HI)
    np.testing.assert_allclose(ref.transpose(1, 2).reshape(-1, 10, 16).numpy(),
                               np.asarray(jref), atol=2e-5)
    prepared = apollo.prepare(tiny["params"], tiny["config"])["layers"][0]["band_net"]
    np.testing.assert_array_equal(apollo._roformer_apply_folded(prepared, feat).numpy(),
                                  got.numpy())


def test_mlp_applies_silu_twice_to_the_gate(tiny):
    p = tiny["params"]["layers"][0]["band_net"]
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 5, 16))
                         .astype(np.float32))
    ref = jax_apollo._roformer_mlp(_to_j(tiny["params_np"]["layers"][0]["band_net"]),
                                   jnp.asarray(x.numpy()), HI)
    np.testing.assert_allclose(apollo._roformer_mlp(p, x).numpy(), np.asarray(ref), atol=2e-5)


def test_apollo_bf16_is_finite_and_close(tiny):
    """bf16 through the plain K6 and K7: finite, and within 25 dB of f32."""
    x = torch.from_numpy(tiny["x"])
    with torch.inference_mode():
        f32 = apollo.apply(tiny["params"], tiny["config"], x)
        bf = apollo.apply(tiny["params"], tiny["config"], x, compute_dtype=torch.bfloat16)
        prepared = apollo.prepare(tiny["params"], tiny["config"], torch.bfloat16)
        again = apollo.apply(prepared, tiny["config"], x, compute_dtype=torch.bfloat16)
    assert bf.dtype == torch.float32 and bool(torch.isfinite(bf).all())
    snr = 10 * np.log10(float(f32.pow(2).sum()) / float((bf - f32).pow(2).sum()))
    assert snr >= 25.0, snr
    np.testing.assert_array_equal(again.numpy(), bf.numpy())  # prepared once or per call


def test_convert_torch_round_trip_and_unconsumed_keys(tiny):
    sd = export_state_dict(tiny["params_np"], TINY)
    back = convert_checkpoint("apollo", sd, tiny["config"])
    leaves = lambda t: jax.tree.leaves(jax.tree.map(np.asarray, t))  # noqa: E731
    for a, b in zip(leaves(back), leaves(tiny["params_np"])):
        np.testing.assert_array_equal(a, b)
    ref = jax_apollo.convert_torch({k: v.numpy() for k, v in sd.items()}, tiny["jcfg"])
    assert jax.tree.structure(jax.tree.map(np.asarray, back)) == jax.tree.structure(
        jax.tree.map(np.asarray, ref))
    sd["net.0.band_net.cos_freq"] = torch.zeros(3)  # a registered buffer: consumed
    convert_checkpoint("apollo", sd, tiny["config"])
    sd["net.0.extra.weight"] = torch.zeros(3)
    with pytest.raises(ValueError, match="unconsumed"):
        convert_checkpoint("apollo", sd, tiny["config"])


def test_cli_restores_a_song_with_apollo(tiny, tmp_path):
    """cli.main --model_type apollo on the CPU from a checkpoint file: one
    'restored' stem, equal to the session's own separation, 0 rescues."""
    (tmp_path / "in").mkdir()
    song = (0.1 * np.random.default_rng(8).standard_normal((2, 20000))).astype(np.float32)
    write_audio(str(tmp_path / "in" / "song.wav"), song, 16000)
    cfg = {"audio": {"chunk_size": 8000, "num_channels": 2, "sample_rate": 16000},
           "model": TINY, "inference": {"num_overlap": 2, "batch_size": 2}}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    ckpt = str(tmp_path / "apollo.ckpt")
    torch.save(export_state_dict(tiny["params_np"], TINY), ckpt)
    sessions = []
    rc = cli.main(["--model_type", "apollo", "--config_path", str(tmp_path / "config.json"),
                   "--start_check_point", ckpt, "--input_folder", str(tmp_path / "in"),
                   "--store_dir", str(tmp_path / "out"), "--compute_dtype", "f32",
                   "--force_cpu"], session_out=sessions)
    assert rc == 0 and sessions[0].rescues == 0 and sessions[0].instruments == ["restored"]
    got, sr = read_audio(str(tmp_path / "out" / "song_restored.wav"))
    assert sr == 16000 and got.shape == song.shape and np.isfinite(got).all()
    want = sessions[0].separate(song)["restored"]
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_session_prepares_the_weights_once(tiny):
    s = InferenceSession("apollo", tiny["config"], tiny["params"],
                         InferenceSession.create("apollo", {"model": TINY}, device="cpu",
                                                 chunk_size=4000).spec,
                         torch.device("cpu"), compute_dtype=torch.bfloat16)
    mix = (0.1 * np.random.default_rng(9).standard_normal((2, 9000))).astype(np.float32)
    s.separate(mix)
    first = s._prepared[torch.bfloat16]
    s.separate(mix)
    assert s._prepared[torch.bfloat16] is first and s.rescues == 0
    assert first["layers"][0]["band_net"]["qkv_w_cm"].dtype == torch.bfloat16


@pytest.mark.parametrize("tokens,d", [(320 * 1901, 256), (3 * 62, 128), (1, 64), (1001, 512)])
def test_k6_gemm_grids_cover_every_tile_once(tokens, d):
    """K6's up (tokens, 4d) and down (tokens, d) products on the persistent
    GEMM: each grid is a multiple of the column blocks, one block per SM at
    most, and hands every 128 x 128 output tile to exactly one block, which
    keeps one column block of the weights."""
    hidden = 4 * d
    for sms in (132, 7):
        grids = k6_gemm_grids(tokens, d, hidden, sms)
        for cols, grid in zip((hidden, d), grids):
            n_tiles = -(-cols // 128)
            tiles = ff_gemm_schedule(tokens, cols, sms)[0]
            assert tiles == -(-tokens // 128) * n_tiles
            assert grid % n_tiles == 0 and 1 <= grid <= min(tiles, max(sms, n_tiles))
            seen = np.zeros(tiles, np.int64)
            for block in range(grid):
                mine = np.arange(block, tiles, grid)
                assert len(set(mine % n_tiles)) <= 1
                seen[mine] += 1
            assert (seen == 1).all()


# --------------------------------------------------------------------------
# K7's plan and the index arithmetic of csrc/rope_attention.cu, replayed
# --------------------------------------------------------------------------

SMEM_BLOCK_MAX = 232_448  # dynamic shared memory one block may use on the H100
# (b, n, heads, dim_head, rotary width): Apollo's shape, one token, a group
# left partial, several boxes along n, and every dim_head the kernel takes
K7_PLAN_CASES = [(7604, 80, 8, 32, 32), (13, 1, 3, 32, 32), (13, 12, 3, 16, 0),
                 (13, 80, 8, 48, 48), (13, 257, 3, 64, 64), (5, 530, 2, 32, 32),
                 (13, 80, 8, 96, 96), (13, 80, 3, 96, 32), (13, 80, 4, 80, 80),
                 (13, 80, 8, 112, 112), (13, 50, 2, 128, 128)]


def _k7_swz(row, col, rows):
    """rope_attention.cu ra_swz: the byte offset in a slab of the 16-byte chunk
    holding (row, col), col a multiple of 8."""
    return ((col >> 6) * rows + row) * 128 + ((((col >> 3) ^ row) & 7) << 4)


def _tma_swizzled(row, col, rows):
    """Where TMA's 128-byte swizzle puts element (row, col) of a slab whose
    64-column boxes of ``rows`` rows lie one after another from a 1024-byte
    boundary: bits 4-6 of the byte offset XOR bits 7-9."""
    off = ((col >> 6) * rows + row) * 128 + (col & 63) * 2
    return off ^ (((off >> 7) & 7) << 4)


@pytest.mark.parametrize("b,n,heads,dh,rot", K7_PLAN_CASES)
def test_k7_plan_visits_every_item_and_task_once(b, n, heads, dh, rot):
    """The persistent grid hands every (sequence, head group) item to one
    block (i, i + grid, ...), and the attention warps' rotation, carried from
    item to item, hands every (head, 16-query tile) task of the item to one
    warp: each (sequence, head, query tile) once."""
    plan = k7_plan(b, n, heads, dh, rot, 132)
    group, groups, nc = plan["group"], plan["groups"], plan["attn_warps"]
    assert plan["items"] == b * groups and plan["grid"] == min(plan["items"], 132)
    assert groups == -(-heads // group)
    assert plan["threads"] == 32 * (1 + plan["rope_warps"] + nc) <= 1024
    qtiles = -(-n // 16)
    seen = np.zeros((b, heads, qtiles), np.int64)
    for block in range(min(plan["grid"], 3) if b > 100 else plan["grid"]):
        rot_ = 0
        for item in range(block, plan["items"], plan["grid"]):
            seq, grp = divmod(item, groups)
            tasks = min(group, heads - grp * group) * qtiles
            for cw in range(nc):
                for task in range((cw - rot_ + nc) % nc, tasks, nc):
                    seen[seq, grp * group + task // qtiles, task % qtiles] += 1
            rot_ = (rot_ + tasks) % nc
    if b > 100:  # the first three blocks' items
        mine = np.concatenate([np.arange(k, plan["items"], plan["grid"]) for k in range(3)])
        covered = np.zeros((b, groups), bool)
        covered[mine // groups, mine % groups] = True
        heads_of = np.repeat(covered, group, axis=1)[:, :heads]
        assert (seen[heads_of] == 1).all() and (seen[~heads_of] == 0).all()
    else:
        assert (seen == 1).all()


@pytest.mark.parametrize("b,n,heads,dh,rot", K7_PLAN_CASES)
def test_k7_plan_boxes_cover_each_head(b, n, heads, dh, rot):
    """An item's boxes (64 columns of q, k and v each from the group's first
    column, less those wholly past the last head; nbox boxes of box_rows
    along n) hold every column of its heads' q, k and v and every row of the
    sequence; its stores write exactly the group's output columns (those
    past h·dh are clipped) and rows (past n clipped)."""
    plan = k7_plan(b, n, heads, dh, rot, 132)
    group, boxes, hd, width = plan["group"], plan["boxes"], heads * dh, plan["group"] * dh
    assert width == 64 * boxes
    n16, box_rows, nbox = -(-n // 16) * 16, plan["box_rows"], plan["nbox"]
    assert box_rows % 8 == 0 and box_rows <= 256 and plan["rows"] == nbox * box_rows
    assert (nbox - 1) * box_rows < n16 <= plan["rows"]
    for grp in range(plan["groups"]):
        nb = min(boxes, -(-(hd - grp * width) // 64))
        for c in range(3):
            loaded = {c * hd + grp * width + bx * 64 + j for bx in range(nb) for j in range(64)}
            for h in range(grp * group, min(heads, (grp + 1) * group)):
                assert set(range(c * hd + h * dh, c * hd + (h + 1) * dh)) <= loaded
        stored = {grp * width + bx * 64 + j for bx in range(nb) for j in range(64)}
        assert {col for col in stored if col < hd} == set(range(grp * width,
                                                                min(hd, (grp + 1) * width)))


@pytest.mark.parametrize("dh,heads,n", [(32, 8, 80), (48, 8, 80), (96, 3, 80), (128, 2, 50),
                                        (16, 3, 257), (80, 4, 33), (112, 8, 12)])
def test_k7_swizzled_addresses_are_a_bijection(dh, heads, n):
    """The kernel's addresses against TMA's 128-byte swizzle on one stage's
    slab: every q ldmatrix row address of a (head, 16-query tile) task is the
    chunk TMA wrote for that (row, column), the task's rows x head columns
    once each, each 8-lane phase in 8 distinct 16-byte bank groups; the key
    and value offsets fixed per lane hold for every 16-row step; and the
    output words the task writes over its q rows are a bijection onto the
    tile, each where the TMA store reads that (row, column)."""
    plan = k7_plan(7, n, heads, dh, dh, 132)
    rows, width = plan["rows"], plan["group"] * dh
    lanes = np.arange(32)
    a_row, a_col = (lanes & 7) + ((lanes >> 3) & 1) * 8, (lanes >> 4) * 8
    b_row, b_col = (lanes & 7) + (lanes >> 4) * 8, ((lanes >> 3) & 1) * 8
    g, t = lanes >> 2, lanes & 3
    for hc in range(0, width, dh):
        for q0 in range(0, -(-n // 16) * 16, 16):
            chunks = []
            for kk in range(dh // 16):
                addr = [_k7_swz(q0 + a_row[i], hc + kk * 16 + a_col[i], rows) for i in lanes]
                assert addr == [_tma_swizzled(q0 + a_row[i], hc + kk * 16 + a_col[i], rows)
                                for i in lanes]
                for ph in range(4):
                    assert len({a % 128 for a in addr[8 * ph:8 * ph + 8]}) == 8
                chunks += addr
            want = {_tma_swizzled(r, c, rows) for r in range(q0, q0 + 16)
                    for c in range(hc, hc + dh, 8)}
            assert len(chunks) == len(set(chunks)) and set(chunks) == want
            words = [_k7_swz(q0 + g[i] + 8 * r, hc + 8 * j, rows) + 4 * t[i]
                     for i in lanes for r in range(2) for j in range(dh // 8)]
            assert sorted(words) == sorted(_tma_swizzled(q0 + g[i] + 8 * r,
                                                         hc + 8 * j + 2 * t[i], rows)
                                           for i in lanes for r in range(2)
                                           for j in range(dh // 8))
            assert len(set(words)) == 16 * dh // 2
        for kr in range(0, rows - 15, 16):
            for kk in range(dh // 16):
                for i in lanes:
                    koff = _k7_swz(b_row[i], hc + kk * 16 + b_col[i], rows)
                    voff = _k7_swz(a_row[i], hc + kk * 16 + a_col[i], rows)
                    assert koff + kr * 128 == _k7_swz(kr + b_row[i], hc + kk * 16 + b_col[i], rows)
                    assert voff + kr * 128 == _k7_swz(kr + a_row[i], hc + kk * 16 + a_col[i], rows)


@pytest.mark.parametrize("n", [1, 12, 80, 257, 530])
def test_k7_plan_fits_shared_memory(n):
    """At every dim_head the kernel takes, 1, 3 and 8 heads, with and without
    rope: a plan exactly where one stage of the fewest heads that fill whole
    boxes fits; its shared memory the sum of its buffers and the C side's
    ra_smem_bytes, within a block's limit; the cos and sin tables staged
    (rows of an odd number of 16-byte chunks) wherever one stage fits beside
    them, else read from device memory; as many stages as fit, up to 4. Apollo's shape: 4 heads
    a group, three stages beside the tables."""
    for dh, heads, rot in itertools.product(range(16, 129, 16), (1, 3, 8), (0, 16)):
        plan = k7_plan(13, n, heads, dh, rot, 132)
        n16 = -(-n // 16) * 16
        nbox = -(-n16 // 256)  # boxes of at most 256 rows, a multiple of 8 each
        rows = nbox * -(-n16 // (8 * nbox)) * 8
        g0 = 64 // math.gcd(dh, 64)
        fewest = 3 * (g0 * dh // 64) * rows * 128 + 24 + 1024
        assert (plan is None) == (fewest > SMEM_BLOCK_MAX)
        if plan is None:
            continue
        staged = 2 * n * (-(-rot * 2 // 32) * 32 + 16) if rot else 0
        assert plan["rows"] == rows
        assert plan["table"] == (staged if fewest + staged <= SMEM_BLOCK_MAX else 0)
        assert plan["smem"] == sum(plan["buffers"].values()) <= SMEM_BLOCK_MAX
        assert plan["smem"] == plan["stages"] * (plan["stage_bytes"] + 24) + plan["table"] + 1024
        assert plan["stages"] == min(4, (SMEM_BLOCK_MAX - 1024 - plan["table"])
                                     // (plan["stage_bytes"] + 24))
    apollo_plan = k7_plan(7604, 80, 8, 32, 32, 132)
    assert {k: apollo_plan[k] for k in ("group", "boxes", "stages", "table", "items", "grid",
                                        "smem")} == \
        dict(group=4, boxes=2, stages=3, table=12_800, items=15208, grid=132, smem=198_216)


def test_k7_plan_refuses_exactly_what_the_kernel_cannot_take():
    """None for dim_head outside [1, 128], an odd rotary width or one wider
    than dim_head, and no sequences or tokens; a plan otherwise at Apollo's
    n, at the first packed width of ``k7_widths`` that fits (dim_head
    itself at multiples of 16 and of 8 up to 56, repacked otherwise) and
    the instance of the next multiple of 16.
    The plan's constants are the kernel's
    (csrc/rope_attention.cu): 64-column boxes, the rope and attention warps by
    dim_head, the shared-memory formula, the instantiated dim_heads."""
    for dh in range(1, 145):
        for rot in (0, 2, 7, 16, dh, dh + 2):
            ok = 1 <= dh <= 128 and rot % 2 == 0 and rot <= dh
            plan = k7_plan(3, 80, 2, dh, rot)
            assert (plan is not None) == ok, (dh, rot)
            if plan is not None:
                assert plan["width"] in attn_ops.k7_widths(dh)
                assert plan["repack"] == (plan["width"] != dh)
                assert plan["inst"] == -(-plan["width"] // 16) * 16
                if dh % 16 == 0 or dh % 8 == 0 and dh <= 56:  # whole boxes fit as they lie
                    assert plan["width"] == dh
    assert k7_plan(0, 80, 2, 32, 32) is None and k7_plan(3, 0, 2, 32, 32) is None
    src = open(os.path.join(os.path.dirname(apollo.__file__), "..", "csrc",
                            "rope_attention.cu")).read()
    assert "RA_BOX_COLS = 64;" in src and "RA_SMEM_MAX = 232448;" in src
    assert "ROPE = DH <= 32 ? 4 : DH <= 64 ? 3 : 2;" in src
    assert "ATTN = DH <= 32 ? 11 : DH <= 64 ? 8 : 5;" in src
    assert [attn_ops._k7_warps(dh) for dh in (16, 32, 48, 64, 80, 128)] == \
        [(4, 11), (4, 11), (3, 8), (3, 8), (2, 5), (2, 5)]
    assert "stages * (3LL * boxes * rows * 128 + 24) + table + 1024" in src
    assert "(((rot_w * 2 + 31) & ~31) + 16) / 2" in src
    assert "2LL * n * ra_table_pitch(rot_w) * 2" in src
    assert [int(v) for v in re.findall(r"case (\d+): launch = &launch_rope_attn<\1>", src)] == \
        list(range(8, 129, 8))
