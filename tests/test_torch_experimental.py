"""The experimental roformers of the port (value-residual learning,
hyper-connections) held against sesa_tpu's on the CPU: the hyper-connection
functions, the value-residual and hyper-connection transformer stacks, K1's
plain value-residual modes against the Pallas kernel in interpret mode, K3's
plain version, both experimental models whole, and the kernels' shape gates."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_collections import ConfigDict

from sesa_tpu.models import bs_roformer as jax_bs
from sesa_tpu.models import bs_roformer_experimental as jax_bs_exp
from sesa_tpu.models import hyper_connections as JHC
from sesa_tpu.models import mel_band_roformer_experimental as jax_mel_exp
from sesa_tpu.models import roformer_core as jax_core
from sesa_tpu.ops.attention import fused_attention_block as jax_fused_attention_block
from sesa_tpu.ops.attention import sdpa as jax_sdpa
from sesa_tpu.ops.rope import default_freqs as jax_default_freqs
from sesa_tpu.ops.rope import rope_tables as jax_rope_tables
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.convert.from_jax import params_from_jax
from sesa_tpu_torch.models import bs_roformer_experimental, get_model
from sesa_tpu_torch.models import hyper_connections as HC
from sesa_tpu_torch.models import roformer_core as core
from sesa_tpu_torch.ops.attention import (fused_attention_block, fused_attention_block_plain,
                                          sdpa, use_fused_attention, use_vmem_attention,
                                          vmem_attention, vmem_attention_plain)
from sesa_tpu_torch.ops.ff import use_fused_ff
from sesa_tpu_torch.tree import tree_map
from tests.test_roformer import bs_model_cfg, export_state_dict, mel_model_cfg


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch: with the tier-1 run's six workers on
    eight cores, torch's thread pools spin against each other (a session
    test of 0.5 s alone took 40 s beside five busy processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL_MODEL = 5e-4  # whole models, f32 on both sides


def _rand_tree(tree, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda v: jnp.asarray(rng.standard_normal(np.shape(v)).astype(np.float32) * scale), tree)


def _to_torch(tree):
    return tree_map(lambda v: torch.from_numpy(np.array(v, dtype=np.float32)),
                    jax.tree.map(np.asarray, tree))


# --------------------------------------------------------------------------
# hyper-connections (f32, atol 1e-5: the same few sums in another order)
# --------------------------------------------------------------------------

def test_expand_and_reduce_streams():
    x = np.random.default_rng(0).standard_normal((3, 5, 4)).astype(np.float32)
    for s in (1, 4):
        ref = np.asarray(JHC.expand_streams(jnp.asarray(x), s))
        got = HC.expand_streams(torch.from_numpy(x), s)
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_allclose(HC.reduce_streams(got, s).numpy(),
                                   np.asarray(JHC.reduce_streams(jnp.asarray(ref), s)), atol=1e-6)


def test_hc_init_matches_jax():
    for idx in (0, 5):
        ref, got = JHC.hc_init(None, 8, 4, idx), HC.hc_init(None, 8, 4, idx)
        assert sorted(ref) == sorted(got)
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_hc_width_depth_apply_match_jax():
    streams, d = 4, 16
    jp = _rand_tree(JHC.hc_init(None, d, streams, 1), 1)
    p = _to_torch(jp)
    x = np.random.default_rng(2).standard_normal((2 * streams, 7, d)).astype(np.float32)
    ref = JHC.hc_width(jp, jnp.asarray(x), streams, precision=jax.lax.Precision.HIGHEST)
    got = HC.hc_width(p, torch.from_numpy(x), streams)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5)
    out = np.random.default_rng(3).standard_normal((2, 7, d)).astype(np.float32)
    np.testing.assert_allclose(
        HC.hc_depth(torch.from_numpy(out), got[1], got[2]).numpy(),
        np.asarray(JHC.hc_depth(jnp.asarray(out), ref[1], ref[2])), atol=1e-5, rtol=1e-5)
    # the wrapper, with a branch that returns extras
    ref_x, ref_e = JHC.hc_apply(jp, jnp.asarray(x), streams, lambda b: (b * 2.0, b.sum()),
                                precision=jax.lax.Precision.HIGHEST)
    got_x, got_e = HC.hc_apply(p, torch.from_numpy(x), streams, lambda b: (b * 2.0, b.sum()))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_e.item(), float(ref_e), rtol=1e-5)


def test_hc_convert_reads_the_wrapper_keys():
    p = _to_torch(_rand_tree(JHC.hc_init(None, 8, 2, 0), 4))
    sd = {"w.norm.gamma": p["norm_gamma"],
          **{f"w.{k}": v for k, v in p.items() if k != "norm_gamma"}}
    back = HC.hc_convert(sd.__getitem__, "w")
    assert all(torch.equal(back[k], p[k]) for k in p)


# --------------------------------------------------------------------------
# transformer stacks (f32, atol 1e-4: a few layers of f32 products)
# --------------------------------------------------------------------------

def _stack(depth, dim, heads, dh, seed, **kw):
    jp = jax_core.transformer_init(jax.random.PRNGKey(seed), dim, depth, heads, dh, **kw)
    if kw.get("num_residual_streams", 1) > 1:
        for i, lay in enumerate(jp["layers"]):
            for j, mod in enumerate(("attn", "ff")):
                lay[mod]["hc"] = _rand_tree(lay[mod]["hc"], 10 * seed + 2 * i + j)
    return jp, _to_torch(jp)


def _rope(dh, n):
    rope = jax_rope_tables(jnp.asarray(jax_default_freqs(dh)), n)
    return rope, tuple(torch.from_numpy(np.array(r)) for r in rope)


@pytest.mark.parametrize("branch", ["first", "later", "later_without_mix"])
def test_transformer_apply_vr_matches_jax(branch):
    """The three branches of the CPU path: no value residual given (standard
    residual form), given with the learned mix, given without a mix."""
    heads, dh, n = 2, 8, 12
    jp, p = _stack(2, 16, heads, dh, 3, value_residual=branch == "later", norm_output=True)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, n, 16)).astype(np.float32)
    vres = None if branch == "first" else rng.standard_normal((3, heads, n, dh)).astype(np.float32)
    jrope, rope = _rope(dh, n)
    ref, ref_v = jax_core.transformer_apply_vr(
        jp, jnp.asarray(x), heads, rope=jrope,
        value_residual=None if vres is None else jnp.asarray(vres))
    got, got_v = core.transformer_apply_vr(
        p, torch.from_numpy(x), heads, rope=rope,
        value_residual=None if vres is None else torch.from_numpy(vres))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("with_values", [False, True])
def test_transformer_apply_hc_matches_jax(with_values):
    heads, dh, n, streams = 2, 8, 10, 2
    jp, p = _stack(2, 16, heads, dh, 5, value_residual=with_values, num_residual_streams=streams)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, streams, n, 16)).astype(np.float32)
    vres = rng.standard_normal((2, heads, n, dh)).astype(np.float32) if with_values else None
    jrope, rope = _rope(dh, n)
    ref, ref_v = jax_core.transformer_apply_vr(
        jp, jnp.asarray(x), heads, rope=jrope, streams=streams,
        value_residual=None if vres is None else jnp.asarray(vres))
    got, got_v = core.transformer_apply_vr(
        p, torch.from_numpy(x), heads, rope=rope, streams=streams,
        value_residual=None if vres is None else torch.from_numpy(vres))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), atol=1e-5, rtol=1e-4)


def test_a_mix_layer_without_values_raises():
    _, p = _stack(1, 16, 2, 8, 7, value_residual=True)
    with pytest.raises(ValueError, match="first layer"):
        core.attention_apply(p["layers"][0]["attn"], torch.zeros(1, 4, 16), 2)


# --------------------------------------------------------------------------
# K1's value-residual modes: the plain version against the Pallas kernel in
# interpret mode, set up as tests/test_fused_attention.py:104-147
# --------------------------------------------------------------------------

def _k1_case(dtype_np_seed=11, b=2, n=20, heads=2, dh=16):
    rng = np.random.default_rng(dtype_np_seed)
    d = heads * dh
    jp = jax_core.attention_init(jax.random.PRNGKey(4), d, heads, dh, value_residual=True)
    x = rng.standard_normal((b, n, d)).astype(np.float32) * 0.3
    names = ("norm_gamma", "qkv_w", "gates_w", "gates_b", "out_w", "vr_mix_w", "vr_mix_b")
    arrays = [x] + [np.asarray(jp[k]) for k in names]
    rope = tuple(np.asarray(r) for r in jax_rope_tables(jnp.asarray(jax_default_freqs(dh)), n))
    return arrays, rope, heads, dh


def _k1_both(dtype_t, dtype_j):
    arrays, rope, heads, dh = _k1_case()
    t = [torch.from_numpy(a).to(dtype_t) for a in arrays]
    j = [jnp.asarray(a, dtype_j) for a in arrays]
    trope = tuple(torch.from_numpy(r).to(dtype_t) for r in rope)
    jrope = tuple(jnp.asarray(r, dtype_j) for r in rope)
    scale = dh ** -0.5
    # mode 1: the first layer, with the residual, emits the pre-mix V
    got1 = fused_attention_block_plain(*t[:6], heads, scale, rope=trope,
                                       vr=(None, None, None), add_residual=True)
    ref1 = jax_fused_attention_block(*j[:6], heads, scale, rope=jrope, interpret=True,
                                     vr=(None, None, None), add_residual=True)
    # mode 2: a later layer lerps V toward the first layer's, no residual
    got2 = fused_attention_block_plain(*t[:6], heads, scale, rope=trope,
                                       vr=(t[6], t[7], got1[1]), add_residual=False)
    ref2 = jax_fused_attention_block(*j[:6], heads, scale, rope=jrope, interpret=True,
                                     vr=(j[6], j[7], ref1[1]), add_residual=False)
    f = lambda pair: [np.asarray(v.float() if isinstance(v, torch.Tensor) else v, np.float32)  # noqa: E731
                      for v in pair]
    return f(got1), f(ref1), f(got2), f(ref2)


def test_k1_plain_modes_match_pallas_f32():
    """The f32 tolerance tests/test_torch_attention.py holds mode 0 to."""
    got1, ref1, got2, ref2 = _k1_both(torch.float32, jnp.float32)
    for got, ref in ((got1, ref1), (got2, ref2)):
        np.testing.assert_allclose(got[0], ref[0], atol=3e-5, rtol=2e-5)
        np.testing.assert_allclose(got[1], ref[1], atol=3e-5, rtol=2e-5)
    assert np.abs(got2[0] - got1[0]).max() > 1e-3  # the lerp and the residual matter


def test_k1_plain_modes_match_pallas_bf16():
    """Both round to bf16 at the same points; the f32 sums differ in order,
    which can flip a rounded value by one bf16 ulp. Bound as for mode 0: max
    error <= 2% of the output's largest value, 99% within one output ulp."""
    got1, ref1, got2, ref2 = _k1_both(torch.bfloat16, jnp.bfloat16)
    for got, ref in ((got1[0], ref1[0]), (got1[1], ref1[1]), (got2[0], ref2[0]),
                     (got2[1], ref2[1])):
        assert np.abs(got - ref).max() <= 0.02 * np.abs(ref).max()
        ulp = np.maximum(np.abs(ref), 1e-3) * 2.0 ** -7
        assert np.mean(np.abs(got - ref) <= ulp) >= 0.99


def test_k1_wrapper_runs_plain_on_cpu_in_every_mode():
    arrays, rope, heads, dh = _k1_case()
    t = [torch.from_numpy(a) for a in arrays]
    trope = tuple(torch.from_numpy(r) for r in rope)
    before = fused_attention_block.launches
    out, v = fused_attention_block(*t[:6], heads, 0.25, rope=trope, vr=(None, None, None))
    ref, ref_v = fused_attention_block_plain(*t[:6], heads, 0.25, rope=trope,
                                             vr=(None, None, None))
    assert torch.equal(out, ref) and torch.equal(v, ref_v)
    out2, _ = fused_attention_block(*t[:6], heads, 0.25, rope=trope, vr=(t[6], t[7], v),
                                    add_residual=False)
    assert out2.shape == out.shape and not torch.equal(out2, out)
    assert fused_attention_block.launches == before


# --------------------------------------------------------------------------
# K3's plain version (the Pallas kernel has no interpret mode, so the JAX
# reference is the einsum branch of sdpa)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [256, 690, 2048])
def test_vmem_attention_plain_matches_jax_sdpa_f32(seq):
    rng = np.random.default_rng(seq)
    q, k, v = (rng.standard_normal((1, 2, seq, 32)).astype(np.float32) for _ in range(3))
    got = vmem_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), 32 ** -0.5)
    ref = jax_sdpa(*(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def test_vmem_attention_plain_bf16_against_jax_sdpa():
    """In bf16 the JAX einsum branch rounds the scores to bf16 before the
    softmax and the kernel's arithmetic does not (the TPU kernel keeps them
    f32), so the two differ by more than an output ulp: with |score| up to
    about 4 a bf16 score is off by up to 2**-7 relative, some 3% in a
    probability. Bound: 5% of the output's largest value; and the plain
    version is the closer of the two to the f32 result."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 2, 300, 64)).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = vmem_attention_plain(tq, tk, tv, 0.125).float().numpy()
    ref = np.asarray(jax_sdpa(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))), np.float32)
    exact = vmem_attention_plain(tq.float(), tk.float(), tv.float(), 0.125).numpy()
    assert np.abs(got - ref).max() <= 0.05 * np.abs(exact).max()
    assert np.abs(got - exact).mean() <= np.abs(ref - exact).mean()


def test_sdpa_and_vmem_attention_on_cpu():
    q, k, v = (torch.randn(2, 2, 300, 32, generator=torch.Generator().manual_seed(i))
               for i in range(3))
    assert not use_vmem_attention(q, k, v)  # the CPU takes the einsum pair
    before = vmem_attention.launches
    assert torch.equal(vmem_attention(q, k, v, 0.2), vmem_attention_plain(q, k, v, 0.2))
    np.testing.assert_allclose(sdpa(q, k, v, 0.2).numpy(),
                               vmem_attention_plain(q, k, v, 0.2).numpy(), atol=2e-6)
    assert vmem_attention.launches == before


# --------------------------------------------------------------------------
# the gates: device, dtype and shape only
# --------------------------------------------------------------------------

class _Fake:
    """A tensor's device, dtype and shape, with no storage."""

    def __init__(self, shape, dtype=torch.bfloat16, device="cuda"):
        self.shape, self.dtype, self.device = torch.Size(shape), dtype, torch.device(device)
        self.ndim = len(shape)

    def numel(self):
        return int(np.prod(self.shape))


@pytest.mark.parametrize("shape,heads,dh,dtype,device,takes", [
    ((372, 690, 512), 8, 64, torch.bfloat16, "cuda", True),    # flagship time leg
    ((6, 690, 62, 512), 8, 64, torch.bfloat16, "cuda", True),  # freq leg, leading dims
    ((4, 100, 128), 4, 32, torch.bfloat16, "cuda", True),
    ((4, 100, 128), 1, 128, torch.bfloat16, "cuda", True),     # dim_head 128
    ((4, 100, 96), 3, 32, torch.bfloat16, "cuda", False),      # dim 96
    ((4, 100, 128), 3, 32, torch.bfloat16, "cuda", True),      # 3 heads padded to 64
    ((4, 100, 384), 8, 48, torch.bfloat16, "cuda", True),      # padded to 64
    ((4, 100, 128), 2, 136, torch.bfloat16, "cuda", False),    # dim_head above 128
    ((70000, 8, 128), 4, 32, torch.bfloat16, "cuda", False),   # more sequences than a launch
    ((4, 100, 128), 4, 32, torch.float32, "cuda", False),
    ((4, 100, 128), 4, 32, torch.bfloat16, "cpu", False),
])
def test_k1_gate(shape, heads, dh, dtype, device, takes):
    assert use_fused_attention(_Fake(shape, dtype, device), heads, dh) is takes


def test_k2_and_k3_gates():
    w1 = _Fake((256, 64))
    assert use_fused_ff(_Fake((10, 20, 64)), w1)
    assert not use_fused_ff(_Fake((10, 20, 96)), _Fake((384, 96)))
    assert not use_fused_ff(_Fake((10, 20, 64), torch.float32), w1)
    assert not use_fused_ff(_Fake((10, 20, 64), device="cpu"), w1)
    for shape, takes in (((2976, 690, 64), True), ((6, 8, 256, 32), True),
                         ((6, 8, 2048, 128), True), ((6, 8, 255, 64), False),
                         ((6, 8, 2049, 64), False), ((6, 8, 690, 48), True),
                         ((6, 8, 690, 20), True), ((6, 8, 690, 129), False),
                         ((690, 64), False)):
        t = _Fake(shape)
        assert use_vmem_attention(t, t, t) is takes, shape
    q = _Fake((6, 8, 690, 64))
    assert not use_vmem_attention(q, _Fake((6, 8, 700, 64)), _Fake((6, 8, 700, 64)))
    assert not use_vmem_attention(_Fake((6, 8, 690, 64), torch.float32), q, q)


def test_roformer_falls_back_to_the_unfused_chain_at_other_shapes():
    """The attention block at a shape K1 does not take (dim_head 128, dim 96)
    is attention_apply(x) + x and raises nothing."""
    gen = torch.Generator().manual_seed(0)
    p = core.attention_init(gen, 96, 2, 128)
    x = torch.randn(3, 10, 96, generator=gen)
    assert not use_fused_attention(_Fake(x.shape), 2, 128)
    got = core.attention_apply_residual(p, x, 2)
    assert torch.equal(got, core.attention_apply(p, x, 2) + x)


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------

def _randomize_hc(params, seed):
    rng = np.random.default_rng(seed)
    for layer in params["layers"]:
        for t in ("time", "freq"):
            for lay in layer[t]["layers"]:
                for mod in ("attn", "ff"):
                    if "hc" in lay[mod]:
                        lay[mod]["hc"] = {
                            k: jnp.asarray(rng.standard_normal(np.shape(v)).astype(np.float32) * 0.3)
                            for k, v in lay[mod]["hc"].items()}
    return params


@pytest.mark.parametrize("variant,over", [
    ("bs", dict(depth=3, use_value_residual_learning=True)),
    ("bs", dict(depth=2, use_value_residual_learning=True, num_residual_streams=4)),
    ("bs", dict(depth=2)),  # experimental_forward alone
    ("mel", dict(depth=3, use_value_residual_learning=True)),
    ("mel", dict(depth=2, use_value_residual_learning=True, num_residual_streams=4)),
    ("mel", dict(depth=2)),
])
def test_experimental_models_match_jax(variant, over):
    """One torch state dict through both packages' convert_torch, and the JAX
    tree through params_from_jax: the same output, f32."""
    if variant == "bs":
        mcfg, jmod, name = bs_model_cfg(**over), jax_bs_exp, "bs_roformer_experimental"
        norm_out, final = False, True
    else:
        mcfg, jmod, name = mel_model_cfg(**over), jax_mel_exp, "mel_band_roformer_experimental"
        norm_out, final = True, False
    jcfg, cfg = ConfigDict({"model": mcfg}), AttrDict({"model": mcfg})
    jparams = _randomize_hc(jmod.init(jax.random.PRNGKey(5), jcfg), 11)
    sd = export_state_dict(jparams, jmod._spec(jcfg), transformer_norm_output=norm_out,
                           final_norm=final)
    x = np.random.default_rng(7).standard_normal((2, 2, 1280)).astype(np.float32) * 0.1
    ref = np.asarray(jmod.apply(jparams, jcfg, jnp.asarray(x)))

    model = get_model(name)
    params = model.convert_torch(sd, cfg)
    got = model.apply(params, cfg, torch.from_numpy(x))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_MODEL, rtol=1e-3)

    copied = params_from_jax(jax.tree.map(np.asarray, jparams), name, cfg)
    again = model.apply(copied, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(again.numpy(), got.numpy(), atol=1e-6)


def test_experimental_forward_differs_from_the_base_forward():
    from sesa_tpu_torch.models import bs_roformer

    cfg = AttrDict({"model": bs_model_cfg(depth=2)})
    params = bs_roformer_experimental.init(torch.Generator().manual_seed(1), cfg)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((1, 2, 1280))
                         .astype(np.float32) * 0.1)
    exp = bs_roformer_experimental.apply(params, cfg, x)
    base = bs_roformer.apply(params, cfg, x)
    assert (exp - base).abs().max() > 1e-5


def test_init_has_the_mix_only_after_the_first_depth_layer():
    cfg = AttrDict({"model": bs_model_cfg(depth=3, use_value_residual_learning=True,
                                          num_residual_streams=2)})
    params = bs_roformer_experimental.init(torch.Generator().manual_seed(0), cfg)
    first = params["layers"][0]["time"]["layers"][0]["attn"]
    later = params["layers"][1]["freq"]["layers"][0]["attn"]
    assert "hc" in first and "vr_mix_w" not in first["branch"]
    assert "vr_mix_w" in later["branch"] and later["branch"]["vr_mix_w"].shape == (4, 32)
