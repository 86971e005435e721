"""The port's Demucs family (``htdemucs`` with its ``hdemucs`` and legacy
``demucs`` variants), ``ops/wiener.py``, demix's demucs mode and the
session's htdemucs chunking, held against sesa_tpu on the CPU on the same
numpy inputs and weights (``params_from_jax``, or one converted state dict
of the torch oracles in ``tests/oracles``).

Every whole-model JAX reference is built once, under ``jax.jit``, by a
module-scoped fixture, at the tiny configs of ``tests/test_htdemucs.py``,
``tests/test_hdemucs.py`` and ``tests/test_demucs_legacy.py``.

The bf16 forwards run with oneDNN off: with torch 2.13+cpu on some x86 CPUs
oneDNN's bf16 convolution returns wrong values for some shapes (htdemucs's
(16, 8, 8) time-branch kernel came out 100% off), a library fault that
cuDNN on the card does not share; PyTorch's own CPU convolution is right
there."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sesa_tpu.models import demucs_legacy as jax_legacy
from sesa_tpu.models import htdemucs as jax_ht
from sesa_tpu.ops.wiener import wiener_ri as jax_wiener
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.convert import convert_checkpoint
from sesa_tpu_torch.convert.from_jax import params_from_jax
from sesa_tpu_torch.models import demucs_legacy, get_model, htdemucs
from sesa_tpu_torch.ops.wiener import wiener_ri
from sesa_tpu_torch.runtime.demix import DemixSpec, demix
from tests.test_demucs_legacy import tiny_config as legacy_config
from tests.test_demucs_legacy import torch_model as legacy_oracle
from tests.test_hdemucs import hd_config
from tests.test_hdemucs import torch_model as hdemucs_oracle
from tests.test_htdemucs import tiny_config as ht_config

# ROADMAP's end-to-end tolerance of the port against the JAX package (f32)
ATOL = 5e-4
# bf16 against the JAX package's bf16, relative to max |JAX bf16|
# (tests/test_compute_dtype.py:48-62)
BF16_REL = 0.08
WIENER_ATOL = 1e-5
DEMIX_ATOL = 1e-5
# the JAX package's resampling tolerance (tests/test_demucs_legacy.py:96-104)
RESAMPLE_ATOL = 1e-5
HT_SAMPLES, HD_SAMPLES, LEGACY_SAMPLES = 8192, 8192, 30000


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch: these models run as many small ops
    (LSTM steps, narrow convolutions), and with the tier-1 run's six workers
    on eight cores torch's thread pools spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ht(**over):
    cfg = ht_config()
    cfg.htdemucs.update(over)
    return cfg


# name -> (JAX config, seed of the JAX init, samples)
HT_VARIANTS = {
    "cac": (lambda: _ht(), 0, HT_SAMPLES),
    "wiener": (lambda: _ht(cac=False, wiener_iters=1, wiener_residual=True), 1, HT_SAMPLES),
    "softmask": (lambda: _ht(cac=False, wiener_iters=-1), 2, HT_SAMPLES),
    "subbands_bottom": (lambda: _ht(num_subbands=2, bottom_channels=16), 3, HT_SAMPLES),
    "multi_freqs": (lambda: _ht(multi_freqs=[0.25, 0.5], multi_freqs_depth=2), 4, HT_SAMPLES),
}


def _input(samples, seed=0, scale=0.1):
    return (np.random.default_rng(seed).standard_normal((1, 2, samples)) * scale).astype(np.float32)


def _tcfg(cfg):
    return AttrDict(cfg.to_dict())


_REFS = {}


@pytest.fixture(scope="module")
def jax_ref():
    """(key, bf16) -> (JAX config, JAX params as numpy, input, JAX output),
    built once per key under jax.jit. Keys: the htdemucs variants above,
    ``hdemucs`` and ``legacy<lstm_layers>_<resample>``, whose weights are
    the torch oracles' state dicts through the JAX converter."""
    def get(key, bf16=False):
        if (key, bf16) not in _REFS:
            if key in HT_VARIANTS:
                make, seed, samples = HT_VARIANTS[key]
                cfg = make()
                params = jax_ht.init(jax.random.PRNGKey(seed), cfg)
                x = _input(samples, seed)
            elif key == "hdemucs":
                cfg = hd_config()
                params = jax_ht.convert_torch(hdemucs_oracle(cfg).state_dict(), cfg)
                x = _input(HD_SAMPLES, 5, 0.2)
            else:
                lstm_layers, resample = key[len("legacy"):].split("_")
                cfg = legacy_config(lstm_layers=int(lstm_layers), resample=resample == "True")
                params = jax_ht.convert_torch(legacy_oracle(cfg).state_dict(), cfg)
                x = _input(LEGACY_SAMPLES, 6, 0.2)
            params = jax.tree.map(np.asarray, params)
            kw = {"compute_dtype": jnp.bfloat16} if bf16 else {}
            out = jax.jit(lambda p, a: jax_ht.apply(p, cfg, a, **kw))(params, jnp.asarray(x))
            _REFS[(key, bf16)] = (cfg, params, x, np.asarray(out))
        return _REFS[(key, bf16)]
    return get


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(HT_VARIANTS))
def test_htdemucs_matches_jax_f32(jax_ref, variant):
    cfg, jparams, x, ref = jax_ref(variant)
    tcfg = _tcfg(cfg)
    got = htdemucs.apply(params_from_jax(jparams, "htdemucs", tcfg), tcfg, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == ref.shape == (1, 4, 2, x.shape[-1])
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("key", ["legacy0_True", "legacy2_False", "hdemucs"])
def test_oracle_weights_match_jax_f32(jax_ref, key):
    """hdemucs (its DConv BLSTM and LocalState at layers >= 4) and legacy
    demucs with and without the bottleneck BLSTM and the x2 resampling, on
    the torch oracle's state dict through the port's converter."""
    cfg, _, x, ref = jax_ref(key)
    oracle = hdemucs_oracle(cfg) if key == "hdemucs" else legacy_oracle(cfg)
    tcfg = _tcfg(cfg)
    params = convert_checkpoint("htdemucs", {"state": oracle.state_dict()}, tcfg)
    got = get_model("htdemucs").apply(params, tcfg, torch.from_numpy(x))
    assert got.shape == ref.shape == (1, 4, 2, x.shape[-1])
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("key", ["cac", "hdemucs", "legacy2_False"])
def test_bf16_tracks_jax_bf16(jax_ref, key):
    """The port in bf16 (weights cast once by ``prepare``) against the JAX
    package in bf16. (Legacy demucs with resampling raises in the JAX
    package's bf16: its sinc bank stays f32; see the next test.)"""
    cfg, jparams, x, ref = jax_ref(key, bf16=True)
    tcfg = _tcfg(cfg)
    params = htdemucs.prepare(params_from_jax(jparams, "htdemucs", tcfg), tcfg, torch.bfloat16)
    with torch.backends.mkldnn.flags(enabled=False):
        got = htdemucs.apply(params, tcfg, torch.from_numpy(x), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    err, scale = np.abs(got.numpy() - ref).max(), np.abs(ref).max()
    assert err < BF16_REL * scale, (err, scale)


def test_legacy_bf16_with_resampling_tracks_f32(jax_ref):
    """Legacy demucs at its default ``resample: true`` in bf16: the port
    resamples in f32 around the bf16 net, and stays within the bf16 bound
    of the JAX f32 output (the JAX package's bf16 raises here)."""
    cfg, jparams, x, ref = jax_ref("legacy0_True")
    with pytest.raises(TypeError, match="same dtypes"):  # the resampling of a bf16 net
        jax_legacy._resample(jnp.zeros((1, 1, 64), jnp.bfloat16), 2, 1)
    tcfg = _tcfg(cfg)
    params = htdemucs.prepare(params_from_jax(jparams, "htdemucs", tcfg), tcfg, torch.bfloat16)
    with torch.backends.mkldnn.flags(enabled=False):
        got = htdemucs.apply(params, tcfg, torch.from_numpy(x), compute_dtype=torch.bfloat16)
    err, scale = np.abs(got.numpy() - ref).max(), np.abs(ref).max()
    assert err < BF16_REL * scale, (err, scale)


def _export_htdemucs(params):
    """The reference state dict of a JAX htdemucs tree (the inverse of the
    JAX converter)."""
    sd = {}

    def put(prefix, p):
        for k, v in p.items():
            sd[f"{prefix}.{k}"] = torch.from_numpy(np.array(v))

    def dconv(prefix, blocks):
        for d, blk in enumerate(blocks):
            p = f"{prefix}.layers.{d}"
            put(f"{p}.0", blk["conv1"])
            put(f"{p}.1", blk["norm1"])
            put(f"{p}.3", blk["conv2"])
            put(f"{p}.4", blk["norm2"])
            sd[f"{p}.6.scale"] = torch.from_numpy(np.array(blk["scale"]))

    def layer(prefix, p):
        for key in ("conv", "conv_tr", "rewrite", "norm1", "norm2"):
            if key in p:
                put(f"{prefix}.{key}", p[key])
        if "dconv" in p:
            dconv(f"{prefix}.dconv", p["dconv"])

    for name in ("encoder", "tencoder", "decoder", "tdecoder"):
        for i, p in enumerate(params[name]):
            if "layers" in p:
                for k, sub in enumerate(p["layers"]):
                    layer(f"{name}.{i}.layers.{k}", sub)
            else:
                layer(f"{name}.{i}", p)
    sd["freq_emb.embedding.weight"] = torch.from_numpy(np.array(params["freq_emb"]))
    ct = params["crosstransformer"]
    put("crosstransformer.norm_in", ct["norm_in"])
    put("crosstransformer.norm_in_t", ct["norm_in_t"])
    for branch in ("layers", "layers_t"):
        for i, lp in enumerate(ct[branch]):
            pfx = f"crosstransformer.{branch}.{i}"
            attn = f"{pfx}.{'cross_attn' if 'norm3' in lp else 'self_attn'}"
            put(attn, {k: lp["attn"][k] for k in ("in_proj_weight", "in_proj_bias")})
            put(f"{attn}.out_proj", lp["attn"]["out_proj"])
            for key in ("linear1", "linear2", "norm1", "norm2", "norm3", "norm_out"):
                if key in lp:
                    put(f"{pfx}.{key}", lp[key])
            for key in ("gamma_1", "gamma_2"):
                sd[f"{pfx}.{key}.scale"] = torch.from_numpy(np.array(lp[key]))
    for name in ("channel_upsampler", "channel_downsampler", "channel_upsampler_t",
                 "channel_downsampler_t"):
        if name in params:
            put(name, params[name])
    return sd


@pytest.mark.parametrize("variant", ["subbands_bottom", "multi_freqs"])
def test_htdemucs_converter_matches_jax(jax_ref, variant):
    """One state dict in the reference layout through both converters; a
    stray key raises."""
    cfg, jparams, _, _ = jax_ref(variant)
    sd = _export_htdemucs(jparams)
    back = jax.tree.map(np.asarray, jax_ht.convert_torch(sd, cfg))
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    tcfg = _tcfg(cfg)
    got = htdemucs.convert_torch(sd, tcfg)
    want = params_from_jax(back, "htdemucs", tcfg)
    got_leaves, want_leaves = jax.tree.leaves_with_path(got), jax.tree.leaves_with_path(want)
    assert [k for k, _ in got_leaves] == [k for k, _ in want_leaves]
    for (_, a), (_, b) in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="unconsumed"):
        htdemucs.convert_torch(dict(sd, **{"encoder.0.stray": torch.zeros(1)}), tcfg)


@pytest.mark.parametrize("model", ["htdemucs", "hdemucs", "demucs"])
def test_init_tree_matches_jax(model):
    cfg = {"htdemucs": ht_config(), "hdemucs": hd_config(),
           "demucs": legacy_config(lstm_layers=2)}[model]
    tree = get_model("htdemucs").init(torch.Generator().manual_seed(0), _tcfg(cfg))
    jtree = jax_ht.init(jax.random.PRNGKey(0), cfg)
    got = [(k, tuple(v.shape)) for k, v in jax.tree.leaves_with_path(tree)]
    want = [(k, tuple(np.shape(v))) for k, v in jax.tree.leaves_with_path(jtree)]
    assert got == want


def test_unknown_variant_is_typed():
    cfg = ht_config()
    cfg.model = "tasnet"
    with pytest.raises(NotImplementedError, match="tasnet"):
        htdemucs._kwargs(_tcfg(cfg))


# --------------------------------------------------------------------------
# parts
# --------------------------------------------------------------------------

def _ct_params():
    jparams = jax.tree.map(np.asarray, jax_ht.init(jax.random.PRNGKey(0), ht_config()))
    tree = params_from_jax(jparams, "htdemucs", _tcfg(ht_config()))
    return jparams["crosstransformer"], tree["crosstransformer"]


@pytest.mark.parametrize("part", ["mha", "self", "cross"])
def test_transformer_parts_match_jax(part):
    jct, ct = _ct_params()
    rng = np.random.default_rng(1)
    q = (rng.standard_normal((2, 10, 64)) * 0.3).astype(np.float32)
    kv = (rng.standard_normal((2, 14, 64)) * 0.3).astype(np.float32)
    tq, tkv, jq, jkv = torch.from_numpy(q), torch.from_numpy(kv), jnp.asarray(q), jnp.asarray(kv)
    if part == "mha":
        got = htdemucs._mha(ct["layers"][0]["attn"], tq, tkv, tkv, 4)
        ref = jax_ht._mha(jct["layers"][0]["attn"], jq, jkv, jkv, 4, None)
    elif part == "self":
        got = htdemucs._t_self_layer(ct["layers"][0], tq, 4)
        ref = jax_ht._t_self_layer(jct["layers"][0], jq, 4, None)
    else:  # odd layers are cross layers (t_cross_first False)
        got = htdemucs._t_cross_layer(ct["layers"][1], tq, tkv, 4)
        ref = jax_ht._t_cross_layer(jct["layers"][1], jq, jkv, 4, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_framed_blstm_and_local_state_match_jax():
    """The skip-BLSTM framed at 200 steps (517 steps: not a multiple of the
    stride) and LocalState, on the hdemucs oracle's deep-layer weights."""
    cfg = hd_config()
    jparams = jax.tree.map(np.asarray,
                           jax_ht.convert_torch(hdemucs_oracle(cfg).state_dict(), cfg))
    tree = params_from_jax(jparams, "htdemucs", _tcfg(cfg))
    jblk, blk = jparams["encoder"][4]["dconv"][0], tree["encoder"][4]["dconv"][0]
    c = blk["lstm"]["linear"]["weight"].shape[0]
    x = np.random.default_rng(2).standard_normal((2, c, 517)).astype(np.float32)
    got = demucs_legacy._blstm(blk["lstm"], torch.from_numpy(x), max_steps=200, skip=True)
    ref = jax_legacy._blstm(jblk["lstm"], jnp.asarray(x), max_steps=200, skip=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    x = x[..., :90]
    got = demucs_legacy._local_state(blk["attn"], torch.from_numpy(x))
    ref = jax_legacy._local_state(jblk["attn"], jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_resample_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 3, 1000)).astype(np.float32)
    up = demucs_legacy._resample(torch.from_numpy(x), 1, 2)
    np.testing.assert_allclose(up.numpy(), np.asarray(jax_legacy._resample(jnp.asarray(x), 1, 2)),
                               atol=RESAMPLE_ATOL)
    down = demucs_legacy._resample(up, 2, 1)
    np.testing.assert_allclose(down.numpy(),
                               np.asarray(jax_legacy._resample(jnp.asarray(up.numpy()), 2, 1)),
                               atol=RESAMPLE_ATOL)


@pytest.mark.parametrize("niters,softmask,residual", [
    (0, False, False), (0, True, False), (0, False, True), (1, False, False),
    (1, True, True), (2, False, True), (2, True, False)])
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_wiener_matches_jax(niters, softmask, residual, channels):
    rng = np.random.default_rng(4)
    t, f, s = 8, 5, 3
    targets = np.abs(rng.standard_normal((t, f, channels, s))).astype(np.float32)
    mix = rng.standard_normal((t, f, channels, 2)).astype(np.float32)
    got = wiener_ri(torch.from_numpy(targets), torch.from_numpy(mix), niters,
                    softmask=softmask, residual=residual)
    jitted = jax.jit(jax_wiener, static_argnums=2, static_argnames=("softmask", "residual"))
    ref = np.asarray(jitted(jnp.asarray(targets), jnp.asarray(mix), niters,
                            softmask=softmask, residual=residual))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=WIENER_ATOL)


# --------------------------------------------------------------------------
# demix's demucs mode and the session
# --------------------------------------------------------------------------

def test_demix_demucs_mode_matches_jax():
    """Plain averaging, zero-padded tail, no border: a position-dependent
    stand-in model through both engines."""
    from sesa_tpu.runtime.demix import DemixSpec as JaxSpec
    from sesa_tpu.runtime.demix import demix as jax_demix

    mix = np.random.default_rng(5).standard_normal((2, 10007)).astype(np.float32)
    kw = dict(chunk_size=2048, num_overlap=2, batch_size=3, num_stems=2)
    ramp = np.linspace(0.5, 1.5, 2048, dtype=np.float32)

    def jax_model(p, c):
        return jnp.stack([c * p, jnp.roll(c, 1, axis=-1) ** 2], axis=1)

    ref = jax_demix(jax.tree_util.Partial(jax_model), jnp.asarray(ramp), mix,
                    JaxSpec(demucs_mode=True, **kw))
    spec = DemixSpec(demucs_mode=True, **kw)
    assert spec.border == 0 and spec.step == 1024
    got = demix(lambda p, c: torch.stack([c * p, c.roll(1, -1) ** 2], dim=1),
                torch.from_numpy(ramp), mix, spec, device="cpu")
    assert got.shape == (2, 2, 10007)
    np.testing.assert_allclose(got, np.asarray(ref), atol=DEMIX_ATOL)


def test_session_runs_legacy_demucs_like_jax(tmp_path):
    """model_type htdemucs with ``model: demucs``: chunks of samplerate x
    segment, plain averaging, stems named by training.instruments; the port's
    session against the JAX session on one checkpoint file of the torch
    oracle. Without an ``audio`` section the sample rate raises in both."""
    from sesa_tpu.runtime.session import InferenceSession as JaxSession
    from sesa_tpu_torch.runtime.session import InferenceSession

    cfg = {"model": "demucs",
           "demucs": {"channels": 8, "depth": 4, "lstm_layers": 0, "resample": True,
                      "dconv_comp": 2},
           "training": {"instruments": ["drums", "bass", "other", "vocals"], "channels": 2,
                        "samplerate": 44100, "segment": 0.5},
           "inference": {"num_overlap": 2, "batch_size": 2}}
    cfg_path = str(tmp_path / "demucs.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    ckpt = str(tmp_path / "demucs.th")
    torch.save({"state": legacy_oracle(_tcfg_legacy(cfg)).state_dict()}, ckpt)

    sess = InferenceSession.create("htdemucs", cfg_path, ckpt, compute_dtype=None, device="cpu")
    jsess = JaxSession.create("htdemucs", cfg_path, ckpt, compute_dtype=None)
    assert sess.spec.demucs_mode and sess.spec.chunk_size == jsess.spec.chunk_size == 22050
    assert sess.instruments == jsess.instruments == ["drums", "bass", "other", "vocals"]
    for s in (sess, jsess):
        with pytest.raises(AttributeError):
            s.sample_rate
    song = (np.random.default_rng(7).standard_normal((2, 30000)) * 0.2).astype(np.float32)
    got, ref = sess.separate(song), jsess.separate(song)
    assert list(got) == list(ref)
    for name in got:
        assert got[name].shape == song.shape
        np.testing.assert_allclose(got[name], ref[name], atol=ATOL)


def _tcfg_legacy(cfg):
    from ml_collections import ConfigDict

    return ConfigDict(cfg)


def test_registry_resolves_htdemucs():
    assert get_model("htdemucs") is htdemucs
