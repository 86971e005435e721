"""The port's swin_upernet held against sesa_tpu on the CPU, on the same
numpy inputs and weights, at the tiny config of
``tests/test_swin_upernet.py`` and at a second one whose pyramid pooling
shrinks (pool scale 6 over a 5 x 4 top map).

The weights are one HuggingFace-layout state dict per config
(``tests/test_swin_upernet.py``'s locally built ``UperNetForSemanticSegmentation``
shell), reconditioned as ``tests/test_torch_segm.py`` does: with HF's own
init (std 0.02) the net's share of the output is small and a fault inside
it could hide. Each is converted once by the JAX converter (a
module-scoped fixture); the port runs the JAX tree through
``params_from_jax`` and converts the same state dict itself. The JAX
references run under ``jax.jit``.

The bf16 forwards run with oneDNN off (its bf16 convolution is wrong for
some shapes on some x86 CPUs; ``tests/test_torch_mdx23c.py``)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sesa_tpu.models import swin_upernet as jax_swin
from sesa_tpu_torch.audio_io import read_audio, write_audio
from sesa_tpu_torch.cli import main as cli_main
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.convert.from_jax import params_from_jax
from sesa_tpu_torch.models import get_model, swin_upernet
from tests.test_swin_upernet import build_torch_model, tiny_config
from tests.test_torch_mdx23c import _leaves
from tests.test_torch_segm import _conditioned

SAMPLES = 4096
HIGHEST = jax.lax.Precision.HIGHEST
# bf16 against the JAX package's bf16, relative to max |JAX f32|: both round
# at the same points (LayerNorm statistics in bf16, softmax and resizes in
# f32) but sum in other orders; 0.02 is about five bf16 ulps of the output's
# scale, a quarter of the JAX package's own bf16 bound (0.08,
# tests/test_compute_dtype.py:23)
BF16_REL = 0.02
CONFIGS = {"tiny": [1, 2], "shrink": [1, 2, 3, 6]}


def _tol(ref):
    """The JAX package's tolerance against HF (tests/test_swin_upernet.py:143)."""
    return max(3e-4, 2e-3 * float(np.abs(ref).max()))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return np.array(tree)


_MODELS = {}


@pytest.fixture(scope="module")
def models():
    """name -> dict(cfg, tcfg, hf model, state dict, JAX params as numpy,
    x, JAX f32 output), built once."""
    def get(name):
        if name not in _MODELS:
            cfg = tiny_config()
            cfg.model.pool_scales = CONFIGS[name]
            torch.manual_seed(0)
            hf = build_torch_model(cfg)
            sd = _conditioned(hf.state_dict())
            hf.load_state_dict(sd)
            params = _numpy_tree(jax_swin.convert_torch(sd, cfg))
            x = (np.random.default_rng(0).standard_normal((1, 2, SAMPLES)) * 0.3).astype(np.float32)
            ref = np.asarray(jax.jit(lambda p, a: jax_swin.apply(p, cfg, a))(params, jnp.asarray(x)))
            _MODELS[name] = dict(cfg=cfg, tcfg=AttrDict(cfg.to_dict()), hf=hf, sd=sd,
                                 params=params, x=x, ref=ref)
        return _MODELS[name]
    return get


def _port_params(m):
    return params_from_jax(m["params"], "swin_upernet", m["tcfg"])


# --------------------------------------------------------------------------
# whole model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_apply_matches_jax_f32(models, name):
    m = models(name)
    got = swin_upernet.apply(_port_params(m), m["tcfg"], torch.from_numpy(m["x"]))
    assert got.dtype == torch.float32 and got.shape == m["ref"].shape == (1, 2, 2, SAMPLES)
    np.testing.assert_allclose(got.numpy(), m["ref"], atol=_tol(m["ref"]))


def test_shrinking_psp_resize_follows_jax(models):
    """At the shrinking config the PSP branch resizes 6 x 6 down to the 5 x
    4 top map: there jax.image.resize antialiases and HF's interpolate does
    not. The port follows JAX (test_apply_matches_jax_f32[shrink]); this
    holds that the case is real: JAX's output is further from HF's than the
    tolerance."""
    m = models("shrink")
    tcfg = m["tcfg"]
    img = torch.zeros((1, tcfg.model.num_channels, SAMPLES // tcfg.audio.hop_length + 1,
                       tcfg.audio.dim_f // tcfg.model.num_subbands))
    feats = swin_upernet._backbone(_port_params(m)["backbone"], img,
                                   swin_upernet._swin_kwargs(tcfg))
    assert max(feats[-1].shape[2:]) < max(CONFIGS["shrink"])
    with torch.inference_mode():
        hf = m["hf"](torch.from_numpy(m["x"])).numpy()
    assert np.abs(m["ref"] - hf).max() > _tol(m["ref"])


@pytest.mark.parametrize("name", ["tiny"])
def test_bf16_matches_jax_bf16(models, name):
    m = models(name)
    ref = np.asarray(jax.jit(lambda p, a: jax_swin.apply(p, m["cfg"], a, compute_dtype=jnp.bfloat16))(
        m["params"], jnp.asarray(m["x"])))
    params = swin_upernet.prepare(_port_params(m), m["tcfg"], torch.bfloat16)
    with torch.backends.mkldnn.flags(enabled=False):
        got = swin_upernet.apply(params, m["tcfg"], torch.from_numpy(m["x"]),
                                 compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    err, scale = np.abs(got.numpy() - ref).max(), np.abs(m["ref"]).max()
    assert err <= BF16_REL * scale, (err, scale)


# --------------------------------------------------------------------------
# the image path at odd sizes
# --------------------------------------------------------------------------

def test_odd_image_backbone_and_head_match_jax(models):
    """A 37 x 45 image: the patch embed pads it, window padding (10 -> 12, 5
    x 6 -> 8 x 8, 3 x 3 -> 4 x 4), the shift mask on padded maps and
    _patch_merge's padding of odd maps all run. Every stage's feature and
    the decode head's logits against JAX."""
    m = models("tiny")
    kw = jax_swin._swin_kwargs(m["cfg"])
    img = (np.random.default_rng(3).standard_normal((2, 8, 37, 45)) * 0.5).astype(np.float32)

    def jax_image(p, a):
        feats = jax_swin._backbone(p["backbone"], a, kw, HIGHEST)
        return feats, jax_swin._decode_head(p["decode_head"], feats, kw, HIGHEST)

    ref_feats, ref_logits = jax.jit(jax_image)(m["params"], jnp.asarray(img))
    params = _port_params(m)
    feats = swin_upernet._backbone(params["backbone"], torch.from_numpy(img),
                                   swin_upernet._swin_kwargs(m["tcfg"]))
    logits = swin_upernet._decode_head(params["decode_head"], feats,
                                       swin_upernet._swin_kwargs(m["tcfg"]))
    assert [tuple(f.shape[2:]) for f in feats] == [(10, 12), (5, 6), (3, 3)]
    for level, (got, ref) in enumerate(zip(feats + [logits], list(ref_feats) + [ref_logits])):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, atol=_tol(ref), err_msg=str(level))


def test_output_moves_with_input(models):
    """The decode head's logits (the Swin + UperNet part alone) and the
    separated output differ between two inputs by a tenth of their scale."""
    m = models("tiny")
    params, tcfg = _port_params(m), m["tcfg"]
    kw = swin_upernet._swin_kwargs(tcfg)
    rng = np.random.default_rng(4)
    imgs = [torch.from_numpy(rng.standard_normal((1, 8, 32, 32)).astype(np.float32))
            for _ in range(2)]
    a, b = (swin_upernet._decode_head(params["decode_head"],
                                      swin_upernet._backbone(params["backbone"], i, kw), kw)
            for i in imgs)
    assert float((a - b).abs().max()) > 0.1 * float(a.abs().max())
    x2 = (rng.standard_normal((1, 2, SAMPLES)) * 0.3).astype(np.float32)
    out2 = swin_upernet.apply(params, tcfg, torch.from_numpy(x2)).numpy()
    assert np.abs(out2 - m["ref"]).max() > 0.1 * np.abs(m["ref"]).max()


@pytest.mark.parametrize("hp,wp,win", [(4, 4, 4), (12, 16, 4), (24, 36, 12), (132, 132, 12)])
def test_index_and_shift_mask_match_jax(hp, wp, win):
    """The port builds both on the device, the JAX package in numpy."""
    np.testing.assert_array_equal(swin_upernet._rel_position_index(win).numpy(),
                                  jax_swin._rel_position_index(win))
    got = swin_upernet._shift_mask(hp, wp, win, win // 2)
    ref = jax_swin._shift_mask(hp, wp, win, win // 2)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


# --------------------------------------------------------------------------
# converter, registry, CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_convert_torch_matches_jax(models, name):
    """One HF-layout state dict through both converters: the same tree, leaf
    for leaf, and so the same output."""
    m = models(name)
    got, ref = _leaves(swin_upernet.convert_torch(m["sd"], m["tcfg"])), _leaves(m["params"])
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, g), (_, r) in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r, err_msg=path)


def test_convert_torch_is_strict(models):
    m = models("tiny")
    extra = dict(m["sd"], **{"swin_upernet_model.backbone.bogus.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="unconsumed"):
        swin_upernet.convert_torch(extra, m["tcfg"])
    missing = dict(m["sd"])
    del missing["swin_upernet_model.decode_head.classifier.bias"]
    with pytest.raises(KeyError):
        swin_upernet.convert_torch(missing, m["tcfg"])


def test_registry_and_init_tree():
    cfg = AttrDict(tiny_config().to_dict())
    assert get_model("swin_upernet") is swin_upernet
    a = swin_upernet.init(torch.Generator().manual_seed(1), cfg)
    b = jax.eval_shape(lambda: jax_swin.init(jax.random.PRNGKey(1), tiny_config()))
    assert [p for p, _ in _leaves(a)] == [p for p, _ in _leaves(b)]
    assert all(tuple(x.shape) == y.shape for (_, x), (_, y) in zip(_leaves(a), _leaves(b)))


def test_cli_separates_in_bf16(tmp_path):
    """The CLI's default bf16 session prepares the bf16 weights once and
    writes finite stems of the song's shape (oneDNN off, as above)."""
    cfg = tiny_config().to_dict()
    cfg["inference"] = {"num_overlap": 2, "batch_size": 2, "normalize": False}
    cfg_path = str(tmp_path / "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    song = (np.random.default_rng(8).standard_normal((2, 9000)) * 0.2).astype(np.float32)
    (tmp_path / "in").mkdir()
    write_audio(str(tmp_path / "in" / "song.wav"), song, 44100)
    sessions = []
    with torch.backends.mkldnn.flags(enabled=False):
        rc = cli_main(["--model_type", "swin_upernet", "--config_path", cfg_path,
                       "--input_folder", str(tmp_path / "in"), "--store_dir",
                       str(tmp_path / "out"), "--force_cpu"], session_out=sessions)
    assert rc == 0 and list(sessions[0]._prepared) == [torch.bfloat16]
    assert sessions[0].rescues == 0
    for name in ("vocals", "other"):
        out, _ = read_audio(str(tmp_path / "out" / f"song_{name}.wav"))
        assert out.shape == song.shape and np.isfinite(out).all()
