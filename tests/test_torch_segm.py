"""The port's segm_models / torchseg U-Nets, with the MaxViT, ResNet (basic
and bottleneck) and EfficientNet encoders and the fallback conv U-Net, held
against sesa_tpu on the CPU, on the same numpy inputs and weights, at the
tiny configs and torch oracles of ``tests/test_maxvit_unet.py``,
``tests/test_resnet_unet.py`` and ``tests/test_efficientnet_unet.py``.

Each encoder's weights are its oracle's state dict, converted once by the
JAX converter (a module-scoped fixture); the port runs them through
``params_from_jax`` and converts the same state dict itself. The image path
and the whole models run under ``jax.jit`` (eagerly, the JAX MaxViT
took 30 s on a CPU)."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sesa_tpu.models import efficientnet_unet as jax_eff
from sesa_tpu.models import maxvit_unet as jax_maxvit
from sesa_tpu.models import resnet_unet as jax_resnet
from sesa_tpu.models import segm_models as jax_segm
from sesa_tpu_torch.audio_io import read_audio, write_audio
from sesa_tpu_torch.cli import main as cli_main
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.convert.from_jax import params_from_jax
from sesa_tpu_torch.models import efficientnet_unet, get_model, maxvit_unet, resnet_unet
from sesa_tpu_torch.models import segm_models
from tests.test_efficientnet_unet import tiny_config as eff_config
from tests.test_efficientnet_unet import torch_model as eff_model
from tests.test_maxvit_unet import tiny_config as maxvit_config
from tests.test_maxvit_unet import torch_model as maxvit_model
from tests.test_resnet_unet import tiny_config as resnet_config
from tests.test_resnet_unet import torch_model as resnet_model
from tests.test_torch_mdx23c import _leaves

# ROADMAP's end-to-end tolerance of the port against the JAX package (f32)
ATOL = 5e-4
LAYOUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "layouts")


def _fallback_config():
    cfg = resnet_config()
    cfg.model.encoder_name = "mobilenet_v2"
    return cfg


# encoder -> (tiny config, torch oracle or None for the fallback U-Net)
ENCODERS = {
    "maxvit": (maxvit_config, maxvit_model),
    "resnet_basic": (lambda: resnet_config("basic"), lambda: resnet_model("basic")),
    "resnet_bottleneck": (lambda: resnet_config("bottleneck"),
                          lambda: resnet_model("bottleneck")),
    "efficientnet": (eff_config, eff_model),
    "fallback": (_fallback_config, None),
}
NATIVE = [e for e, (_, oracle) in ENCODERS.items() if oracle is not None]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch: with the tier-1 run's six workers on
    eight cores, torch's thread pools spin against each other."""
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


def _torch_cfg(cfg):
    return AttrDict(cfg.to_dict())


def _conditioned(sd, gain=1.0, seed=2):
    """The oracles draw every parameter from U(-0.25, 0.25) and every buffer
    from U(0.5, 1.5): the norms then scale each stage down by about 7 and
    batch norm's running means dwarf the activations, so the U-Net's output
    hardly depends on its input and an encoder or decoder fault would not
    show. Here the products keep unit variance (U(+-sqrt(3 / fan_in)) times
    ``gain``), the norms' scales are 1 + N(0, 0.1) and their shifts and
    running means N(0, 0.1)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in sd.items():
        if not v.dtype.is_floating_point or k.endswith("running_var"):
            out[k] = v
        elif v.ndim >= 2 and not k.endswith("relative_position_bias_table"):
            fan_in = v[0].numel()
            out[k] = (torch.rand(v.shape, generator=gen) * 2 - 1) * gain * (3 / fan_in) ** 0.5
        elif k.endswith(".weight"):
            out[k] = 1 + 0.1 * torch.randn(v.shape, generator=gen)
        else:
            out[k] = 0.1 * torch.randn(v.shape, generator=gen)
    return out


_WEIGHTS = {}


@pytest.fixture(scope="module")
def weights():
    """encoder -> (config, oracle state dict or None, JAX params as numpy),
    built once: the oracle's state dict through the JAX converter, or the
    port's init for the fallback U-Net (the trees are the same)."""
    def get(enc):
        if enc not in _WEIGHTS:
            cfg_fn, oracle = ENCODERS[enc]
            cfg = cfg_fn()
            if oracle is None:
                sd = None
                params = _numpy_tree(segm_models.init(torch.Generator().manual_seed(0),
                                                      _torch_cfg(cfg)))
            else:
                # EfficientNet's swish and SE gates halve each block's variance
                gain = 1.5 if enc == "efficientnet" else 1.0
                sd = _conditioned(oracle().state_dict(), gain)
                params = _numpy_tree(jax_segm.convert_torch(sd, cfg))
            _WEIGHTS[enc] = (cfg, sd, params)
        return _WEIGHTS[enc]
    return get


def _assert_same_tree(got, ref):
    got_l, ref_l = _leaves(got), _leaves(ref)
    assert [p for p, _ in got_l] == [p for p, _ in ref_l]
    for (path, g), (_, r) in zip(got_l, ref_l):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=path)


# --------------------------------------------------------------------------
# the image path and the whole model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("enc", list(ENCODERS))
def test_image_path_matches_jax(weights, enc):
    cfg, _, params = weights(enc)
    img = (np.random.default_rng(0).standard_normal((2, 8, 64, 64)) * 0.3).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, a: jax_segm.image_path(p, cfg, a))(params, jnp.asarray(img)))
    tcfg = _torch_cfg(cfg)
    got = segm_models.image_path(params_from_jax(params, "segm_models", tcfg), tcfg,
                                 torch.from_numpy(img))
    assert got.shape == ref.shape == (2, 16, 64, 64)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("enc", list(ENCODERS))
def test_apply_matches_jax_f32(weights, enc):
    cfg, _, params = weights(enc)
    t = int(cfg.audio.chunk_size)
    x = (np.random.default_rng(1).standard_normal((1, 2, t)) * 0.2).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, a: jax_segm.apply(p, cfg, a))(params, jnp.asarray(x)))
    tcfg = _torch_cfg(cfg)
    model = "torchseg" if enc.startswith("resnet") else "segm_models"
    got = segm_models.apply(params_from_jax(params, model, tcfg), tcfg, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == ref.shape == (1, 2, 2, t)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("enc", NATIVE)
def test_encoder_features_match_jax(weights, enc):
    """Every level of the encoder's pyramid (the image path's output alone
    would hide an encoder fault behind the decoder)."""
    cfg, _, params = weights(enc)
    jax_mod = {"maxvit": jax_maxvit, "efficientnet": jax_eff}.get(enc, jax_resnet)
    mod = {"maxvit": maxvit_unet, "efficientnet": efficientnet_unet}.get(enc, resnet_unet)
    img = (np.random.default_rng(3).standard_normal((2, 8, 64, 64)) * 0.3).astype(np.float32)
    unet = params["unet"]["encoder"] if enc == "maxvit" else params["unet"]
    refs = jax.jit(lambda p, a: jax_mod._encoder(p, a, jax_mod.spec_from_config(cfg)))(
        unet, jnp.asarray(img))
    tcfg = _torch_cfg(cfg)
    tunet = params_from_jax(params, "segm_models", tcfg)["unet"]
    feats = mod._encoder(tunet["encoder"] if enc == "maxvit" else tunet, torch.from_numpy(img),
                         mod.spec_from_config(tcfg))
    assert len(feats) == len(refs) == 5
    for level, (got, ref) in enumerate(zip(feats, refs)):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, err_msg=str(level))


def test_apply_takes_no_compute_dtype():
    import inspect

    assert "compute_dtype" not in inspect.signature(segm_models.apply).parameters


# --------------------------------------------------------------------------
# converters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("enc", NATIVE)
def test_convert_torch_matches_jax(weights, enc):
    cfg, sd, params = weights(enc)
    _assert_same_tree(segm_models.convert_torch(sd, _torch_cfg(cfg)), params)


def test_maxvit_nested_stage_naming(weights):
    """timm without flatten_sequential names stages.0.*: both namings convert
    to one tree."""
    cfg, sd, params = weights("maxvit")
    nested = {}
    for k, v in sd.items():
        for i in range(4):
            k = k.replace(f"stages_{i}.", f"stages.{i}.")
        nested[k] = v
    assert nested.keys() != sd.keys()
    _assert_same_tree(segm_models.convert_torch(nested, _torch_cfg(cfg)), params)


def test_torchseg_encoder_prefix(weights):
    """torchseg holds the timm model as ``encoder``, smp as ``encoder.model``."""
    cfg, sd, params = weights("maxvit")
    flat = {k.replace("unet_model.encoder.model.", "unet_model.encoder."): v
            for k, v in sd.items()}
    assert "unet_model.encoder.stem.conv1.weight" in flat
    _assert_same_tree(segm_models.convert_torch(flat, _torch_cfg(cfg)), params)
    _assert_same_tree(segm_models.convert_torch(flat, _torch_cfg(cfg)),
                      _numpy_tree(jax_segm.convert_torch(flat, cfg)))


@pytest.mark.parametrize("enc", NATIVE)
def test_convert_torch_is_strict(weights, enc):
    cfg, sd, _ = weights(enc)
    extra = dict(sd, **{"unet_model.decoder.blocks.0.stray": torch.zeros(1)})
    with pytest.raises(ValueError, match="unconsumed"):
        segm_models.convert_torch(extra, _torch_cfg(cfg))
    missing = dict(sd)
    del missing["unet_model.segmentation_head.0.weight"]
    with pytest.raises(KeyError):
        segm_models.convert_torch(missing, _torch_cfg(cfg))


@pytest.mark.parametrize("name,enc", [("maxvit_unet", "maxvit"),
                                      ("resnet_unet", "resnet_basic"),
                                      ("efficientnet_unet", "efficientnet")])
def test_layout_fixture_keys_all_consumed(name, enc):
    """Every key of the committed layout manifest, as random tensors of the
    listed shapes, is consumed by the port's converter, into the JAX
    converter's tree."""
    with open(os.path.join(LAYOUTS, f"{name}.json")) as f:
        shapes = json.load(f)
    gen = torch.Generator().manual_seed(5)
    sd = {k: (torch.tensor(0) if k.endswith("num_batches_tracked")
              else torch.rand(tuple(s), generator=gen)) for k, s in shapes.items()}
    cfg = ENCODERS[enc][0]()
    _assert_same_tree(segm_models.convert_torch(sd, _torch_cfg(cfg)),
                      _numpy_tree(jax_segm.convert_torch(sd, cfg)))


def test_unknown_encoder_refuses_conversion():
    with pytest.raises(NotImplementedError, match="mobilenet_v2"):
        segm_models.convert_torch({}, _torch_cfg(_fallback_config()))


def test_native_encoders_need_the_unet_decoder():
    cfg = maxvit_config().to_dict()
    cfg["model"]["decoder_type"] = "fpn"
    with pytest.raises(NotImplementedError, match="fpn"):
        segm_models.init(torch.Generator().manual_seed(0), AttrDict(cfg))


# --------------------------------------------------------------------------
# encoder specs and the partition contract
# --------------------------------------------------------------------------

def test_specs_match_jax():
    cfg = maxvit_config()
    del cfg.model["maxvit"]
    del cfg["decoder_unet"]
    spec = maxvit_unet.spec_from_config(_torch_cfg(cfg))
    assert spec == jax_maxvit.spec_from_config(cfg)
    assert (spec["dims"], spec["depths"], spec["stem_width"], spec["dim_head"],
            spec["partition"]) == ((128, 256, 512, 1024), (2, 6, 14, 2), 128, 32, 16)
    for name in efficientnet_unet.EFFICIENTNET_COEFFS:
        cfg = eff_config()
        cfg.model.efficientnet = {}
        cfg.model.encoder_name = name
        assert efficientnet_unet.spec_from_config(_torch_cfg(cfg)) == \
            jax_eff.spec_from_config(cfg), name
    for name in resnet_unet.RESNET_SPECS:
        cfg = resnet_config()
        cfg.model.resnet = {}
        cfg.model.encoder_name = name
        assert resnet_unet.spec_from_config(_torch_cfg(cfg)) == \
            jax_resnet.spec_from_config(cfg), name


def test_partition_must_divide_the_feature_map(weights):
    """A 64 x 96 image leaves 2 x 3 at the last stage: not divisible by the
    partition 2, in the port as in JAX."""
    cfg, _, params = weights("maxvit")
    img = np.zeros((1, 8, 64, 96), np.float32)
    with pytest.raises(ValueError, match="not divisible by partition 2"):
        jax.jit(lambda p, a: jax_segm.image_path(p, cfg, a))(params, jnp.asarray(img))
    tcfg = _torch_cfg(cfg)
    with pytest.raises(ValueError, match="not divisible by partition 2"):
        segm_models.image_path(params_from_jax(params, "segm_models", tcfg), tcfg,
                               torch.from_numpy(img))


# --------------------------------------------------------------------------
# registry and CLI
# --------------------------------------------------------------------------

def test_registry_resolves_segm_models_and_torchseg():
    assert get_model("segm_models") is segm_models
    assert get_model("torchseg") is segm_models


@pytest.mark.parametrize("model_type,enc", [("segm_models", "maxvit"),
                                            ("torchseg", "resnet_bottleneck")])
def test_cli_separates(tmp_path, model_type, enc):
    cfg = ENCODERS[enc][0]().to_dict()
    cfg["inference"] = {"num_overlap": 2, "batch_size": 2, "normalize": False}
    cfg_path = str(tmp_path / "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    song = (np.random.default_rng(8).standard_normal((2, 9000)) * 0.2).astype(np.float32)
    (tmp_path / "in").mkdir()
    write_audio(str(tmp_path / "in" / "song.wav"), song, 44100)
    sessions = []
    rc = cli_main(["--model_type", model_type, "--config_path", cfg_path,
                   "--input_folder", str(tmp_path / "in"), "--store_dir", str(tmp_path / "out"),
                   "--force_cpu"], session_out=sessions)
    assert rc == 0 and not sessions[0]._prepared
    for name in ("vocals", "other"):
        out, _ = read_audio(str(tmp_path / "out" / f"song_{name}.wav"))
        assert out.shape == song.shape and np.isfinite(out).all()

