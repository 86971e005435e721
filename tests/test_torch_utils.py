"""The port's LoRA merge (``convert/lora.py``) and reference-shaped utils API
(``utils.py``) held against sesa_tpu on the CPU: ``merge_lora`` to the bit
on the cases of ``tests/test_aux.py``; ``load_start_checkpoint`` with a
LoRA adapter on disk, ``load_not_compatible_weights`` (the case of
``tests/test_utils_compat.py``), ``demix`` and ``apply_tta`` against the
JAX package's on the same weights and mix."""

import json
import types

import numpy as np
import pytest
import torch
import yaml

import jax
from ml_collections import ConfigDict

from sesa_tpu import utils as jax_utils
from sesa_tpu.convert.lora import merge_lora as jax_merge_lora
from sesa_tpu.models import bs_roformer as jax_bs
from sesa_tpu_torch import utils
from sesa_tpu_torch.cli import main as cli_main
from sesa_tpu_torch.convert.from_jax import params_from_jax
from sesa_tpu_torch.convert.lora import merge_lora
from tests.test_roformer import bs_model_cfg, export_state_dict
from tests.test_torch_mdx23c import _leaves

# ROADMAP's end-to-end tolerance of the port against the JAX package (f32)
ATOL = 5e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# merge_lora
# --------------------------------------------------------------------------

def _lora_case(name):
    """(base, lora, kwargs) of the cases of tests/test_aux.py."""
    rng = np.random.default_rng({"full": 0, "partial": 1, "all_enabled": 2, "keys": 3}[name])
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    if name == "full":
        return {"lin.weight": f(8, 4)}, {"lin.lora_A": f(2, 4), "lin.lora_B": f(8, 2)}, \
            dict(r=2, lora_alpha=4)
    if name == "partial":  # 3 blocks of 4 (qkv), q and v adapted, r 2
        return {"qkv.weight": f(12, 4)}, {"qkv.lora_A": f(4, 4), "qkv.lora_B": f(8, 2)}, \
            dict(lora_alpha=2, enable_lora=[True, False, True])
    if name == "all_enabled":
        return {"qkv.weight": f(12, 4)}, {"qkv.lora_A": f(6, 4), "qkv.lora_B": f(12, 2)}, \
            dict(r=2, lora_alpha=4, enable_lora=[True, True, True])
    # fine-tuned keys saved beside the pairs override the base; a pair whose
    # weight the base lacks is skipped
    return ({"lin.weight": f(4, 4), "norm.weight": np.ones(4, np.float32)},
            {"norm.weight": np.full(4, 2.0, np.float32), "other.lora_A": f(2, 4),
             "other.lora_B": f(4, 2)}, {})


@pytest.mark.parametrize("name", ["full", "partial", "all_enabled", "keys"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_merge_lora_matches_jax(name, as_tensor):
    base, lora, kw = _lora_case(name)
    ref = jax_merge_lora(base, lora, **kw)
    if as_tensor:
        base = {k: torch.from_numpy(v) for k, v in base.items()}
        lora = {k: torch.from_numpy(v) for k, v in lora.items()}
    got = merge_lora(base, lora, **kw)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert isinstance(got[k], torch.Tensor)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    if name == "partial":  # the disabled block is untouched
        np.testing.assert_array_equal(got["qkv.weight"][4:8].numpy(), np.asarray(base["qkv.weight"])[4:8])


def test_merge_lora_shape_mismatch_is_typed():
    """A MergedLinear adapter merged without its enable_lora: both packages
    raise the same error."""
    base = {"qkv.weight": np.zeros((12, 4), np.float32)}
    lora = {"qkv.lora_A": np.zeros((4, 4), np.float32), "qkv.lora_B": np.zeros((8, 2), np.float32)}
    for fn in (merge_lora, jax_merge_lora):
        with pytest.raises(ValueError, match="MergedLinear"):
            fn(base, lora)


# --------------------------------------------------------------------------
# load_start_checkpoint with LoRA
# --------------------------------------------------------------------------

LORA = {"r": 2, "lora_alpha": 4, "enable_lora": [True, False, True]}


def _roformer_config(tmp_path, mcfg, lora=True):
    cfg = {"audio": {"chunk_size": 4096, "num_channels": 2, "sample_rate": 44100},
           "model": mcfg, "training": {"instruments": ["vocals", "other"], "target_instrument": None},
           "inference": {"num_overlap": 2, "batch_size": 2}}
    if lora:
        cfg["lora"] = LORA
    path = str(tmp_path / f"config{mcfg['dim']}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(cfg)), f)
    return path


def _write_roformer(tmp_path, dim=32, seed=0, lora=True):
    """A bs_roformer checkpoint, a LoRA adapter for its qkv projections (q
    and v blocks, with a fine-tuned norm beside them) and a config; paths."""
    mcfg = bs_model_cfg(dim=dim)
    params = jax_bs.init(jax.random.PRNGKey(seed), ConfigDict({"model": mcfg}))
    sd = export_state_dict(params, jax_bs.spec_from_config(mcfg), transformer_norm_output=False,
                           final_norm=True)
    ckpt = str(tmp_path / f"base{dim}.ckpt")
    torch.save({"state_dict": {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}}, ckpt)
    rng = np.random.default_rng(7)
    adapter = {}
    for k, v in sd.items():
        if k.endswith("to_qkv.weight"):
            prefix = k[:-len(".weight")]
            block = np.shape(v)[0] // 3
            adapter[prefix + ".lora_A"] = torch.from_numpy(
                0.3 * rng.standard_normal((2 * LORA["r"], np.shape(v)[1])).astype(np.float32))
            adapter[prefix + ".lora_B"] = torch.from_numpy(
                0.3 * rng.standard_normal((2 * block, LORA["r"])).astype(np.float32))
    adapter["layers.0.0.layers.0.0.norm.gamma"] = torch.full((dim,), 1.5)
    lora_path = str(tmp_path / "lora.ckpt")
    torch.save(adapter, lora_path)
    return ckpt, lora_path, _roformer_config(tmp_path, mcfg, lora)


def test_load_start_checkpoint_with_lora_matches_jax(tmp_path):
    ckpt, lora_path, cfg_path = _write_roformer(tmp_path)
    mix = (np.random.default_rng(0).standard_normal((2, 7000)) * 0.2).astype(np.float32)

    jb, jcfg = jax_utils.get_model_from_config("bs_roformer", cfg_path)
    jax_utils.load_start_checkpoint(jb, ckpt, lora_checkpoint=lora_path)
    ref = jax_utils.demix(jcfg, jb, mix)

    bundle, config = utils.get_model_from_config("bs_roformer", cfg_path)
    utils.load_start_checkpoint(bundle, ckpt, lora_checkpoint=lora_path)
    got = utils.demix(config, bundle, mix, device="cpu")
    assert list(got) == list(ref) == ["vocals", "other"]
    for name in ref:
        assert got[name].shape == mix.shape
        np.testing.assert_allclose(got[name], np.asarray(ref[name]), atol=ATOL, err_msg=name)

    # the adapter moved the separation: the base alone gives other stems
    utils.load_start_checkpoint(bundle, ckpt)
    base = utils.demix(config, bundle, mix, device="cpu")
    assert np.abs(base["vocals"] - got["vocals"]).max() > 100 * ATOL


# --------------------------------------------------------------------------
# load_not_compatible_weights, demix, apply_tta
# --------------------------------------------------------------------------

def test_load_not_compatible_weights_matches_jax(tmp_path):
    """A dim-32 checkpoint into a dim-48 model from the same initial
    parameters: the JAX package's result leaf for leaf (copied, sliced with
    zeros, or kept)."""
    ckpt, _, _ = _write_roformer(tmp_path, dim=32, lora=False)
    cfg48 = _roformer_config(tmp_path, bs_model_cfg(dim=48), lora=False)
    jb, _ = jax_utils.get_model_from_config("bs_roformer", cfg48)
    jb.init(seed=1)
    bundle, config = utils.get_model_from_config("bs_roformer", cfg48)
    bundle.params = params_from_jax(jax.tree.map(np.asarray, jb.params), "bs_roformer", config)
    jax_utils.load_not_compatible_weights(jb, ckpt)
    utils.load_not_compatible_weights(bundle, ckpt)
    got, ref = _leaves(bundle.params), _leaves(jb.params)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, g), (_, r) in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=path)
    lw = bundle.params["layers"][0]["time"]["layers"][0]["ff"]["lin1_w"]
    assert lw.shape == (192, 48) and bool((lw[128:] == 0).all()) and bool((lw[:, 32:] == 0).all())


def _mdx_config(tmp_path):
    cfg = {"audio": {"n_fft": 512, "hop_length": 128, "dim_f": 256, "num_channels": 2,
                     "chunk_size": 8064, "sample_rate": 44100},
           "model": {"num_subbands": 2, "num_scales": 2, "scale": [2, 2],
                     "num_blocks_per_scale": 1, "num_channels": 8, "growth": 4,
                     "bottleneck_factor": 2, "norm": "InstanceNorm", "act": "gelu"},
           "training": {"instruments": ["vocals", "other"], "target_instrument": None},
           "inference": {"num_overlap": 2, "batch_size": 2}}
    path = str(tmp_path / "mdx.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def test_demix_and_tta_match_jax(tmp_path):
    """The flow of tests/test_utils_compat.py on mdx23c, the port's bundle on
    the JAX bundle's parameters."""
    path = _mdx_config(tmp_path)
    jb, jcfg = jax_utils.get_model_from_config("mdx23c", path)
    jb.init(0)
    bundle, config = utils.get_model_from_config("mdx23c", path)
    bundle.params = params_from_jax(jax.tree.map(np.asarray, jb.params), "mdx23c", config)
    mix = (np.random.default_rng(0).standard_normal((2, 20000)) * 0.1).astype(np.float32)

    ref = jax_utils.demix(jcfg, jb, mix, model_type="mdx23c")
    got = utils.demix(config, bundle, mix, device="cpu", model_type="mdx23c")
    assert set(got) == {"vocals", "other"}
    for name in ref:
        assert isinstance(got[name], np.ndarray) and got[name].shape == (2, 20000)
        np.testing.assert_allclose(got[name], np.asarray(ref[name]), atol=ATOL, err_msg=name)

    ref_tta = jax_utils.apply_tta(jcfg, jb, mix, ref, model_type="mdx23c")
    got_tta = utils.apply_tta(config, bundle, mix, got, device="cpu", model_type="mdx23c")
    for name in ref_tta:
        np.testing.assert_allclose(got_tta[name], np.asarray(ref_tta[name]), atol=ATOL,
                                   err_msg=name)


def test_demix_runs_on_cuda_unless_asked(tmp_path):
    """No fallback: without a GPU the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    bundle, config = utils.get_model_from_config("mdx23c", _mdx_config(tmp_path))
    bundle.init(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        utils.demix(config, bundle, np.zeros((2, 9000), np.float32))


def test_bundle_call_dispatches_on_the_signature():
    seen = []
    with_dtype = types.SimpleNamespace(
        init=lambda gen, cfg: {"w": torch.rand(1, generator=gen)},
        apply=lambda params, config, chunks, compute_dtype=None: seen.append(compute_dtype))
    without = types.SimpleNamespace(apply=lambda params, config, chunks: seen.append("f32"))
    bundle = utils.ModelBundle("x", with_dtype, {})
    a = bundle.init(3)["w"]
    assert torch.equal(a, utils.ModelBundle("x", with_dtype, {}).init(3)["w"])
    bundle(torch.zeros(1), compute_dtype=torch.bfloat16)
    utils.ModelBundle("y", without, {}, params={})(torch.zeros(1), compute_dtype=torch.bfloat16)
    assert seen == [torch.bfloat16, "f32"]


def test_normalize_audio_matches_jax():
    from sesa_tpu.runtime.session import normalize_audio as jax_normalize

    audio = (np.random.default_rng(2).standard_normal((2, 3000)) * 0.3 + 0.1).astype(np.float32)
    ref, ref_norm = jax_normalize(audio)
    for a in (audio, torch.from_numpy(audio)):
        got, norm = utils.normalize_audio(a)
        np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5, atol=1e-6)
        assert norm["mean"] == pytest.approx(float(ref_norm["mean"]), rel=1e-5)
        assert norm["std"] == pytest.approx(float(ref_norm["std"]), rel=1e-5)
        np.testing.assert_allclose(np.asarray(utils.denormalize_audio(got, norm)), audio,
                                   atol=1e-5)


def test_cli_lora_flag_names_the_utils_route(tmp_path):
    (tmp_path / "in").mkdir()
    with pytest.raises(NotImplementedError, match="utils.load_start_checkpoint"):
        cli_main(["--model_type", "mdx23c", "--config_path", _mdx_config(tmp_path),
                  "--input_folder", str(tmp_path / "in"), "--lora_checkpoint", "x.ckpt",
                  "--force_cpu"])
