"""The port's ``convert.export`` (``torch.export`` in place of StableHLO)
held against sesa_tpu's on tests/test_aux.py:87's mdx23c: export, load and
call equal the port's ``apply`` and JAX's ``apply`` on weights carried from
JAX; a trace that reaches a kernel's launch (bs_mamba2's Mamba mixer and
K8, the one f32 path that launches kernels) is refused naming the kernel."""

import numpy as np
import pytest
import torch

import jax

from ml_collections import ConfigDict

from sesa_tpu.models import mdx23c as jax_mdx
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.convert.export import export_model, load_exported
from sesa_tpu_torch.convert.from_jax import params_from_jax
from sesa_tpu_torch.models import mdx23c
from sesa_tpu_torch.tree import tree_map

CONFIG = {
    "audio": {"n_fft": 512, "hop_length": 128, "dim_f": 256,
              "num_channels": 2, "chunk_size": 8064, "sample_rate": 44100},
    "model": {"num_subbands": 2, "num_scales": 2, "scale": [2, 2],
              "num_blocks_per_scale": 1, "num_channels": 8, "growth": 4,
              "bottleneck_factor": 2, "norm": "InstanceNorm", "act": "gelu"},
    "training": {"instruments": ["vocals", "other"], "target_instrument": None},
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's six workers share eight cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_export_load_call_matches_apply_and_jax(tmp_path):
    jcfg, cfg = ConfigDict(CONFIG), AttrDict(CONFIG)
    jparams = jax.jit(lambda k: jax_mdx.init(k, jcfg))(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "mdx23c", cfg)
    x = (np.random.default_rng(0).standard_normal((1, 2, 8064)) * 0.1).astype(np.float32)
    ref_jax = np.asarray(jax.jit(lambda p, v: jax_mdx.apply(p, jcfg, v))(jparams, x))

    path = str(tmp_path / "mdx23c.pt2")
    blob = export_model("mdx23c", cfg, params, chunk_size=8064, path=path, device="cpu")
    assert isinstance(blob, bytes) and len(blob) > 1000
    with open(path, "rb") as f:
        assert f.read() == blob
    xt = torch.from_numpy(x)
    ref = mdx23c.apply(params, cfg, xt)
    fn = load_exported(blob)
    got = fn(params, xt)
    assert got.shape == ref.shape == (1, 2, 2, 8064)
    # the same ops on the same weights: equal to the port's apply
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)
    # tests/test_aux.py's bound against the JAX forward
    np.testing.assert_allclose(got.numpy(), ref_jax, atol=1e-5)
    # the program takes the weights as an input: other weights of the same shapes
    other = tree_map(lambda t: 0.9 * t, params)
    np.testing.assert_allclose(fn(other, xt).numpy(), mdx23c.apply(other, cfg, xt).numpy(),
                               atol=1e-6)
    # the file holds the same program
    np.testing.assert_array_equal(load_exported(path)(params, xt).numpy(), got.numpy())


def _mamba_on_meta(monkeypatch):
    """A small bs_mamba2 whose export traces on the meta device, off the CPU
    path of the wrappers: no tensor reaches a card."""
    import sesa_tpu_torch.convert.export as ex
    from sesa_tpu_torch.models import bs_mamba2

    cfg = AttrDict({"model": dict(sr=44100, win=256, stride=64, feature_dim=16,
                                  num_repeat_mask=1, num_repeat_map=1, num_output=1)})
    params = bs_mamba2.init(torch.Generator().manual_seed(0), cfg)
    monkeypatch.setattr(ex, "get_device", lambda device=None: torch.device("meta"))
    return cfg, params


def test_bs_mamba2_on_cuda_is_refused_naming_k8(monkeypatch):
    """A trace that reaches a kernel wrapper's launch raises naming the
    kernel (ops._build.refuse_export), before the wrapper touches memory.
    Here the mixer's steps around the scan run their plain versions, and
    K8's gate is forced on as on CUDA."""
    from sesa_tpu_torch.models import bs_mamba2
    from sesa_tpu_torch.ops import mamba, ssd

    cfg, params = _mamba_on_meta(monkeypatch)
    monkeypatch.setattr(bs_mamba2, "mamba_conv", mamba.mamba_conv_plain)
    monkeypatch.setattr(bs_mamba2, "mamba_gate_norm", mamba.mamba_gate_norm_plain)
    monkeypatch.setattr(ssd, "use_fused_ssd", lambda *args: True)
    with pytest.raises(ValueError, match=r"ssd_fused \(K8\): torch.export cannot trace"):
        export_model("bs_mamba2", cfg, params, chunk_size=4096)


def test_bs_mamba2_on_cuda_is_refused_naming_the_mixer(monkeypatch):
    """The first kernel a bs_mamba2 trace reaches off the CPU is the mixer's
    conv, whose wrapper refuses it the same way."""
    cfg, params = _mamba_on_meta(monkeypatch)
    with pytest.raises(ValueError, match=r"mamba_conv: torch.export cannot trace"):
        export_model("bs_mamba2", cfg, params, chunk_size=4096)
