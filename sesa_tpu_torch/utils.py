"""Reference-shaped convenience API, the reference's utils.py surface
(counterpart of sesa_tpu/utils.py).

Users coming from the PyTorch reference find the same entry points
(reference utils.py: load_config :26, get_model_from_config :62, demix :330,
normalize / denormalize_audio :199 / :220, prefer_target_instrument :480,
apply_tta :241, load_start_checkpoint :585), with a model as a (module,
config, params) bundle instead of an nn.Module. ``demix`` and ``apply_tta``
run on CUDA unless ``device="cpu"`` is given, and move the bundle's
parameters there; without a GPU they raise.
"""

from __future__ import annotations

import inspect
from typing import Dict, Tuple

import numpy as np
import torch

from sesa_tpu_torch import get_device
from sesa_tpu_torch.configs import load_config  # noqa: F401  (re-export)
from sesa_tpu_torch.convert import convert_checkpoint, load_torch_state_dict
from sesa_tpu_torch.runtime.demix import apply_tta as _apply_tta
from sesa_tpu_torch.runtime.demix import demix as _demix
from sesa_tpu_torch.runtime.session import demix_spec as _spec_for
from sesa_tpu_torch.runtime.session import (denormalize_audio, normalize_audio,  # noqa: F401
                                            prefer_target_instrument)
from sesa_tpu_torch.tree import tree_map


class ModelBundle:
    """A model module, its config and its parameter tree."""

    def __init__(self, model_type: str, module, config, params=None):
        self.model_type = model_type
        self.module = module
        self.config = config
        self.params = params

    def init(self, seed: int = 0):
        """Seeded parameters, drawn on the CPU."""
        self.params = self.module.init(torch.Generator().manual_seed(seed), self.config)
        return self.params

    def __call__(self, chunks, compute_dtype=None):
        """The model on a chunk batch. A model whose ``apply`` takes no
        ``compute_dtype`` runs without one (f32). This is a signature check,
        not try/except: an error raised inside a model must surface."""
        if "compute_dtype" in inspect.signature(self.module.apply).parameters:
            return self.module.apply(self.params, self.config, chunks,
                                     compute_dtype=compute_dtype)
        return self.module.apply(self.params, self.config, chunks)


def get_model_from_config(model_type: str, config_path) -> Tuple[ModelBundle, object]:
    """(bundle without parameters, config); reference utils.py:62-161."""
    from sesa_tpu_torch.models import get_model

    config = load_config(model_type, config_path)
    return ModelBundle(model_type, get_model(model_type), config), config


def load_start_checkpoint(bundle: ModelBundle, checkpoint_path: str,
                          lora_checkpoint: str = "") -> None:
    """Load and convert a torch checkpoint into the bundle (reference
    utils.py:585-613). ``lora_checkpoint`` merges a LoRA adapter into the
    base state dict before conversion (the reference's load_lora_weights /
    bind_lora_to_model, utils.py:614-671), routed and scaled by the config's
    ``lora`` section (r, lora_alpha, enable_lora), the section the reference
    builds its MergedLinear modules from."""
    if lora_checkpoint:
        from sesa_tpu_torch.convert.lora import load_with_lora

        lora_cfg = dict(bundle.config.get("lora", {}) or {})
        kwargs = {k: lora_cfg[k] for k in ("r", "lora_alpha", "enable_lora") if k in lora_cfg}
        sd = load_with_lora(checkpoint_path, lora_checkpoint, **kwargs)
    else:
        sd = load_torch_state_dict(checkpoint_path)
    bundle.params = tree_map(lambda p: p.to(torch.float32),
                             convert_checkpoint(bundle.model_type, sd, bundle.config))


def load_not_compatible_weights(bundle: ModelBundle, checkpoint_path: str,
                                verbose: bool = False) -> None:
    """Load a checkpoint whose shapes differ from the model's (reference
    utils.py:502-558). Per tensor: same shape, copy; same rank, copy the
    overlapping slice and fill the rest with zeros (the reference fills
    with zeros, not with the initialised values); another rank, keep the
    model's values. The checkpoint must carry the full key set (the
    converters consume keys strictly), as every fine-tune of the same
    family does. A bundle without parameters is initialised from seed 0
    first."""
    if bundle.params is None:
        bundle.init()
    loaded = convert_checkpoint(bundle.model_type, load_torch_state_dict(checkpoint_path),
                                bundle.config)

    def slice_copy(dst, src):
        src = torch.as_tensor(src).to(dtype=dst.dtype, device=dst.device)
        if dst.shape == src.shape:
            return src
        if dst.ndim != src.ndim:
            if verbose:
                print(f"rank mismatch {tuple(src.shape)} -> {tuple(dst.shape)}: kept")
            return dst
        if verbose:
            print(f"slice-copy {tuple(src.shape)} -> {tuple(dst.shape)}")
        sl = tuple(slice(0, min(a, b)) for a, b in zip(dst.shape, src.shape))
        out = torch.zeros_like(dst)
        out[sl] = src[sl]
        return out

    bundle.params = tree_map(slice_copy, bundle.params, loaded)


def _apply_fn(bundle: ModelBundle, device):
    """The bundle's model in f32 on ``device``, its parameters moved there."""
    dev = get_device(device)
    bundle.params = tree_map(lambda p: p.to(dev), bundle.params)

    def apply_fn(params, chunks):
        with torch.inference_mode():
            out = bundle.module.apply(params, bundle.config, chunks)
        return out[:, None] if out.ndim == 3 else out

    return apply_fn, dev


def demix(config, bundle: ModelBundle, mix: np.ndarray, device=None, model_type: str = "",
          pbar: bool = False) -> Dict[str, np.ndarray]:
    """{instrument: (channels, T)} stems of ``mix`` (reference
    utils.py:330-477), the model in f32. ``pbar`` is accepted and unused."""
    model_type = model_type or bundle.model_type
    spec = _spec_for(config, model_type)
    apply_fn, dev = _apply_fn(bundle, device)
    stems = _demix(apply_fn, bundle.params, mix, spec, device=dev)
    instruments = (list(config.training.instruments) if model_type == "htdemucs"
                   else prefer_target_instrument(config))
    return {name: stems[i] for i, name in enumerate(instruments)}


def apply_tta(config, bundle: ModelBundle, mix, waveforms_orig, device=None,
              model_type: str = "") -> Dict[str, np.ndarray]:
    """Test-time augmentation over the dict-of-stems form (reference
    utils.py:241-292): channel swap and polarity inversion, averaged."""
    model_type = model_type or bundle.model_type
    spec = _spec_for(config, model_type)
    apply_fn, dev = _apply_fn(bundle, device)
    names = list(waveforms_orig)
    stems = np.stack([np.asarray(waveforms_orig[n]) for n in names])
    stems = _apply_tta(apply_fn, bundle.params, np.asarray(mix), stems, spec, device=dev)
    return {n: stems[i] for i, n in enumerate(names)}
