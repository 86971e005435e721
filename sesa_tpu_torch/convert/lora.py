"""LoRA checkpoints: adapters merged into the base weights at load time
(counterpart of sesa_tpu/convert/lora.py).

The reference binds loralib MergedLinear modules into the model and loads
the adapter's weights non-strictly (reference utils.py:561-671). For
inference the adapters merge exactly: W' = W + scaling·(B·A), with
MergedLinear's ``enable_lora`` routing when only some of the fused output
blocks (q and v of a qkv projection, say) carry adapters.

The merge is load-time host code: its products run in numpy f32, as the JAX
package's do, so that a merged checkpoint is the same to the bit in both
packages. It takes tensors or numpy arrays and returns tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


def _f32(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v, dtype=np.float32)


def merge_lora(base: Dict, lora: Dict, r: Optional[int] = None, lora_alpha: int = 1,
               enable_lora: Optional[Sequence[bool]] = None) -> Dict[str, torch.Tensor]:
    """A new state dict with the LoRA deltas merged into the base weights.

    ``lora`` holds ``<prefix>.lora_A`` (r·k, in) and ``<prefix>.lora_B``
    (out_enabled, r) pairs for weights named ``<prefix>.weight``; a pair
    whose weight the base lacks is skipped. Every other key of ``lora`` that
    the base has overrides the base value (the reference loads the adapter
    with strict=False). Raises ``ValueError`` when a pair cannot form a
    plain delta of its weight's shape (a MergedLinear adapter loaded
    without its ``enable_lora``).
    """
    merged = {k: torch.as_tensor(v) for k, v in base.items()}
    for key in lora:
        if not key.endswith(".lora_A"):
            continue
        prefix = key[: -len(".lora_A")]
        wkey = f"{prefix}.weight"
        if wkey not in merged:
            continue
        a, b, w = _f32(lora[key]), _f32(lora[f"{prefix}.lora_B"]), _f32(merged[wkey])

        n_en = sum(enable_lora) if enable_lora else 1
        rank = r or a.shape[0] // n_en
        scaling = lora_alpha / rank

        if enable_lora is not None and len(enable_lora) > 1:
            # loralib's MergedLinear (any pattern, all-True included) stacks A
            # as (n_en·r, in) and B as (n_en·block, r): the fused output splits
            # into len(enable_lora) equal blocks and only the enabled ones get
            # a delta; a plain B·A does not even have the right shape
            block = w.shape[0] // len(enable_lora)
            a_blocks = a.reshape(n_en, rank, -1)
            b_blocks = b.reshape(n_en, block, rank)
            w = w.copy()
            bi = 0
            for blk, en in enumerate(enable_lora):
                if en:
                    w[blk * block:(blk + 1) * block] += (b_blocks[bi] @ a_blocks[bi]) * scaling
                    bi += 1
        else:
            if b.shape[1] != a.shape[0] or (b.shape[0], a.shape[1]) != w.shape:
                raise ValueError(
                    f"LoRA pair shapes A{a.shape} / B{b.shape} do not form a {w.shape} delta "
                    f"for {prefix}: the adapter looks like a MergedLinear checkpoint; pass "
                    "the config's lora section (r / lora_alpha / enable_lora) so that the "
                    "blocks can be routed")
            w = w + (b @ a) * scaling
        merged[wkey] = torch.from_numpy(w)

    for key, value in lora.items():
        if not key.endswith((".lora_A", ".lora_B")) and key in merged:
            merged[key] = torch.as_tensor(value)
    return merged


def load_with_lora(checkpoint_path: str, lora_path: str, **kwargs) -> Dict[str, torch.Tensor]:
    """Load a base checkpoint and merge a LoRA adapter checkpoint into it;
    ``kwargs`` go to :func:`merge_lora`."""
    from sesa_tpu_torch.convert.torch_ckpt import load_torch_state_dict

    return merge_lora(load_torch_state_dict(checkpoint_path), load_torch_state_dict(lora_path),
                      **kwargs)
