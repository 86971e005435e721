"""Rotary position embeddings with rotary_embedding_torch semantics
(counterpart of sesa_tpu/ops/rope.py).

Interleaved pair convention: frequencies repeat pairwise (f0,f0,f1,f1,...)
and rotate_half maps each adjacent pair (x0, x1) -> (-x1, x0). Tables
narrower than the head dim rotate only the leading dims (partial rotary).
"""

from __future__ import annotations

import numpy as np
import torch


def default_freqs(dim_head: int, theta: float = 10000.0) -> np.ndarray:
    """Default inverse-frequency vector, shape (dim_head // 2,)."""
    return (
        1.0 / (theta ** (np.arange(0, dim_head, 2)[: dim_head // 2] / dim_head))
    ).astype(np.float32)


def rope_tables(freqs: torch.Tensor, seq_len: int):
    """cos/sin tables of shape (seq_len, dim) with interleaved pair repeat."""
    t = torch.arange(seq_len, dtype=torch.float32, device=freqs.device)
    ang = t[:, None] * freqs[None, :].float()
    ang = torch.repeat_interleave(ang, 2, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def rotate_half_interleaved(x: torch.Tensor) -> torch.Tensor:
    x2 = x.unflatten(-1, (-1, 2))
    return torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).flatten(-2)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate (..., seq, dim) by position along the second-to-last axis."""
    w = cos.shape[-1]
    if w == x.shape[-1]:
        return x * cos + rotate_half_interleaved(x) * sin
    head, rest = x[..., :w], x[..., w:]
    head = head * cos + rotate_half_interleaved(head) * sin
    return torch.cat([head, rest], dim=-1)
