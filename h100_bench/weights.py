"""A state dict in the published checkpoint's layout, made on the device
from the seed.

One uniform draw on the device covers every drawn leaf; each leaf is a view
of it, scaled as torch's ``nn.Linear`` draws its weight and bias (uniform
within ±1/sqrt(fan_in)); RMSNorm scales are drawn in [0.8, 1.2] rather than
left at one, so a transposed or misplaced scale shows; rotary frequencies
take rotary_embedding_torch's fixed values. The same seed gives the same
dict, so the check can make it again after the window instead of holding it.
"""

from __future__ import annotations

import torch

from h100_bench.models._roformer import rope_freqs


def make_state_dict(layout, seed: int, device) -> dict:
    """{key: f32 tensor on ``device``} for ``layout`` [(key, shape, kind, fan_in)]."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & ((1 << 63) - 1))
    sizes = [torch.Size(shape).numel() for _, shape, kind, _ in layout if kind != "rope"]
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    sd, off = {}, 0
    with torch.no_grad():
        for key, shape, kind, fan_in in layout:
            if kind == "rope":
                sd[key] = torch.as_tensor(rope_freqs(2 * shape[0]), dtype=torch.float32,
                                          device=device)
                continue
            n = torch.Size(shape).numel()
            u = flat[off:off + n].view(shape)
            off += n
            if kind == "gamma":
                u.mul_(0.4).add_(0.8)
            else:
                u.mul_(2.0).sub_(1.0).mul_(fan_in ** -0.5)
            sd[key] = u
    return sd
