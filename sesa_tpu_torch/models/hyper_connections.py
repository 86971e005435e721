"""Hyper-connections: learned multi-stream residuals, arXiv 2409.19606
(counterpart of sesa_tpu/models/hyper_connections.py).

Each wrapped branch (attention or feed-forward) reads a learned mixture of
``S`` residual streams and writes its output back into every stream with
learned depth weights:

    r        : (b, n, S, d)           residual streams
    normed   = rmsnorm(r)             (zero-init gamma, +1 offset)
    alpha    = tanh(normed @ Wa) * sa + static_alpha   # (b, n, S, S+1)
    beta     = tanh(normed @ Wb) * sb + static_beta    # (b, n, S)
    mix      = einsum('b n s t, b n s d -> b n t d', alpha, r)
    branch_in, r' = mix[..., 0, :], mix[..., 1:, :]
    out      = branch(branch_in)
    r''      = r' + out[..., None, :] * beta[..., None]

Stream folding follows the reference package's einops patterns:
``expand = repeat('b ... -> (b s) ...')``, ``reduce = reduce('(b s) ... ->
b ...', 'sum')`` and inside the wrapper ``rearrange('(b s) n d -> b n s d')``.
Inside the packed axial stages the leading dim is (batch·streams·bands), so
the '(b s)' split reproduces the reference's grouping rather than a clean
stream axis.

State-dict layout per wrapped module: ``branch.*`` plus ``norm.gamma``,
``static_alpha`` (S, S+1), ``static_beta`` (S,), ``dynamic_alpha_fn``
(d, S+1), ``dynamic_alpha_scale`` (), ``dynamic_beta_fn`` (d,),
``dynamic_beta_scale`` ().
"""

from __future__ import annotations

import torch


def expand_streams(x: torch.Tensor, streams: int) -> torch.Tensor:
    """repeat 'b ... -> (b s) ...' (identity for streams == 1)."""
    if streams == 1:
        return x
    return x.repeat_interleave(streams, dim=0)


def reduce_streams(x: torch.Tensor, streams: int) -> torch.Tensor:
    """reduce '(b s) ... -> b ...' sum (identity for streams == 1)."""
    if streams == 1:
        return x
    return x.reshape((x.shape[0] // streams, streams) + x.shape[1:]).sum(dim=1)


def hc_init(generator, dim: int, streams: int, layer_index: int):
    """Parameters of one HyperConnections wrapper (branch excluded); the
    init is deterministic, as the reference package's."""
    del generator
    alpha0 = torch.zeros((streams, 1))
    alpha0[layer_index % streams, 0] = 1.0
    return {
        "norm_gamma": torch.zeros(dim),
        "static_alpha": torch.cat([alpha0, torch.eye(streams)], dim=1),
        "static_beta": torch.ones(streams),
        "dynamic_alpha_fn": torch.zeros((dim, streams + 1)),
        "dynamic_alpha_scale": torch.tensor(1e-2),
        "dynamic_beta_fn": torch.zeros(dim),
        "dynamic_beta_scale": torch.tensor(1e-2),
    }


def _hc_norm(x, gamma):
    scale = x.shape[-1] ** 0.5
    n = x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + 1e-12)
    return n * scale * (gamma + 1.0)


def hc_width(p, x: torch.Tensor, streams: int):
    """x ((b s), n, d) -> branch_in (b, n, d), residuals (b, n, s, d), beta
    (b, n, s).

    The norm and the dynamic alpha and beta run on x where it lies, as
    (b, s, n, d), and the two dynamic products are one product against
    [Wa | Wb]: on the (b, n, s, d) view of the JAX package's formulation
    every elementwise pass over the streams is a strided one on the card and
    the products go to a slow batched kernel. The values are the same.
    """
    bs, n, d = x.shape
    r = x.reshape(bs // streams, streams, n, d)  # (b, s, n, d)
    normed = _hc_norm(r, p["norm_gamma"])
    w = torch.cat([p["dynamic_alpha_fn"], p["dynamic_beta_fn"][:, None]], dim=1)
    dyn = torch.tanh(normed.reshape(-1, d) @ w).reshape(r.shape[:3] + (streams + 2,))
    alpha = dyn[..., :-1] * p["dynamic_alpha_scale"] + p["static_alpha"][:, None, :]
    beta = dyn[..., -1] * p["dynamic_beta_scale"] + p["static_beta"][:, None]  # (b, s, n)
    # mix[b, n, t, :] = sum_s alpha[b, s, n, t] * r[b, s, n, :]
    mix = alpha.permute(0, 2, 3, 1) @ r.permute(0, 2, 1, 3)  # (b, n, s+1, d)
    return mix[..., 0, :], mix[..., 1:, :], beta.permute(0, 2, 1)


def hc_depth(branch_out: torch.Tensor, residuals: torch.Tensor, beta: torch.Tensor):
    """Write the branch output into every stream; back to ((b s), n, d)."""
    r = residuals + branch_out[..., None, :] * beta[..., None]
    b, n, s, d = r.shape
    return r.permute(0, 2, 1, 3).reshape(b * s, n, d)


def hc_apply(p, x: torch.Tensor, streams: int, branch_fn):
    """Full wrapper: branch_fn (b, n, d) -> (b, n, d) or (out, extras)."""
    branch_in, residuals, beta = hc_width(p, x, streams)
    out = branch_fn(branch_in)
    extras = None
    if isinstance(out, tuple):
        out, *extras = out
    x = hc_depth(out, residuals, beta)
    if extras:
        return (x, *extras)
    return x


def hc_convert(take, prefix: str):
    """Read one wrapper's params from a torch state_dict accessor."""
    return {
        "norm_gamma": take(f"{prefix}.norm.gamma"),
        "static_alpha": take(f"{prefix}.static_alpha"),
        "static_beta": take(f"{prefix}.static_beta"),
        "dynamic_alpha_fn": take(f"{prefix}.dynamic_alpha_fn"),
        "dynamic_alpha_scale": take(f"{prefix}.dynamic_alpha_scale"),
        "dynamic_beta_fn": take(f"{prefix}.dynamic_beta_fn"),
        "dynamic_beta_scale": take(f"{prefix}.dynamic_beta_scale"),
    }
