"""Multichannel Wiener filtering by EM (counterpart of sesa_tpu/ops/wiener.py).

The openunmix ``filtering.wiener`` / ``expectation_maximization`` algorithm
as the reference's htdemucs output stage uses it, on all frames at once. The
contract at the boundary is the JAX one, real/imag stacked on a trailing
axis:

  targets  (T, F, C, S)      nonnegative magnitude estimates per source
  mix      (T, F, C, 2)      mixture STFT, RI
  returns  (T, F, C, 2, S)   filtered source STFTs, RI

Inside, the covariances, their closed-form 1x1 / 2x2 inverses and the gains
are complex64 tensors (the JAX package spells them out on RI pairs because
its TPU backend has no complex dtype). f32 throughout.
"""

from __future__ import annotations

import torch


def _cinv(m: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., C, C) complex matrices: closed form for C <= 2 with
    the JAX package's clamp of |det|² at 1e-30; else, as the JAX package
    does, the real 2C x 2C block matrix [[Re, -Im], [Im, Re]] inverted."""
    c = m.shape[-1]
    if c == 1:
        den = (m.real ** 2 + m.imag ** 2).clamp_min(1e-30)
        return m.conj() / den
    if c == 2:
        a, b, cc, d = m[..., 0, 0], m[..., 0, 1], m[..., 1, 0], m[..., 1, 1]
        det = a * d - b * cc
        idet = det.conj() / (det.real ** 2 + det.imag ** 2).clamp_min(1e-30)
        row0 = torch.stack([d * idet, -b * idet], dim=-1)
        row1 = torch.stack([-cc * idet, a * idet], dim=-1)
        return torch.stack([row0, row1], dim=-2)
    re, im = m.real, m.imag
    block = torch.cat([torch.cat([re, -im], dim=-1), torch.cat([im, re], dim=-1)], dim=-2)
    inv = torch.linalg.inv(block)
    return torch.complex(inv[..., :c, :c], inv[..., c:, :c])


def wiener_ri(targets: torch.Tensor, mix: torch.Tensor, niters: int, softmask: bool = False,
              residual: bool = False, scale_factor: float = 10.0,
              eps: float = 1e-10) -> torch.Tensor:
    """Multichannel Wiener EM filter in RI form (see the module docstring).

    ``niters`` EM iterations refine the initial estimates; ``niters=0``
    returns the initialisation (mix-phase magnitudes, or the soft mask when
    ``softmask``). ``residual`` appends a (mix - sum) source that joins the
    EM and is kept in the output (callers drop it, as the reference does).
    """
    targets, mix = targets.float(), mix.float()
    c = targets.shape[2]
    if softmask:
        frac = targets / (eps + targets.sum(dim=-1, keepdim=True))
        y = mix[..., None] * frac[..., None, :]  # (T, F, C, 2, S)
    else:
        ang = torch.atan2(mix[..., 1], mix[..., 0])  # (T, F, C)
        y = torch.stack([targets * torch.cos(ang)[..., None],
                         targets * torch.sin(ang)[..., None]], dim=-2)
    if residual:
        y = torch.cat([y, mix[..., None] - y.sum(dim=-1, keepdim=True)], dim=-1)
    if niters == 0:
        return y

    mag = torch.sqrt(mix[..., 0] ** 2 + mix[..., 1] ** 2)
    max_abs = torch.clamp_min(mag.max() / scale_factor, 1.0)
    mixc = torch.complex(mix[..., 0], mix[..., 1]) / max_abs  # (T, F, C)
    yc = torch.complex(y[..., 0, :], y[..., 1, :]) / max_abs  # (T, F, C, S)

    reg = (eps ** 0.5) * torch.eye(c, device=mix.device)
    for _ in range(niters):
        # PSD per source: mean over channels of |y|² -> (T, F, S)
        v = (yc.real ** 2 + yc.imag ** 2).mean(dim=-2)
        # spatial covariance per source, R_j = sum_T y_a y_b^* / (eps + sum_T v_j)
        num = torch.einsum("tfas,tfbs->fabs", yc, yc.conj())
        r = num / (eps + v.sum(dim=0))[:, None, None, :]  # (F, C, C, S)
        # mixture covariance (T, F, C, C), regularised on the diagonal
        cxx = torch.einsum("tfs,fabs->tfab", v.to(r.dtype), r) + reg
        inv_cxx = _cinv(cxx)
        # gain_j = v_j R_j Cxx⁻¹; y_j = gain_j mix
        gain = torch.einsum("fabs,tfbc->stfac", r, inv_cxx)
        gain = gain * v.permute(2, 0, 1)[..., None, None]
        yc = torch.einsum("stfac,tfc->tfas", gain, mixc)

    return torch.stack([yc.real, yc.imag], dim=-2) * max_abs
