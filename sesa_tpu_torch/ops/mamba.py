"""The Mamba-2 mixer's glue around the SSD scan (the steps of
sesa_tpu/models/bs_mamba2.py ``mamba2_apply`` between its in and out
projections, outside ``ssd``).

For ``zxbcdt = u @ in_proj.T`` (B, L, 2 D + 2 N + H) of d_inner D, state N
and H heads, laid out [z | x | b | c | dt]:

* ``mamba_conv``: the causal depthwise conv of the xBC columns and SiLU,
  ``dt = softplus(dt + dt_bias)`` and ``a = -exp(A_log)``, giving the scan's
  operands x·dt (B, Lp, H, P), a·dt (B, Lp, H), b and c (B, Lp, 1, N), with
  Lp = L rounded up to whole chunks and zero from L to Lp (an exact no-op for
  the scan), and x (B, L, D) for the D skip;
* ``mamba_gate_norm``: from the scan's y, x and the z columns, the gated
  RMSNorm ``(y + D·x) · SiLU(z)`` normalised over D, times ``norm_w``: the
  (B, L, D) rows the out projection reads.

``reverse=True`` is the backward direction of a bidirectional block on the
unflipped rows: the result is that of flipping zxbcdt along L, running the
forward direction and flipping the gate's rows back.

Each wrapper runs its plain PyTorch version on CPU tensors; a CUDA tensor
launches its kernel (``csrc/mamba_mixer.cu``: the JAX package leaves this
glue to XLA, so the kernels replace no Pallas kernel; both are bound by
bytes) or raises. Both versions compute in f32 and round each output to the
input dtype once. Each launch adds one to the wrapper's ``launches``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sesa_tpu_torch.ops import _build

# the conv's taps the kernel is built for (Mamba-2's d_conv)
_TAPS = 4
# the gate kernel keeps a row in a warp's registers, 8 columns a lane per 256
_GATE_MAX_D = 2048


def _widths(zxbcdt, conv_w, dt_bias):
    """(D, N, H) of the mixer from zxbcdt's columns, the conv's channels and
    the heads."""
    heads = dt_bias.shape[0]
    di = zxbcdt.shape[-1] - conv_w.shape[0] - heads
    return di, (conv_w.shape[0] - di) // 2, heads


def _swish(v):
    return v * torch.sigmoid(v)


def mamba_conv_plain(zxbcdt, conv_w, conv_b, dt_bias, a_log, reverse=False, chunk=64):
    """Plain PyTorch :func:`mamba_conv`: f32 inside, each output rounded to
    zxbcdt's dtype once."""
    bsz, l, _ = zxbcdt.shape
    di, n, heads = _widths(zxbcdt, conv_w, dt_bias)
    steps = -(-l // chunk) * chunk
    f32, dtype = torch.float32, zxbcdt.dtype
    if reverse:
        zxbcdt = torch.flip(zxbcdt, dims=[1])
    xbc = F.pad(zxbcdt[..., di:2 * di + 2 * n].to(f32), (0, 0, conv_w.shape[-1] - 1, 0))
    w = conv_w[:, 0].to(f32)
    acc = conv_b.to(f32)
    for k in range(w.shape[-1]):
        acc = acc + w[:, k] * xbc[:, k:k + l]
    xbc = _swish(acc)
    dt = F.softplus(zxbcdt[..., 2 * di + 2 * n:].to(f32) + dt_bias.to(f32))  # (B, L, H)
    x = xbc[..., :di].reshape(bsz, l, heads, di // heads)

    def out(v, steps=steps):  # contiguous, zero from L to ``steps``
        return F.pad(v, (0, 0) * (v.dim() - 2) + (0, steps - l)).to(dtype).contiguous()

    return (out(x * dt[..., None]), out(-torch.exp(a_log.to(f32)) * dt),
            out(xbc[..., None, di:di + n]), out(xbc[..., None, di + n:]),
            out(x.reshape(bsz, l, di), l))


def mamba_gate_norm_plain(y, x, zxbcdt, d, norm_w, reverse=False, eps=1e-5):
    """Plain PyTorch :func:`mamba_gate_norm`: f32 inside, the result rounded
    to y's dtype once."""
    bsz, l, di = x.shape
    heads = d.shape[0]
    f32 = torch.float32
    g = y[:, :l].to(f32) + d.to(f32)[:, None] * x.to(f32).reshape(bsz, l, heads, di // heads)
    g = g.reshape(bsz, l, di)
    if reverse:
        g = torch.flip(g, dims=[1])
    g = g * _swish(zxbcdt[..., :di].to(f32))
    g = g * torch.rsqrt(g.pow(2).mean(dim=-1, keepdim=True) + eps) * norm_w.to(f32)
    return g.to(y.dtype)


def _check(kernel, name, t, shape, dtype, aligned=True):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape``, 16-byte aligned where ``aligned`` (the kernels move 16 bytes
    at a time through their outputs and the scan's rows; the parameters are
    read value by value)."""
    if aligned:
        _build.check_tensor(kernel, name, t, shape, dtype)
    elif t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be a contiguous CUDA {dtype} tensor of shape "
                         f"{tuple(shape)}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def _dtype(kernel, t):
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{kernel}: takes f32 or bf16; got {t.dtype}")
    return t.dtype


def _heads_fit(kernel, di, heads):
    if heads < 1 or di < 1 or di % heads or (di // heads) % 8:
        raise ValueError(f"{kernel}: d_inner {di} in {heads} heads does not fit the kernel "
                         "(a head width that is a multiple of 8)")


def mamba_conv(zxbcdt, conv_w, conv_b, dt_bias, a_log, reverse=False, chunk=64):
    """The scan's operands from the in projection (module docstring).

    Args:
      zxbcdt: (B, L, 2 D + 2 N + H) in projection, [z | x | b | c | dt]
      conv_w: (D + 2 N, 1, 4) depthwise conv weight; conv_b: (D + 2 N,)
      dt_bias, a_log: (H,)
      reverse: scan step t reads row L - 1 - t
      chunk: L is padded with zeros to a multiple of it
    Returns:
      x·dt (B, Lp, H, P), a·dt (B, Lp, H), b and c (B, Lp, 1, N) and x
      (B, L, D), all contiguous in zxbcdt's dtype.
    CPU tensors run :func:`mamba_conv_plain`. CUDA tensors, all f32 or all
    bf16, launch the kernel; anything it does not take raises.
    """
    if zxbcdt.device.type == "cpu":
        return mamba_conv_plain(zxbcdt, conv_w, conv_b, dt_bias, a_log, reverse, chunk)
    kernel = "mamba_conv"
    _build.refuse_export(kernel)
    _build.refuse_autograd(kernel, zxbcdt, conv_w, conv_b, dt_bias, a_log)
    dtype = _dtype(kernel, zxbcdt)
    if zxbcdt.dim() != 3 or conv_w.dim() != 3 or dt_bias.dim() != 1:
        raise ValueError(f"{kernel}: zxbcdt {tuple(zxbcdt.shape)}, conv_w "
                         f"{tuple(conv_w.shape)}, dt_bias {tuple(dt_bias.shape)}")
    bsz, l, cols = zxbcdt.shape
    di, n, heads = _widths(zxbcdt, conv_w, dt_bias)
    _heads_fit(kernel, di, heads)
    if n < 8 or n % 8 or l < 1 or chunk < 1:
        raise ValueError(f"{kernel}: state {n} (a multiple of 8), length {l}, chunk {chunk}")
    _check(kernel, "zxbcdt", zxbcdt, (bsz, l, cols), dtype, aligned=False)
    for name, t, shape in (("conv_w", conv_w, (di + 2 * n, 1, _TAPS)),
                           ("conv_b", conv_b, (di + 2 * n,)), ("dt_bias", dt_bias, (heads,)),
                           ("A_log", a_log, (heads,))):
        _check(kernel, name, t, shape, dtype, aligned=False)
    steps = -(-l // chunk) * chunk
    new = zxbcdt.new_empty
    xdt, adt = new((bsz, steps, heads, di // heads)), new((bsz, steps, heads))
    b, c, x = new((bsz, steps, 1, n)), new((bsz, steps, 1, n)), new((bsz, l, di))
    stream = torch.cuda.current_stream(zxbcdt.device).cuda_stream
    _build.check(_build.load("mamba_mixer").sesa_mamba_conv(
        zxbcdt.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(), dt_bias.data_ptr(),
        a_log.data_ptr(), xdt.data_ptr(), adt.data_ptr(), b.data_ptr(), c.data_ptr(),
        x.data_ptr(), bsz, l, steps, cols, di, n, heads, int(reverse),
        int(dtype == torch.bfloat16), stream), "sesa_mamba_conv")
    mamba_conv.launches += 1
    return xdt, adt, b, c, x


def mamba_gate_norm(y, x, zxbcdt, d, norm_w, reverse=False, eps=1e-5):
    """The gated RMSNorm of the scan's output (module docstring).

    Args:
      y: (B, Lp, H, P) the scan's output, Lp >= L (the steps past L unread)
      x: (B, L, D) from :func:`mamba_conv`, in scan order
      zxbcdt: (B, L, C) the in projection; its first D columns are z
      d: (H,) the D skip; norm_w: (D,)
      reverse: row r reads scan step L - 1 - r of y and x
    Returns:
      (B, L, D) in y's dtype.
    CPU tensors run :func:`mamba_gate_norm_plain`. CUDA tensors, all f32 or
    all bf16, launch the kernel; anything it does not take raises.
    """
    if y.device.type == "cpu":
        return mamba_gate_norm_plain(y, x, zxbcdt, d, norm_w, reverse, eps)
    kernel = "mamba_gate_norm"
    _build.refuse_export(kernel)
    _build.refuse_autograd(kernel, y, x, zxbcdt, d, norm_w)
    dtype = _dtype(kernel, y)
    if y.dim() != 4 or x.dim() != 3 or zxbcdt.dim() != 3 or d.dim() != 1:
        raise ValueError(f"{kernel}: y {tuple(y.shape)}, x {tuple(x.shape)}, zxbcdt "
                         f"{tuple(zxbcdt.shape)}, D {tuple(d.shape)}")
    bsz, steps, heads, p = y.shape
    l, di = x.shape[1], heads * p
    _heads_fit(kernel, di, heads)
    if di > _GATE_MAX_D or not 1 <= l <= steps or zxbcdt.shape[-1] < di:
        raise ValueError(f"{kernel}: d_inner {di} (at most {_GATE_MAX_D}), length {l} of y's "
                         f"{steps} steps, zxbcdt {tuple(zxbcdt.shape)}")
    _check(kernel, "y", y, (bsz, steps, heads, p), dtype)
    _check(kernel, "x", x, (bsz, l, di), dtype)
    _check(kernel, "zxbcdt", zxbcdt, (bsz, l, zxbcdt.shape[-1]), dtype, aligned=False)
    _check(kernel, "D", d, (heads,), dtype, aligned=False)
    _check(kernel, "norm_w", norm_w, (di,), dtype, aligned=False)
    out = y.new_empty((bsz, l, di))
    stream = torch.cuda.current_stream(y.device).cuda_stream
    _build.check(_build.load("mamba_mixer").sesa_mamba_gate(
        y.data_ptr(), x.data_ptr(), zxbcdt.data_ptr(), d.data_ptr(), norm_w.data_ptr(),
        out.data_ptr(), bsz, l, steps, zxbcdt.shape[-1], di, heads, int(reverse), float(eps),
        int(dtype == torch.bfloat16), stream), "sesa_mamba_gate")
    mamba_gate_norm.launches += 1
    return out


mamba_conv.launches = 0
mamba_gate_norm.launches = 0
