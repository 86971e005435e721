"""The Mamba-2 mixer's steps around the scan (``ops/mamba.py``) on the CPU:
the plain versions against the PyTorch sequence they replace and against the
JAX package, their reversed direction, their rounding points, and the
wrappers' refusals and launch counts."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from sesa_tpu.models import bs_mamba2 as jax_mamba
from sesa_tpu_torch.models import bs_mamba2
from sesa_tpu_torch.ops.mamba import (mamba_conv, mamba_conv_plain, mamba_gate_norm,
                                      mamba_gate_norm_plain)
from sesa_tpu_torch.tree import tree_map


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(d_model, seed):
    """mamba2_init's tree with every leaf moved off its init value, and
    A_log spread so that some heads decay slowly."""
    gen = torch.Generator().manual_seed(seed)
    p = bs_mamba2.mamba2_init(gen, d_model)
    p = tree_map(lambda v: v + 0.1 * torch.randn(v.shape, generator=gen), p)
    p["A_log"] = torch.linspace(-4.0, 2.0, p["A_log"].shape[0])
    return p


def _zxbcdt(p, bsz, length, seed):
    u = torch.randn(bsz, length, p["in_proj"].shape[1],
                    generator=torch.Generator().manual_seed(seed)) * 0.5
    return u, u @ p["in_proj"].T


def _todays_operands(p, zxbcdt):
    """The sequence mamba2_apply ran before the mixer's kernels: a left-padded
    grouped conv, SiLU, F.pad of x, b, c and dt to whole chunks of 64."""
    bsz, l, _ = zxbcdt.shape
    heads = p["dt_bias"].shape[0]
    di = 64 * heads
    xbc = zxbcdt[..., di:-heads]
    dt = F.softplus(zxbcdt[..., -heads:] + p["dt_bias"])
    xbc = F.conv1d(F.pad(xbc.transpose(1, 2), (3, 0)), p["conv_w"], p["conv_b"],
                   groups=xbc.shape[-1]).transpose(1, 2)
    xbc = xbc * torch.sigmoid(xbc)
    x = xbc[..., :di].reshape(bsz, l, heads, 64)
    b, c = xbc[..., None, di:di + 128], xbc[..., None, di + 128:]
    lpad = -l % 64
    xs = F.pad(x, (0, 0, 0, 0, 0, lpad))
    b, c = (F.pad(t, (0, 0, 0, 0, 0, lpad)) for t in (b, c))
    dt = F.pad(dt, (0, 0, 0, lpad))
    return xs * dt[..., None], -torch.exp(p["A_log"]) * dt, b, c, x.reshape(bsz, l, di)


@pytest.mark.parametrize("length", [57, 64, 70, 690])
def test_plain_conv_gives_todays_operands(length):
    """At the published widths (d_model 128: 8 heads x 64, state 128), the
    lengths of band_comm (57) and band_rnn (690), one chunk and a ragged
    second chunk: the operands are today's, zero from L to the chunk."""
    p = _params(128, length)
    _, zxbcdt = _zxbcdt(p, 2, length, length + 1)
    got = mamba_conv_plain(zxbcdt, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"])
    want = _todays_operands(p, zxbcdt)
    steps = -(-length // 64) * 64
    for name, g, w in zip(("x·dt", "a·dt", "b", "c", "x"), got, want):
        assert g.shape == w.shape and g.is_contiguous(), name
        torch.testing.assert_close(g, w, atol=2e-6, rtol=1e-5, msg=name)
        if name != "x" and steps > length:
            assert not g[:, length:].any(), name
    assert got[0].shape == (2, steps, 8, 64) and got[2].shape == (2, steps, 1, 128)


@pytest.mark.parametrize("step", ["conv", "gate", "mamba2_apply"])
def test_reverse_is_flip_apply_flip(step):
    """``reverse=True`` on the plain path equals flipping along L, the
    forward direction, and flipping the rows back (the scan's operands and x
    stay in scan order)."""
    p = _params(32, 3)
    length = 70
    u, zxbcdt = _zxbcdt(p, 2, length, 4)
    flipped = torch.flip(zxbcdt, dims=[1])
    args = (p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"])
    if step == "conv":
        for g, w in zip(mamba_conv_plain(zxbcdt, *args, reverse=True),
                        mamba_conv_plain(flipped, *args)):
            assert torch.equal(g, w)
    elif step == "gate":
        y = torch.randn(2, 128, 2, 64, generator=torch.Generator().manual_seed(5))
        x = torch.randn(2, length, 128, generator=torch.Generator().manual_seed(6))
        got = mamba_gate_norm_plain(y, x, zxbcdt, p["D"], p["norm_w"], reverse=True)
        want = torch.flip(mamba_gate_norm_plain(y, x, flipped, p["D"], p["norm_w"]), dims=[1])
        assert torch.equal(got, want)
    else:
        got = bs_mamba2.mamba2_apply(p, u, reverse=True)
        want = torch.flip(bs_mamba2.mamba2_apply(p, torch.flip(u, dims=[1])), dims=[1])
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_mamba_block_apply_matches_jax():
    """Both directions, the backward one read in reverse in place of
    flipped, against the JAX block at the f32 tolerance of
    tests/test_torch_bs_mamba2.py, over two chunks (the second ragged)."""
    length = 70
    gen = np.random.default_rng(length)
    jp = jax.tree.map(lambda v: jnp.asarray(
        np.asarray(v) + 0.1 * gen.standard_normal(np.shape(v)).astype(np.float32)),
        jax_mamba._res_mamba_init(jax.random.PRNGKey(1), 32)["mamba"])
    x = gen.standard_normal((2, length, 32)).astype(np.float32) * 0.3
    ref = np.asarray(jax_mamba.mamba_block_apply(jp, jnp.asarray(x)))
    p = tree_map(lambda v: torch.from_numpy(np.array(v, dtype=np.float32)),
                 jax.tree.map(np.asarray, jp))
    got = bs_mamba2.mamba_block_apply(p, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("step", ["conv", "gate"])
def test_plain_rounds_each_output_once(step):
    """In bf16 each output is the f32 computation on the same (bf16) values,
    rounded once: the kernels' rounding points."""
    p = _params(32, 7)
    _, zxbcdt = _zxbcdt(p, 2, 57, 8)
    bf = tree_map(lambda v: v.to(torch.bfloat16), p)
    zb = zxbcdt.to(torch.bfloat16)
    up = tree_map(lambda v: v.float(), bf)
    if step == "conv":
        args = ("conv_w", "conv_b", "dt_bias", "A_log")
        got = mamba_conv_plain(zb, *(bf[k] for k in args), reverse=True)
        want = mamba_conv_plain(zb.float(), *(up[k] for k in args), reverse=True)
    else:
        y = torch.randn(2, 64, 2, 64, generator=torch.Generator().manual_seed(9))
        x = torch.randn(2, 57, 128, generator=torch.Generator().manual_seed(10))
        yb, xb = y.to(torch.bfloat16), x.to(torch.bfloat16)
        got = [mamba_gate_norm_plain(yb, xb, zb, bf["D"], bf["norm_w"], reverse=True)]
        want = [mamba_gate_norm_plain(yb.float(), xb.float(), zb.float(), up["D"],
                                      up["norm_w"], reverse=True)]
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w.to(torch.bfloat16))


def test_launch_counters_are_ints_a_cpu_call_leaves():
    p = _params(32, 11)
    u, zxbcdt = _zxbcdt(p, 1, 64, 12)
    before = (mamba_conv.launches, mamba_gate_norm.launches)
    assert all(isinstance(n, int) for n in before)
    ops = mamba_conv(zxbcdt, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"])
    mamba_gate_norm(ops[0], ops[4], zxbcdt, p["D"], p["norm_w"])
    bs_mamba2.mamba_block_apply({"forward": p, "backward": p}, u)
    assert (mamba_conv.launches, mamba_gate_norm.launches) == before


class _Fake:
    """A tensor that claims to be on a CUDA device; no storage is touched."""

    requires_grad = False

    def __init__(self, shape, dtype=torch.bfloat16, contiguous=True):
        self.shape, self.dtype, self.device = torch.Size(shape), dtype, torch.device("cuda")
        self._contiguous = contiguous

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return self._contiguous

    def data_ptr(self):
        return 0


# each wrapper's arguments at the published widths (band_comm's 6 x 57 rows)
_SHAPES = {
    "conv": dict(zxbcdt=(6, 57, 1288), conv_w=(768, 1, 4), conv_b=(768,), dt_bias=(8,),
                 A_log=(8,)),
    "gate": dict(y=(6, 64, 8, 64), x=(6, 57, 512), zxbcdt=(6, 57, 1288), D=(8,),
                 norm_w=(512,)),
}


def _fakes(step, change):
    """The step's arguments as bf16 fakes, one changed: (name, a shape, a
    dtype, or False for a tensor that is not contiguous)."""
    name, what = change
    out = []
    for k, shape in _SHAPES[step].items():
        mine = k == name
        out.append(_Fake(what if mine and isinstance(what, tuple) else shape,
                         what if mine and isinstance(what, torch.dtype) else torch.bfloat16,
                         what if mine and isinstance(what, bool) else True))
    return out


@pytest.mark.parametrize("step,change", [
    ("conv", ("zxbcdt", torch.float16)),          # neither f32 nor bf16
    ("conv", ("conv_w", torch.float32)),          # a parameter in another dtype
    ("conv", ("conv_w", (768, 1, 3))),            # 3 taps: the kernel is built for 4
    ("conv", ("zxbcdt", (6, 57, 1292))),          # columns that fit no head width of 64
    ("conv", ("dt_bias", (6,))),                  # 6 heads of 512 + 4 columns
    ("conv", ("A_log", (4,))),                    # A_log not one a head
    ("conv", ("zxbcdt", False)),                  # rows not contiguous
    ("gate", ("y", torch.float16)),
    ("gate", ("norm_w", torch.float32)),
    ("gate", ("y", (6, 56, 8, 64))),              # fewer scan steps than rows
    ("gate", ("y", (6, 64, 8, 12))),              # head width not a multiple of 8
    ("gate", ("y", (6, 64, 64, 64))),             # d_inner 4096, over a warp's row
    ("gate", ("x", (6, 57, 256))),                # x not y's width
    ("gate", ("D", (4,))),
    ("gate", ("y", False)),
])
def test_wrappers_refuse_what_their_kernels_do_not_take(step, change):
    """Asked of tensors that claim to be on a CUDA device, each wrapper
    raises before it would launch."""
    with torch.no_grad(), pytest.raises(ValueError, match=f"mamba_{step}"):
        (mamba_conv if step == "conv" else mamba_gate_norm)(*_fakes(step, change))
