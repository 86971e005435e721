"""The port's per-kernel choices on the CPU, with no card: the conformer
block's (K2, K4, K5) and Apollo's (K6, K7), called with "cuda" and bf16 over
grids of shapes. Every kernel a choice admits is one whose wrapper takes the
shape, and each wrapper raises on a non-CPU tensor exactly where its shape
predicate refuses: meta tensors carry the shapes into the wrappers, which
then stop at the device check that follows the shape checks. And the gates
of the JAX package's kernels K1 and K3 to K8, asked as on a TPU: every shape
they send to a Pallas kernel is one the port's kernel takes (K5 at any
number of taps, K7 at every Apollo width, K8 at every (P, N, chunk))."""

import itertools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sesa_tpu.models import apollo as jax_apollo
from sesa_tpu.ops import attention as jax_attention
from sesa_tpu.ops import convblock as jax_convblock
from sesa_tpu_torch.models import apollo
from sesa_tpu_torch.models import conformer_core as cc
from sesa_tpu_torch.ops.attention import (attention_block_shape_ok, conformer_attention_shape_ok,
                                          fused_attention_block, fused_conformer_attention,
                                          fused_rope_attention, k7_plan, use_fused_attention,
                                          use_vmem_attention, vmem_attention)
from sesa_tpu_torch.ops.convblock import (apollo_conv_shape_ok, conformer_conv_shape_ok,
                                          fused_apollo_conv, fused_conformer_conv)
from sesa_tpu_torch.ops.ff import ff_shape_ok, fused_ff_residual

BF16 = torch.bfloat16
META = torch.device("meta")
DIM_HEADS = (8, 16, 32, 48, 64, 128)
KERNELS = (3, 7, 31, 32, 33)


def _takes(fn, *args, **kwargs):
    """True if the wrapper's shape checks pass (it then refuses the meta
    device, or finds no card), False if they refuse the shape."""
    try:
        fn(*args, **kwargs)
    except ValueError as e:
        if "unsupported" in str(e):
            return False
        assert "CUDA" in str(e), e
    except (RuntimeError, AssertionError):  # no card for the device query
        pass
    return True


def _conformer_grid():
    """(batch, n, dim, heads, conv expansion, k): the mel-band conformer's
    legs and the edges of every predicate."""
    return itertools.product((1, 360, 4140), (1, 60, 690, 2048, 2049), (64, 96, 384),
                             (1, 2, 4, 8), (1, 2), KERNELS)


@pytest.mark.parametrize("dim_head", DIM_HEADS)
def test_conformer_choice_admits_only_what_the_wrappers_take(dim_head):
    """Each kernel the choice admits passes its wrapper's predicate; where the
    TPU's block gate admits the shape, the choice is exactly the kernels
    whose predicates pass; the CPU and f32 take none."""
    for batch, n, dim, heads, mult, k in _conformer_grid():
        hidden, e = 4 * dim, mult * dim
        got = cc.conformer_kernels("cuda", BF16, batch, n, dim, heads, dim_head, hidden, e, k)
        want = {"K2": ff_shape_ok(batch * n, dim, hidden),
                "K4": conformer_attention_shape_ok(batch, n, dim, heads, dim_head),
                "K5": conformer_conv_shape_ok(batch, n, dim, e, k)}
        assert got <= {name for name, ok in want.items() if ok}
        if cc.fused_conformer_shape_ok(n, dim_head, dim):
            assert got == {name for name, ok in want.items() if ok}
        else:
            assert not got
        for device, dtype in (("cpu", BF16), ("cuda", torch.float32)):
            assert not cc.conformer_kernels(device, dtype, batch, n, dim, heads, dim_head,
                                            hidden, e, k)


def test_conformer_choice_at_the_off_grid_shapes():
    """The shapes that raised before the per-kernel choice: dim_head 48
    (heads 8) runs all three, K4 on heads padded to 64; conv kernel 33 all
    three (K5 in two blocks of taps, unfused before K5 took any number of
    taps); the mel-band conformer's defaults all three."""
    legs = ((360, 690), (4140, 60))
    for batch, n in legs:
        assert cc.conformer_kernels("cuda", BF16, batch, n, 384, 8, 48, 1536, 768, 31) == {
            "K2", "K4", "K5"}
        assert cc.conformer_kernels("cuda", BF16, batch, n, 384, 8, 64, 1536, 768, 33) == {
            "K2", "K4", "K5"}
        assert cc.conformer_kernels("cuda", BF16, batch, n, 384, 8, 64, 1536, 768, 31) == {
            "K2", "K4", "K5"}


@pytest.mark.parametrize("dim_head", DIM_HEADS)
def test_conformer_wrappers_raise_exactly_where_their_predicates_refuse(dim_head):
    """K2, K4 and K5 on meta tensors of the grid's shapes (one sequence
    count: the wrappers' launch limits are arithmetic on it)."""
    for n, dim, heads, mult, k in itertools.product((1, 60, 690), (64, 96, 384), (1, 2, 8),
                                                    (1, 2), KERNELS):
        batch, hidden, e, hd = 3, 4 * dim, mult * dim, heads * dim_head
        x = torch.empty((batch, n, dim), device=META, dtype=BF16)
        w = lambda *s: torch.empty(s, device=META, dtype=BF16)  # noqa: E731
        assert _takes(fused_ff_residual, x.reshape(-1, dim), w(dim), w(hidden, dim), w(hidden),
                      w(dim, hidden), w(dim), beta=w(dim), norm="ln", act="swish",
                      out_scale=0.5) == ff_shape_ok(batch * n, dim, hidden)
        assert _takes(fused_conformer_attention, x, w(dim), w(dim), w(3 * hd, dim),
                      w(2 * 16 + 1, dim_head), w(dim, hd), w(dim), heads) == \
            conformer_attention_shape_ok(batch, n, dim, heads, dim_head)
        conv = {"norm": {"weight": w(dim), "bias": w(dim)},
                "pw1": {"weight": w(2 * e, dim, 1), "bias": w(2 * e)},
                "dw": {"weight": w(e, 1, k), "bias": w(e)},
                "bn": {"weight": w(e), "bias": w(e), "running_mean": w(e), "running_var": w(e)},
                "pw2": {"weight": w(dim, e, 1), "bias": w(dim)}}
        assert _takes(fused_conformer_conv, x, conv) == conformer_conv_shape_ok(batch, n, dim, e,
                                                                                k)


# Apollo's widths: NUM_HEAD 8, so dim_head = feature_dim / 8
FEATURE_DIMS = (64, 128, 256, 384, 512, 768, 1024)


@pytest.mark.parametrize("feature_dim", FEATURE_DIMS)
def test_apollo_choice_admits_only_what_the_wrappers_take(feature_dim):
    """At the CLI's chunks (2 x stereo rows of 1901 frames, 80 bands) and a
    short input: K7 exactly where k7_plan plans the band layer, K6 exactly
    where its predicate takes the ICB; K7 and K6 also through their wrappers
    on meta tensors; the CPU runs both wrappers' plain versions, f32 none."""
    dh = feature_dim // apollo.NUM_HEAD
    for rows, frames in ((4, 1901), (2, 33)):
        got = apollo.apollo_kernels("cuda", BF16, rows, frames, 80, feature_dim)
        k7 = k7_plan(rows * frames, 80, apollo.NUM_HEAD, dh, dh) is not None
        k6 = apollo_conv_shape_ok(rows * 80 * frames, feature_dim, 4 * feature_dim, 7)
        assert got == {name for name, ok in (("K7", k7), ("K6", k6)) if ok}
        qkv = torch.empty((rows * frames, 80, 3 * feature_dim), device=META, dtype=BF16)
        rope = tuple(torch.empty((80, dh), device=META, dtype=BF16) for _ in range(2))
        assert _takes(fused_rope_attention, qkv, apollo.NUM_HEAD, dh ** -0.5, rope) == k7
        w = lambda *s: torch.empty(s, device=META, dtype=BF16)  # noqa: E731
        blk = {"dw_w": w(feature_dim, 1, 7), "dw_b": w(feature_dim), "norm": w(feature_dim),
               "pw1_w": w(4 * feature_dim, feature_dim), "pw1_b": w(4 * feature_dim),
               "pw2_w": w(feature_dim, 4 * feature_dim), "pw2_b": w(feature_dim)}
        z = torch.empty((rows * 80, frames, feature_dim), device=META, dtype=BF16)
        assert _takes(fused_apollo_conv, z, blk) == k6
        assert apollo.apollo_kernels("cpu", BF16, rows, frames, 80, feature_dim) == {"K6", "K7"}
        assert not apollo.apollo_kernels("cuda", torch.float32, rows, frames, 80, feature_dim)


def test_apollo_choice_at_the_off_grid_widths():
    """The widths that raised before the choice: 384 runs K7 at dim_head 48
    and K6; 768 and 1024 run K7 at dim_head 96 and 128 and K6 at d 768 and
    1024; 64 (dim_head 8, unfused before K7 took every head width) both, K7
    at heads of 8 run at the 16-wide instance; 200 (dim_head 25, rope 24) K7
    on heads padded to 32 with K6 refused (d % 64); 320 (dim_head 40)
    both."""
    want = {64: {"K6", "K7"}, 200: {"K7"}, 256: {"K6", "K7"}, 320: {"K6", "K7"},
            384: {"K6", "K7"}, 768: {"K6", "K7"}, 1024: {"K6", "K7"}}
    for feature_dim, kernels in want.items():
        assert apollo.apollo_kernels("cuda", BF16, 4, 1901, 80, feature_dim) == kernels


# --------------------------------------------------------------------------
# the JAX package's gates, asked as on a TPU, against the port's predicates
# --------------------------------------------------------------------------

@pytest.fixture
def on_tpu(monkeypatch):
    """The JAX gates with jax.devices reporting a TPU and no kill switch set;
    nothing under sesa_tpu changes."""
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [types.SimpleNamespace(platform="tpu")])
    for knob in ("SESA_NO_FUSED", "SESA_NO_FUSED_CONV", "SESA_INT8_ATTN"):
        monkeypatch.delenv(knob, raising=False)


class _Fake:
    """A tensor's device, dtype and shape, with no storage."""

    def __init__(self, shape, dtype=BF16, device="cuda"):
        self.shape, self.dtype, self.device = torch.Size(shape), dtype, torch.device(device)
        self.ndim = len(shape)

    def numel(self):
        return int(np.prod(self.shape))


# the legs' lengths (62 and 60 bands, 690 frames, Apollo's 1901) and the edges
# of the gates from 8 to 2048
SEQS = (1, 7, 8, 9, 60, 62, 63, 64, 65, 129, 255, 256, 257, 690, 1000, 1901, 2048, 2049)
HEADS = (1, 2, 3, 4, 5, 7, 8, 12, 16)
DIMS = (64, 96, 128, 192, 384, 512, 640, 768, 1024, 1088)
BATCHES = (1, 360, 4140)


@pytest.mark.parametrize("dim_head", range(8, 129, 8))
def test_port_takes_every_attention_block_the_jax_gate_fuses(on_tpu, dim_head):
    """K1 and K4 share the JAX gate ``_use_fused`` (the roformer's block,
    sesa_tpu/models/roformer_core.py:168 and :305, and the conformer's,
    conformer_core.py:172-178): every (n, dim_head, heads, d) it fuses in bf16
    is one both port predicates take, at each sequence count, and the
    roformer's choice and K1's wrapper with it."""
    fused = 0
    for n, heads, d in itertools.product(SEQS, HEADS, DIMS):
        if not jax_attention._use_fused(n, dim_head, heads, d, dtype=jnp.bfloat16):
            continue
        fused += 1
        for b in BATCHES:
            assert attention_block_shape_ok(b, n, d, heads, dim_head), (b, n, d, heads, dim_head)
            assert conformer_attention_shape_ok(b, n, d, heads, dim_head), (b, n, d, heads,
                                                                           dim_head)
        assert use_fused_attention(_Fake((BATCHES[-1], n, d)), heads, dim_head)
        assert cc.fused_conformer_shape_ok(n, dim_head, d)
    assert fused  # the grid reaches the gate


def test_attention_block_wrappers_raise_exactly_where_their_predicates_refuse():
    """K1 and K4 on meta tensors across the head widths, the padded ones
    among them: past the shape checks they stop at the device check."""
    for n, d, heads, dh in itertools.product((1, 62, 690), (64, 96, 384), (1, 3, 8),
                                             (8, 24, 48, 96, 120, 128, 136)):
        x = torch.empty((3, n, d), device=META, dtype=BF16)
        w = lambda *s: torch.empty(s, device=META, dtype=BF16)  # noqa: E731
        hd = heads * dh
        assert _takes(fused_attention_block, x, w(d), w(3 * hd, d), w(heads, d), w(heads),
                      w(d, hd), heads, dh ** -0.5) == attention_block_shape_ok(3, n, d, heads, dh)
        assert _takes(fused_conformer_attention, x, w(d), w(d), w(3 * hd, d), w(33, dh),
                      w(d, hd), w(d), heads) == conformer_attention_shape_ok(3, n, d, heads, dh)


def test_port_takes_every_whole_sequence_attention_the_jax_gate_fuses(on_tpu):
    """K3's JAX gate ``_use_pallas`` (sesa_tpu/ops/attention.py:203-221): every
    (S, D) it sends to the Pallas kernel in bf16 is one the port's gate and
    wrapper take."""
    fused = 0
    for s, d in itertools.product(SEQS, range(1, 136)):
        if not jax_attention._use_pallas(s, d, dtype=jnp.bfloat16):
            continue
        fused += 1
        t = _Fake((2, 8, s, d))
        assert use_vmem_attention(t, t, t), (s, d)
        q = torch.empty((2, 8, s, d), device=META, dtype=BF16)
        assert _takes(vmem_attention, q, q, q, d ** -0.5), (s, d)
    assert fused


@pytest.mark.parametrize("d", range(64, 1153, 64))
def test_port_takes_every_apollo_block_the_jax_gate_fuses(on_tpu, d):
    """K6's JAX gate ``use_fused_conv`` at Apollo's hidden width 4d
    (sesa_tpu/models/apollo.py:222-229): every (n, d) it fuses in bf16 is one
    the port's predicate takes at Apollo's kernel of 7 taps, and Apollo's
    choice at (rows, n frames, 80 bands) takes K6."""
    for n in SEQS:
        x = jax.ShapeDtypeStruct((320, n, d), jnp.bfloat16)
        if not jax_convblock.use_fused_conv(x, 4 * d):
            continue
        assert apollo_conv_shape_ok(320 * n, d, 4 * d, 7), (n, d)
        assert "K6" in apollo.apollo_kernels("cuda", BF16, 4, n, 80, d), (n, d)


# the conformer conv's taps: every count to 33, and past 32 in one, two, four
# and eight register blocks
CONV_TAPS = tuple(range(1, 34)) + (64, 65, 129, 257)


@pytest.mark.parametrize("k", CONV_TAPS)
def test_port_takes_every_conformer_conv_the_jax_gate_fuses(on_tpu, k):
    """K5's JAX gate ``use_fused_conv`` at the conformer's conv width 2e
    (sesa_tpu/ops/convblock.py:250-265, called at
    sesa_tpu/models/conformer_core.py:211 inside the fused block): every
    (b, n, d, e) it fuses in bf16 at k taps is one the port's predicate and
    K5's wrapper (on meta tensors) take, and where the JAX block gate fuses
    too the conformer's choice runs K5."""
    fused = 0
    for n, d, e in itertools.product(SEQS, (128, 256, 384, 512, 1024),
                                     (128, 256, 384, 768, 1536, 2048, 2176)):
        if not jax_convblock.use_fused_conv(jax.ShapeDtypeStruct((3, n, d), jnp.bfloat16), 2 * e):
            continue
        fused += 1
        heads = d // 64
        block = (jax_attention._use_fused(n, 64, heads, d, dtype=jnp.bfloat16)
                 and 4 * d <= 4096)  # use_fused_ff at the conformer's hidden 4d
        for b in BATCHES:
            assert conformer_conv_shape_ok(b, n, d, e, k), (b, n, d, e, k)
            if block:
                assert "K5" in cc.conformer_kernels("cuda", BF16, b, n, d, heads, 64, 4 * d, e,
                                                    k), (b, n, d, e, k)
        if n in (1, 60, 690, 2048):  # the wrapper on meta tensors at a few lengths
            w = lambda *s: torch.empty(s, device=META, dtype=BF16)  # noqa: E731
            conv = {"norm": {"weight": w(d), "bias": w(d)},
                    "pw1": {"weight": w(2 * e, d, 1), "bias": w(2 * e)},
                    "dw": {"weight": w(e, 1, k), "bias": w(e)},
                    "bn": {"weight": w(e), "bias": w(e), "running_mean": w(e),
                           "running_var": w(e)},
                    "pw2": {"weight": w(d, e, 1), "bias": w(d)}}
            assert _takes(fused_conformer_conv, torch.empty((BATCHES[-1], n, d), device=META,
                                                            dtype=BF16), conv), (n, d, e, k)
    assert fused


@pytest.mark.parametrize("feature_dim", range(8, 1025, 8))
def test_port_takes_every_band_attention_the_jax_gate_fuses(on_tpu, feature_dim):
    """K7's JAX gate ``_use_fused_band_attn`` (sesa_tpu/models/apollo.py:179-187)
    reads only the dtype: in bf16 it fuses Apollo's band layer at every
    feature_dim, 8 heads × feature_dim / 8 over the 80 bands with the rope
    of ``_apollo_rope``, 2·(dh // 2) wide. Apollo's choice takes K7 there at
    the CLI's chunks and at a short input, and K7's wrapper takes the packed
    qkv on meta tensors, at dh itself and at the width the band layer pads
    it to."""
    assert jax_apollo._use_fused_band_attn(jnp.bfloat16)
    dh, heads = feature_dim // apollo.NUM_HEAD, apollo.NUM_HEAD
    rot = 2 * (dh // 2)
    for rows, frames in ((4, 1901), (2, 33)):
        assert "K7" in apollo.apollo_kernels("cuda", BF16, rows, frames, 80, feature_dim)
        plan = k7_plan(rows * frames, 80, heads, dh, rot)
        rope = tuple(torch.empty((80, rot), device=META, dtype=BF16) for _ in range(2))
        for width in {dh, plan["width"]}:
            qkv = torch.empty((rows * frames, 80, 3 * heads * width), device=META, dtype=BF16)
            assert _takes(fused_rope_attention, qkv, heads, dh ** -0.5, rope), (dh, width)


@pytest.mark.parametrize("p", (8, 16, 24, 32, 64, 72, 128))
def test_port_takes_every_ssd_the_jax_gate_fuses(on_tpu, p):
    """K8's JAX gate ``use_pallas_ssd`` (sesa_tpu/ops/ssd.py:190-210, reached
    through the public ``ssd``): every (P, N, chunk, L) it sends to
    ``ssd_pallas`` is one the port's gate takes on CUDA stand-ins, in bf16
    and f32, with a plan that fits one launch (at band_rnn's and band_comm's
    batches); both refuse an L off the chunk and G = 2."""
    from sesa_tpu.ops.ssd import use_pallas_ssd
    from sesa_tpu_torch.ops import ssd as ssd_ops

    fused = 0
    for n, chunk in itertools.product((128, 256, 384), (8, 32, 64, 176, 256)):
        for l in (chunk, 704, 2 * chunk + 8, 3 * chunk):
            g = types.SimpleNamespace(shape=(2, l, 1, n))
            jx = types.SimpleNamespace(shape=(2, l, 4, p))
            for dtype in (BF16, torch.float32):
                x, a = _Fake((2, l, 4, p), dtype), _Fake((2, l, 4), dtype)
                b = _Fake((2, l, 1, n), dtype)
                takes = ssd_ops.use_fused_ssd(x, a, b, b, chunk)
                assert takes == use_pallas_ssd(jx, g, chunk), (p, n, chunk, l, dtype)
                fused += takes
                if takes:
                    for bsz, h in ((684, 512 // p), (8280, 8)):
                        plan = ssd_ops.k8_plan(bsz, l, h, dtype, p, n, chunk)
                        assert plan["grid"] <= 2 ** 31 - 1
                        assert plan["smem"] <= ssd_ops._SMEM_BLOCK_MAX
            assert not ssd_ops.use_fused_ssd(_Fake((2, l, 4, p)), _Fake((2, l, 4)),
                                             _Fake((2, l, 2, n)), _Fake((2, l, 2, n)), chunk)
    assert fused
