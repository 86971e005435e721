"""The port's per-kernel choices on the CPU, with no card: the conformer
block's (K2, K4, K5) and Apollo's (K6, K7), called with "cuda" and bf16 over
grids of shapes. Every kernel a choice admits is one whose wrapper takes the
shape, and each wrapper raises on a non-CPU tensor exactly where its shape
predicate refuses: meta tensors carry the shapes into the wrappers, which
then stop at the device check that follows the shape checks."""

import itertools

import pytest
import torch

from sesa_tpu_torch.models import apollo
from sesa_tpu_torch.models import conformer_core as cc
from sesa_tpu_torch.ops.attention import (conformer_attention_shape_ok,
                                          fused_conformer_attention, fused_rope_attention,
                                          k7_plan)
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
                "K5": conformer_conv_shape_ok(batch, dim, e, k)}
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
    (heads 8) runs K2 and K5 with the attention unfused, conv kernel 33 K2
    and K4 with the conv unfused; the mel-band conformer's defaults all
    three."""
    legs = ((360, 690), (4140, 60))
    for batch, n in legs:
        assert cc.conformer_kernels("cuda", BF16, batch, n, 384, 8, 48, 1536, 768, 31) == {
            "K2", "K5"}
        assert cc.conformer_kernels("cuda", BF16, batch, n, 384, 8, 64, 1536, 768, 33) == {
            "K2", "K4"}
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
        assert _takes(fused_conformer_conv, x, conv) == conformer_conv_shape_ok(batch, dim, e, k)


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
    and K6; 768 and 1024 run K7 at dim_head 96 and 128 with the ICBs
    unfused; 64 (dim_head 8) runs K6 with the band layer unfused."""
    want = {64: {"K6"}, 256: {"K6", "K7"}, 384: {"K6", "K7"}, 768: {"K7"}, 1024: {"K7"}}
    for feature_dim, kernels in want.items():
        assert apollo.apollo_kernels("cuda", BF16, 4, 1901, 80, feature_dim) == kernels
