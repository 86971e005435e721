"""The port's SSD scan (``ssd``, the einsum spec, and ``ssd_plain``, kernel
K8's arithmetic chunk by chunk) held against sesa_tpu's ``ssd`` and its Pallas
kernel ``ssd_pallas`` in interpret mode, on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sesa_tpu.ops.ssd import ssd as jax_ssd
from sesa_tpu.ops.ssd import ssd_pallas
from sesa_tpu_torch.ops import ssd as ssd_ops
from sesa_tpu_torch.ops.ssd import k8_plan, segsum, ssd, ssd_fused, ssd_plain, use_fused_ssd

# the f32 tolerance tests/test_ssd_pallas.py holds the Pallas kernel to: the
# four implementations sum the same f32 products in different orders
ATOL, RTOL = 2e-4, 1e-3


def _inputs(bsz=2, l=256, h=4, p=64, n=128, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, l, h, p)).astype(np.float32) * 0.5
    a = -np.abs(rng.standard_normal((bsz, l, h)).astype(np.float32)) * scale
    b = rng.standard_normal((bsz, l, 1, n)).astype(np.float32) * 0.3
    c = rng.standard_normal((bsz, l, 1, n)).astype(np.float32) * 0.3
    return x, a, b, c


def _impulse():
    """tests/test_ssd_pallas.py's long-memory case: one impulse in chunk 0
    that a tiny decay must carry to the last chunk."""
    bsz, l, h, p, n = 1, 192, 1, 8, 128
    x = np.zeros((bsz, l, h, p), dtype=np.float32)
    x[0, 3, 0, :] = 1.0
    a = np.full((bsz, l, h), -1e-3, dtype=np.float32)
    b = np.ones((bsz, l, 1, n), dtype=np.float32) * 0.1
    return x, a, b, b.copy()


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(v).to(dtype) for v in arrays]


@pytest.mark.parametrize("fn", [ssd, ssd_plain], ids=["einsum", "plain"])
@pytest.mark.parametrize("l,scale", [(64, 1.0), (192, 3.0), (256, 0.7)])
def test_matches_jax_einsum_and_pallas(fn, l, scale):
    arrays = _inputs(l=l, scale=scale, seed=l)
    got = fn(*_t(arrays), chunk_size=64).numpy()
    ref = np.asarray(jax_ssd(*map(jnp.asarray, arrays), chunk_size=64))
    pal = np.asarray(ssd_pallas(*map(jnp.asarray, arrays), chunk_size=64, interpret=True))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, pal, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("fn", [ssd, ssd_plain], ids=["einsum", "plain"])
def test_state_carries_across_chunks(fn):
    arrays = _impulse()
    got = fn(*_t(arrays), chunk_size=64).numpy()
    ref = np.asarray(ssd_pallas(*map(jnp.asarray, arrays), chunk_size=64, interpret=True))
    assert np.abs(got[0, -1]).max() > 0.1  # the impulse reached the tail
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_plain_bf16_io_sums_in_f32():
    """bf16 in and out, f32 inside: against the Pallas kernel on the same
    bf16 inputs the plain version differs by the output rounding alone (one
    bf16 ulp of the largest value, 2**-8 relative, is the bound), and it
    stays within 5% of the f32 result's scale."""
    arrays = _inputs(l=128, seed=5)
    ref = np.asarray(jax_ssd(*map(jnp.asarray, arrays), chunk_size=64))
    got = ssd_plain(*_t(arrays, torch.bfloat16), chunk_size=64)
    assert got.dtype == torch.bfloat16
    pal = ssd_pallas(*(jnp.asarray(v, jnp.bfloat16) for v in arrays), chunk_size=64,
                     interpret=True)
    scale = max(float(np.abs(ref).max()), 1.0)
    assert np.abs(got.float().numpy() - ref).max() < 0.05 * scale
    assert np.abs(got.float().numpy() - np.asarray(pal, np.float32)).max() <= 2.0 ** -8 * scale


def test_ssd_with_grouped_projections_matches_jax():
    """G = 2 and a small state: shapes only the einsum path takes."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 128, 4, 8)).astype(np.float32) * 0.3
    a = -np.abs(rng.standard_normal((2, 128, 4)).astype(np.float32)) * 0.1
    b = rng.standard_normal((2, 128, 2, 16)).astype(np.float32) * 0.3
    c = rng.standard_normal((2, 128, 2, 16)).astype(np.float32) * 0.3
    x4 = x.reshape(2, 128, 2, 2, 8)  # heads split into the two groups

    def grouped(fn, conv):
        # a group's heads share its B and C: run each group as G = 1
        outs = [fn(*conv((x4[:, :, g], a.reshape(2, 128, 2, 2)[:, :, g], b[:, :, g:g + 1],
                          c[:, :, g:g + 1])), chunk_size=64) for g in range(2)]
        return np.stack([np.asarray(o) for o in outs], axis=2).reshape(x.shape)

    got = grouped(ssd, lambda t: _t([np.ascontiguousarray(v) for v in t]))
    ref = grouped(jax_ssd, lambda t: [jnp.asarray(v) for v in t])
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)


def test_segsum_matches_definition():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 6)).astype(np.float32))
    s = segsum(x)
    assert s.shape == (3, 6, 6)
    assert torch.isinf(s[0, 1, 2]) and s[0, 1, 2] < 0
    np.testing.assert_allclose(s[1, 4, 1].item(), x[1, 2:5].sum().item(), atol=1e-6)
    assert s[2, 3, 3].item() == 0.0


def test_gate_is_on_device_dtype_and_shape():
    x, a, b, c = _t(_inputs(l=128))
    assert not use_fused_ssd(x, a, b, c, 64)  # CPU tensors take the einsum
    meta = [t.to("meta") for t in (x, a, b, c)]
    assert not use_fused_ssd(*meta, 64)
    # the wrapper runs its plain version on the CPU and launches nothing
    before = ssd_fused.launches
    assert torch.equal(ssd_fused(x, a, b, c), ssd_plain(x, a, b, c))
    assert ssd_fused.launches == before


@pytest.mark.parametrize("change,takes", [
    ({}, True),
    ({"dtype": torch.bfloat16}, True),
    ({"l": 100}, False),          # not a multiple of the chunk
    ({"p": 32}, False),           # head dim the kernel is not built for
    ({"n": 64}, False),           # state size the kernel is not built for
    ({"g": 2}, False),            # B and C per group
    ({"chunk": 32}, False),
    ({"dtype": torch.float16}, False),
    ({"mixed": True}, False),     # a in another dtype than x
])
def test_gate_shapes(change, takes):
    """The gate's shape and dtype rules, asked of tensors that claim to be on
    a CUDA device (no storage is touched)."""
    l, p, n, g = change.get("l", 128), change.get("p", 64), change.get("n", 128), change.get("g", 1)
    dt = change.get("dtype", torch.float32)

    class Fake:
        def __init__(self, shape, dtype):
            self.shape, self.dtype, self.device = torch.Size(shape), dtype, torch.device("cuda")

    x, a = Fake((2, l, 4, p), dt), Fake((2, l, 4), torch.bfloat16 if change.get("mixed") else dt)
    b = c = Fake((2, l, g, n), dt)
    assert use_fused_ssd(x, a, b, c, change.get("chunk", 64)) is takes


# an H100 SM's shared memory, and what each resident block takes of it for
# the system
SMEM_SM, SMEM_PER_BLOCK_RESERVED = 233472, 1024


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("bsz,l,h", [
    (684, 704, 8),      # band_rnn
    (8280, 64, 8),      # band_comm
    (1001, 64, 8),      # a last wave left part empty
    (3, 64, 1), (2, 64, 3), (2, 64, 11),
    (2, 192, 3), (5, 256, 8), (1, 192, 1), (8280, 128, 8),
])
def test_k8_plan(bsz, l, h, dtype):
    """K8's launch plan: one-chunk sequences take the rows kernel, a block per
    batch row that walks all its heads; longer ones a block per (batch row,
    head) pair. The shared memory fits a block's opt-in limit and lets the
    planned blocks share an SM."""
    plan = k8_plan(bsz, l, h, dtype)
    rows = plan["variant"] == "rows"
    assert rows == (l == 64)
    assert plan["heads_per_block"] == (h if rows else 1)
    assert plan["grid"] == (bsz if rows else bsz * h)
    assert plan["blocks_per_sm"] == (2 if rows or dtype == torch.bfloat16 else 1)
    assert plan["smem"] <= ssd_ops._SMEM_BLOCK_MAX
    assert (plan["smem"] + SMEM_PER_BLOCK_RESERVED) * plan["blocks_per_sm"] <= SMEM_SM


@pytest.mark.parametrize("dtype,carried,rows", [(torch.bfloat16, 100_864, 55_296),
                                                (torch.float32, 230_912, 106_496)],
                         ids=["bf16", "f32"])
def test_k8_plan_smem_is_the_kernels_layout(dtype, carried, rows):
    """The plan's shared memory is the layout csrc/ssd.cu states and checks
    (ss_carried_smem, ss_rows_smem): a change to either side shows here."""
    assert k8_plan(2, 128, 8, dtype)["smem"] == carried
    assert k8_plan(2, 64, 8, dtype)["smem"] == rows


def _tf32_split(v):
    """K8's split by masks: hi keeps the top 11 significant bits, lo = v - hi
    masked the same way (csrc/ssd.cu split_tf32)."""
    mask = np.uint32(0xFFFFE000)
    hi = (v.view(np.uint32) & mask).view(np.float32)
    lo = ((v - hi).view(np.uint32) & mask).view(np.float32)
    return hi, lo


def test_tf32_split_premise():
    """bf16 values widened to f32 are their own TF32 high part (lo = 0), and
    for any f32 value hi + lo is within 2^-20 |v| of it."""
    rng = np.random.default_rng(0)
    v = (rng.standard_normal(100_000) * 2.0 ** rng.integers(-60, 60, 100_000)).astype(np.float32)
    wide = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
    assert not (wide.view(np.uint32) & np.uint32(0xFFFF)).any()
    hi, lo = _tf32_split(wide)
    assert np.array_equal(hi, wide) and not lo.any()
    hi, lo = _tf32_split(v)
    err = np.abs(hi.astype(np.float64) + lo - v.astype(np.float64))
    assert (err <= 2.0 ** -20 * np.abs(v.astype(np.float64))).all()
    assert (np.abs(v - hi) > 0).any()  # the low parts carry something
