"""The benchmark's yardstick of TS-BS-Mamba2 (``h100_bench/``): its plain
reference against the port's f32 CPU path on one state dict in the published
layout, the reference's Mamba-2 and scan on their own, the layout against what
the port's converter consumes, the FLOP count and K8's bound by hand, K8's
kernel names, the fp8 control, the reference's imports, the band-loop
metric's reader and the model's spans."""

import json
import math
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from h100_bench import manifest, weights
from h100_bench.metrics import band_loop_host_ms
from h100_bench.models import bs_mamba2 as yard
from h100_bench.reference import bs_mamba2 as ref
from h100_bench.reference.roformer import F32, FP8
from h100_bench.trace import Trace, load_kernel_table

ROOT = manifest.ROOT
STEMS = ["vocals", "drums", "bass", "other"]
# the published band layout, state 128 and heads of 64; one BSNet a stack at
# feature_dim 16 (one head of 64)
TINY = dict(sr=44100, win=2048, stride=512, feature_dim=16, num_repeat_mask=1,
            num_repeat_map=1, num_output=4)
SEED = 2 ** 31 + 27


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _published():
    with open(os.path.join(ROOT, "h100_bench", "configs", "ts_bs_mamba2.json")) as f:
        return json.load(f)["model"]


def _config(model):
    from sesa_tpu_torch.configs import config_from_dict

    return config_from_dict({"audio": {"chunk_size": 44100, "num_channels": 2,
                                       "sample_rate": 44100},
                             "model": model, "training": {"instruments": STEMS}})


def _params(model, sd):
    from sesa_tpu_torch.convert import convert_checkpoint

    return convert_checkpoint("bs_mamba2", sd, _config(model))


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_reference_matches_the_program_in_f32():
    """Two chunks of one second: band_rnn scans 87 frames (a carried state),
    band_comm 57 bands (one short chunk)."""
    from sesa_tpu_torch.models import bs_mamba2

    sd = weights.make_state_dict(yard.state_dict_layout(TINY), SEED, "cpu")
    x = torch.randn(2, 2, 44100, generator=torch.Generator().manual_seed(3)) * 0.3
    with torch.inference_mode():
        prog = bs_mamba2.apply(_params(TINY, sd), _config(TINY), x, compute_dtype=None)
    with F32().context():
        want = yard.reference_forward(sd, TINY, x)
    assert want.shape == prog.shape == (2, 4, 2, 44100)
    assert _rel(prog, want) < 1e-4


@pytest.mark.parametrize("length", [70, 57])
def test_reference_mamba2_at_lengths_not_whole_chunks(length):
    """One direction's Mamba-2 against the port's at the published widths,
    and causal: steps appended after the sequence change none before."""
    from sesa_tpu_torch.models.bs_mamba2 import mamba2_apply

    model = dict(TINY, feature_dim=128)
    s = ref.sizes(model)
    layout = [e for e in yard.state_dict_layout(model)
              if e[0].startswith("separator_mask.0.band_rnn.rnn.forward_mamba2.")]
    sd = weights.make_state_dict(layout, SEED + length, "cpu")
    prefix = layout[0][0].rsplit(".", 1)[0]
    u = torch.randn(3, length + 9, 128, generator=torch.Generator().manual_seed(length))
    mm = F32()
    with mm.context():
        want = ref.mamba2(mm, sd, prefix, u[:, :length], s)
        longer = ref.mamba2(mm, sd, prefix, u, s)
    name = {"in_proj.weight": "in_proj", "conv1d.weight": "conv_w", "conv1d.bias": "conv_b",
            "norm.weight": "norm_w", "out_proj.weight": "out_proj"}
    p = {name.get(k[len(prefix) + 1:], k[len(prefix) + 1:]): v for k, v in sd.items()}
    with torch.inference_mode():
        prog = mamba2_apply(p, u[:, :length])
    assert _rel(prog, want) < 1e-5
    assert _rel(longer[:, :length], want) < 1e-6


def _recurrence(x, a, b, c):
    """h_t = exp(a_t) h_{t-1} + x_t ⊗ b_t, y_t = h_t · c_t, step by step in f64."""
    x, a, b, c = (t.double() for t in (x, a, b, c))
    bsz, length, h, p = x.shape
    state = torch.zeros(bsz, h, p, b.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(length):
        state = torch.exp(a[:, t])[..., None, None] * state \
            + x[:, t, :, :, None] * b[:, t, None, None, :]
        ys.append((state * c[:, t, None, None, :]).sum(-1))
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("length,chunk", [(64, 64), (192, 64), (96, 32)])
def test_reference_scan_against_a_step_recurrence(length, chunk):
    gen = torch.Generator().manual_seed(length + chunk)
    x = torch.randn(2, length, 3, 8, generator=gen)
    a = -torch.rand(2, length, 3, generator=gen) * 0.3
    b, c = (torch.randn(2, length, 16, generator=gen) * 0.5 for _ in range(2))
    mm = F32()
    with mm.context():
        got = ref.ssd(mm, x, a, b, c, chunk)
    want = _recurrence(x, a, b, c)
    assert float((got.double() - want).norm() / want.norm()) < 1e-5


@pytest.mark.parametrize("model", ["tiny", "published"])
def test_layout_is_what_the_converter_consumes(model):
    """Every key of the layout is consumed (the converter raises on a
    leftover and on a missing key) into a tree of the port's ``init``
    shapes; the published model holds 35.5 M parameters."""
    from sesa_tpu_torch.models import bs_mamba2
    from sesa_tpu_torch.tree import tree_map

    m = TINY if model == "tiny" else _published()
    layout = yard.state_dict_layout(m)
    assert len({k for k, _, _, _ in layout}) == len(layout)
    sd = {k: torch.empty(shape) for k, shape, _, _ in layout}
    got, want = [], []
    tree_map(lambda t: got.append(tuple(t.shape)), _params(m, sd))
    tree_map(lambda t: want.append(tuple(t.shape)),
             bs_mamba2.init(torch.Generator().manual_seed(0), _config(m)))
    assert got == want
    if model == "published":
        assert sum(math.prod(s) for _, s, _, _ in layout) == 35_517_480


def test_flops_and_k8_bound_by_hand():
    """At the published widths and a chunk of 352,800 samples: 690 frames,
    57 bands of 1,025 bins, N 128, 8 heads x 64, state 128, 4 stems."""
    model = _published()
    rnn_tri = 10 * 64 * 65 + 50 * 51  # ten whole chunks of 64 and one of 50
    comm_tri = 57 * 58

    def scan(rows, tri, states):
        return rows * tri * 128, rows * 8 * (tri * 64 + 2 * 128 * 64 * states)

    legs = ((114, 690, scan(114, rnn_tri, 640 + 626)), (1380, 57, scan(1380, comm_tri, 0)))
    bsnet = sum(2 * (2 * rows * n * (128 * 1288 + 512 * 128) + sum(sc))
                + 2 * rows * n * 256 * 128 for rows, n, sc in legs)
    bsnet += 2 * 57 * 690 * (2 * (128 * 384 + 768 * 128) + 384 * 384)
    want = (2 * 2 * 1380 * 2 * 1025 * 128  # bottlenecks
            + 12 * bsnet
            + 2 * 57 * 1380 * 256 * 128  # in_conv
            + 2 * 2 * 1380 * (57 * 2 * 128 * 512 + 4 * 1025 * 4 * 128))  # heads
    assert yard.model_flops_per_chunk(model, 352800) == pytest.approx(want, rel=1e-12)
    assert 2.9e12 < want < 3.0e12

    bound = 0.0
    for rows, n, tri, states in ((684, 690, rnn_tri, 640 + 626), (8280, 57, comm_tri, 0)):
        cbt, rest = rows * tri * 128, rows * 8 * (tri * 64 + 2 * 128 * 64 * states)
        ops = cbt / 989e12 + rest * 3 / 989e12  # three bf16 passes beat two TF32
        bound += 24 * max(ops, 2 * rows * n * (2 * 8 * 64 + 8 + 2 * 128) / 3.35e12)
    assert yard.kernel_bound_s(model, 352800, 6)["K8"] == pytest.approx(bound, rel=1e-12)
    assert yard.kernel_launches(model, 6) == {"K8": 48}


def test_k8_bound_at_whole_chunks_is_chip_smokes():
    import chip_smoke

    s = ref.sizes(_published())
    for rows, length in ((684, 704), (8280, 64)):
        got = yard.scan_bound_s(rows, length, s, 128) * 1e3
        assert got == pytest.approx(
            chip_smoke.k8_bound(rows, length, 8, torch.bfloat16)["bound_ms"], rel=1e-12)


def test_k8_patterns_name_the_kernels_of_ssd_cu():
    with open(os.path.join(ROOT, "sesa_tpu_torch", "csrc", "ssd.cu")) as f:
        names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(",
                           f.read())
    table = load_kernel_table(os.path.join(ROOT, "h100_bench", "kernels"))
    patterns = table["K8"]["patterns"]
    assert sorted(names) == ["ssd_carried", "ssd_rows"]
    for name in names:
        demangled = f"void sesa::{name}<__nv_bfloat16, false>(__nv_bfloat16 const*, int)"
        assert [f for f, t in table.items() if any(p.search(demangled) for p in t["patterns"])] \
            == ["K8"]
    assert all(any(p.search(f"sesa::{n}<float, true>") for n in names) for p in patterns)
    from sesa_tpu_torch.ops import ssd

    assert table["K8"]["counter"] == "sesa_tpu_torch.ops.ssd.ssd_fused"
    assert isinstance(ssd.ssd_fused.launches, int)


def test_fp8_products_depart_from_f32():
    sd = weights.make_state_dict(yard.state_dict_layout(TINY), 5, "cpu")
    x = torch.randn(1, 2, 22050, generator=torch.Generator().manual_seed(4)) * 0.3
    with F32().context():
        want = yard.reference_forward(sd, TINY, x)
    fp8 = FP8()
    with fp8.context():
        got = yard.reference_forward(sd, TINY, x, fp8)
    assert 0.005 < _rel(got, want) < 1.0


def test_the_reference_loads_neither_jax_nor_the_program():
    code = ("import sys; sys.path.insert(0, '.'); import h100_bench.reference.bs_mamba2, "
            "h100_bench.models.bs_mamba2; from h100_bench import guard; "
            "print(sorted(guard.forbidden_modules()), "
            "sorted(m for m in sys.modules if m.split('.')[0] == 'sesa_tpu_torch'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"


def _ev(name, start, end, device=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU, thread=1)


@pytest.mark.parametrize("program", ["none", "other spans", "mamba spans"])
def test_band_loop_host_ms_reads_the_mamba_spans_only(program):
    events = [_ev("bench::song#0", 0, 100), _ev("bench::song#1", 150, 250),
              _ev("void at::native::elementwise_kernel<4>", 10, 90, device=True),
              _ev("sesa.dispatch", 5, 95), _ev("sesa.model", 6, 94)]
    if program == "mamba spans":
        events += [_ev("sesa.mamba.split", 7, 12), _ev("sesa.mamba.mask", 12, 40),
                   _ev("sesa.mamba.heads", 60, 70), _ev("sesa.mamba.split", 160, 161),
                   _ev("sesa.mamba.heads", 120, 130),  # between calls: not counted
                   # launches: the host's wait inside them is taken out of the loops'
                   _ev("aten::add", 8, 11), _ev("cudaLaunchKernel", 8.5, 10),
                   _ev("cuLaunchKernel", 9, 10.5), _ev("cudaLaunchKernel", 20, 30)]
    elif program == "other spans":
        events += [_ev("sesa.separate", 2, 98)]
    run = SimpleNamespace(trace=Trace(events, load_kernel_table(
        os.path.join(ROOT, "h100_bench", "kernels")), {}), item_chunks=lambda: 4)
    got = band_loop_host_ms.read(run)
    if program == "mamba spans":
        assert got == pytest.approx((5 - 2 + 10 + 1) / 1e3 / 4)
    else:
        assert got is None


def test_the_model_records_its_four_spans_once_a_call():
    from torch.profiler import ProfilerActivity, profile

    from sesa_tpu_torch.models import bs_mamba2

    sd = weights.make_state_dict(yard.state_dict_layout(TINY), 7, "cpu")
    params, config = _params(TINY, sd), _config(TINY)
    x = torch.randn(1, 2, 11025, generator=torch.Generator().manual_seed(5)) * 0.3
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.inference_mode():
        bs_mamba2.apply(params, config, x, compute_dtype=None)
    names = [e.name for e in prof.events() if e.name.startswith("sesa.mamba.")]
    assert sorted(names) == ["sesa.mamba.heads", "sesa.mamba.map", "sesa.mamba.mask",
                             "sesa.mamba.split"]
