"""The session's and demix's host spans (``runtime/profiling.py`` ``span``)
under a CPU-only ``torch.profiler``, on a session whose model is a plain
scale of the chunk: where each span sits, how many one call records, and
that none is a user annotation (the profiler mirrors those onto the device
timeline). Then the CLI's ``ThroughputTracker``, fed once a file's stems are
written."""

import ast
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.runtime.demix import DemixSpec
from sesa_tpu_torch.runtime.session import InferenceSession

CHUNK = 4096
# 13788 samples: 17884 with the reflect border, 9 chunks of step 2048, 5 batches of 2
LENGTH, CHUNKS, BATCHES = 13788, 9, 5
NAME = re.compile(r"^sesa\.[a-z._]+$")
# each span's nearest enclosing program span
PARENTS = {"sesa.separate": {None, "sesa.extras"}, "sesa.upload": {"sesa.separate"},
           "sesa.dispatch": {"sesa.separate"}, "sesa.model": {"sesa.dispatch"},
           "sesa.sync.rescue": {"sesa.separate"}, "sesa.sync.to_host": {"sesa.separate"},
           "sesa.sync.stats": {"sesa.separate"}, "sesa.sync.upload": {None},
           "sesa.extras": {None}}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's six workers share eight cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(params, chunks):
    return 0.5 * chunks[:, None]


def _session(compute_dtype=None, normalize=False, poisoned=False):
    """A one-stem session on the CPU; ``poisoned``: its bf16 model gives NaN."""
    cfg = AttrDict({"training": {"target_instrument": "vocals"},
                    "inference": {"normalize": normalize}})
    spec = DemixSpec(chunk_size=CHUNK, num_overlap=2, batch_size=2, num_stems=1)
    s = InferenceSession("bs_roformer", cfg, None, spec, torch.device("cpu"), compute_dtype)

    def model_apply(dtype):
        if poisoned and dtype is not None:
            return lambda p, c: _model(p, c) * float("nan")
        return _model

    s._model_apply = model_apply
    return s


def _mix(length=LENGTH):
    return np.random.default_rng(0).uniform(-0.5, 0.5, (2, length)).astype(np.float32)


def _spans(fn):
    """(result, [(name, nearest program span around it, is_user_annotation)])."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = []
    for e in prof.events():
        if not e.name.startswith("sesa."):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("sesa."):
            parent = parent.cpu_parent
        spans.append((e.name, None if parent is None else parent.name, e.is_user_annotation))
    return out, spans


def _count(spans, name):
    return sum(1 for n, _, _ in spans if n == name)


def _check_form(spans):
    for name, parent, annotation in spans:
        assert NAME.match(name) and "::" not in name
        assert parent in PARENTS[name], (name, parent)
        assert annotation is False


def test_f32_call_spans_nest_and_count():
    s = _session()
    out, spans = _spans(lambda: s.separate_with_extras(_mix(), extract_instrumental=True))
    assert list(out) == ["vocals", "instrumental"]
    _check_form(spans)
    counts = {n: _count(spans, n) for n in PARENTS}
    assert counts == {"sesa.separate": 1, "sesa.upload": 1, "sesa.dispatch": 1,
                      "sesa.model": BATCHES, "sesa.sync.rescue": 1, "sesa.sync.to_host": 1,
                      "sesa.sync.stats": 0, "sesa.sync.upload": 0, "sesa.extras": 1}
    assert sum(1 for n, _, _ in spans if n.startswith("sesa.sync.")) == 2


def test_one_model_span_per_batch():
    for length, batch in ((LENGTH, 4), (3000, 2), (LENGTH, 1)):
        s = _session()
        s.spec = DemixSpec(chunk_size=CHUNK, num_overlap=2, batch_size=batch, num_stems=1)
        _, spans = _spans(lambda: s.separate(_mix(length)))
        chunks = s.spec.n_chunks(length)
        assert _count(spans, "sesa.dispatch") == 1
        assert _count(spans, "sesa.model") == -(-chunks // batch)
    assert DemixSpec(chunk_size=CHUNK, num_overlap=2).n_chunks(LENGTH) == CHUNKS


def test_bf16_rescue_dispatches_twice():
    s = _session(compute_dtype=torch.bfloat16, poisoned=True)
    out, spans = _spans(lambda: s.separate(_mix()))
    assert s.rescues == 1 and np.isfinite(out["vocals"]).all()
    _check_form(spans)
    assert _count(spans, "sesa.dispatch") == 2 and _count(spans, "sesa.model") == 2 * BATCHES
    assert _count(spans, "sesa.sync.rescue") == 1


def test_demud_separates_inside_extras():
    s = _session()
    _, spans = _spans(lambda: s.separate_with_extras(_mix(), demud_phaseremix_inst=True))
    _check_form(spans)
    assert [p for n, p, _ in spans if n == "sesa.separate"] == [None, "sesa.extras"]
    assert _count(spans, "sesa.dispatch") == 2


def test_other_transports_and_stats_on_tensors():
    """int16 waits once a slab, with no rescue flag; "device" uploads the mix
    for the derived stems and copies nothing back; the normalisation's
    statistics wait only for a tensor."""
    s = _session()
    _, spans = _spans(lambda: s.separate(_mix(), transport="int16"))
    _check_form(spans)
    assert _count(spans, "sesa.sync.to_host") == 1 and _count(spans, "sesa.sync.rescue") == 0
    _, spans = _spans(lambda: s.separate_with_extras(_mix(), extract_instrumental=True,
                                                     transport="device"))
    _check_form(spans)
    syncs = sorted(n for n, _, _ in spans if n.startswith("sesa.sync."))
    assert syncs == ["sesa.sync.rescue", "sesa.sync.upload"]
    s = _session(normalize=True)
    for mix, stats in ((_mix(), 0), (torch.from_numpy(_mix()), 1)):
        _, spans = _spans(lambda: s.separate(mix))
        _check_form(spans)
        assert _count(spans, "sesa.sync.stats") == stats


def test_span_names_in_the_sources():
    """Every ``span(...)`` of the session and demix is named by a literal
    ``sesa.<phase>`` that the table above places."""
    import sesa_tpu_torch.runtime.session as session_mod

    folder = os.path.dirname(session_mod.__file__)
    names = set()
    for module in ("session.py", "demix.py"):
        with open(os.path.join(folder, module)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span":
                (arg,) = node.args
                assert isinstance(arg, ast.Constant) and NAME.match(arg.value)
                names.add(arg.value)
    assert names == set(PARENTS)


def test_cli_feeds_the_throughput_tracker(tmp_path, monkeypatch, capsys):
    from scipy.io import wavfile

    from sesa_tpu_torch import cli

    s = _session()
    s.config["audio"] = {"sample_rate": 44100}
    monkeypatch.setattr(InferenceSession, "create", classmethod(lambda cls, *a, **k: s))
    (tmp_path / "in").mkdir()
    for name in ("a.wav", "b.wav"):
        wavfile.write(str(tmp_path / "in" / name), 44100, (_mix().T * 32767).astype(np.int16))
    rc = cli.main(["--model_type", "bs_roformer", "--config_path", "unused",
                   "--input_folder", str(tmp_path / "in"), "--store_dir", str(tmp_path / "out"),
                   "--force_cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("Elapsed:")
    assert lines[-1].startswith(f"{2 * LENGTH / 44100:.1f}s audio in") and "RTF" in lines[-1]
