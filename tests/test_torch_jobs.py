"""The port's demix job API (``demix_start``, ``DemixJob``, ``upload_mix``,
``seg_batches``, the int16 transport) held against sesa_tpu's on the CPU with
the same simple model function (a scale plus a channel mix, as
tests/test_demix.py's ``_mix_model_jax``), upload_mix's staging ring with
CPU stand-ins for its pinned slots and events, the blend windows' cache,
then the session's shared upload (``mix_device``) and the auto ensemble's
single upload."""

import importlib
import os
import sys
import threading
import tracemalloc

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sesa_tpu_torch.processing as pproc
import sesa_tpu_torch.runtime as pruntime
from sesa_tpu.runtime.session import InferenceSession as JaxSession
from sesa_tpu_torch import audio_io
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.runtime.session import InferenceSession
from tests.test_torch_app import SR, FakeSession, _homes

jax_demix = importlib.import_module("sesa_tpu.runtime.demix")
port_demix = importlib.import_module("sesa_tpu_torch.runtime.demix")

# both engines sum the same f32 products in other orders
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's six workers share eight cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mix_model_jax(params, chunks):
    return jnp.stack([0.3 * chunks, 0.7 * chunks[:, ::-1, :]], axis=1)


def _mix_model(params, chunks):
    return torch.stack([0.3 * chunks, 0.7 * chunks.flip(1)], dim=1)


def _specs(**kw):
    return jax_demix.DemixSpec(**kw), port_demix.DemixSpec(**kw)


def _mix(t, seed):
    return np.random.default_rng(seed).standard_normal((2, t)).astype(np.float32)


def _start(mix, spec, **kw):
    return port_demix.demix_start(_mix_model, None, mix, spec, device="cpu", **kw)


@pytest.mark.parametrize("seg", [1, 8])
def test_seg_batches_match_jax(seg):
    mix = _mix(100000, 7)
    jspec, spec = _specs(chunk_size=16384, num_overlap=2, batch_size=4, num_stems=2)
    ref = jax_demix.demix(_mix_model_jax, None, mix, jspec, seg_batches=seg)
    job = _start(mix, spec, seg_batches=seg)
    assert isinstance(job, pruntime.DemixJob)
    # 116384 padded samples: 15 chunks of step 8192, 4 batches of 4
    assert len(job.slabs) == {1: 4, 8: 1}[seg]
    np.testing.assert_allclose(job.collect(), ref, atol=ATOL)


@pytest.mark.parametrize("seg", [1, 8])
def test_int16_within_one_step(seg):
    """int16 stems within the quantisation floor (max |exact| / 32767, 1%
    slack) of the JAX engine's exact stems, on one segment and many."""
    mix = _mix(100000, 7)
    jspec, spec = _specs(chunk_size=16384, num_overlap=2, batch_size=4, num_stems=2)
    exact = jax_demix.demix(_mix_model_jax, None, mix, jspec)
    got = port_demix.demix(_mix_model, None, mix, spec, device="cpu", seg_batches=seg,
                           transport="int16")
    assert got.dtype == np.float32
    assert np.abs(got - exact).max() <= np.abs(exact).max() / 32767.0 * 1.01
    # each slab carries its own scale, the codes are int16
    job = _start(mix, spec, seg_batches=seg, transport="int16")
    assert all(s.data.dtype == torch.int16 and s.scale.dtype == torch.float32
               for s in job.slabs if s is not None)


def test_int16_scale_alignment_with_border_only_slabs():
    """num_overlap 8: step 2048, border 14336, slab_len 4096 at seg 1, so
    the first three slabs lie inside the border and are skipped; their
    placeholders keep every later scale on its own slab (tests/test_demix.py's
    regression)."""
    mix = _mix(120000, 13)
    jspec, spec = _specs(chunk_size=16384, num_overlap=8, batch_size=2, num_stems=2)
    exact = jax_demix.demix(_mix_model_jax, None, mix, jspec, seg_batches=1)
    job = _start(mix, spec, seg_batches=1, transport="int16")
    assert job.slabs[:3] == [None, None, None] and job.slabs[3] is not None
    got = job.collect()
    assert np.abs(got - exact).max() <= np.abs(exact).max() / 32767.0 * 1.01
    np.testing.assert_allclose(_start(mix, spec, seg_batches=1).collect(), exact, atol=ATOL)


def test_two_jobs_in_flight_match_sequential():
    """Two jobs started before either is collected, from one shared upload,
    against sequential demix of each package."""
    mix = _mix(80000, 11)
    jspec, spec = _specs(chunk_size=16384, num_overlap=2, batch_size=2, num_stems=2)
    seq = port_demix.demix(_mix_model, None, mix, spec, device="cpu", seg_batches=1)
    np.testing.assert_allclose(
        seq, jax_demix.demix(_mix_model_jax, None, mix, jspec, seg_batches=1), atol=ATOL)
    mix_dev = pruntime.upload_mix(mix, device="cpu")
    j1 = _start(mix_dev, spec, seg_batches=1)
    j2 = _start(mix_dev, spec, seg_batches=1, transport="int16")
    a, b = j1.collect(), j2.collect()
    np.testing.assert_array_equal(a, seq)
    assert np.abs(b - seq).max() <= np.abs(seq).max() / 32767.0 * 1.01


def test_collect_device_with_stems():
    mix = _mix(100000, 19)
    jspec, spec = _specs(chunk_size=16384, num_overlap=2, batch_size=3, num_stems=2)
    exact = jax_demix.demix(_mix_model_jax, None, mix, jspec, seg_batches=1)
    mix_dev = pruntime.upload_mix(mix, device="cpu")
    for seg in (1, 8):
        dev = _start(mix_dev, spec, seg_batches=seg, transport="device").collect_device()
        assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float32
        np.testing.assert_allclose(dev.numpy(), exact, atol=ATOL)
    job = _start(mix_dev, spec, seg_batches=1, transport="device")
    assert all(s.host is None for s in job.slabs if s is not None)  # nothing copied
    one = job.collect_device(stems=[1])
    assert one.shape == (1,) + exact.shape[1:]
    np.testing.assert_allclose(one[0].numpy(), exact[1], atol=ATOL)
    # an int16 job assembled on the device is dequantised there
    dev = _start(mix_dev, spec, seg_batches=1, transport="int16").collect_device()
    assert dev.dtype == torch.float32
    assert np.abs(dev.numpy() - exact).max() <= np.abs(exact).max() / 32767.0 * 1.01
    # demix(transport="device") is collect_device, stems included
    got = port_demix.demix(_mix_model, None, mix_dev, spec, device="cpu", transport="device",
                           stems=[1, 0])
    np.testing.assert_allclose(got.numpy(), exact[[1, 0]], atol=ATOL)


def test_upload_mix_bit_exact_and_fallback(monkeypatch):
    """16-bit PCM, arbitrary floats and a 1.5x hot master all cross as f32
    and come back bit for bit, equal to the JAX package's upload; numpy
    makes no array of the song on the way, so no int16 copy."""
    rng = np.random.default_rng(0)
    pcm = rng.integers(-32768, 32768, size=(2, 100000), dtype=np.int16)
    as_f32 = pcm.astype(np.float32) / 32768.0
    crossed = []
    real = torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy", lambda a: crossed.append(a.dtype) or real(a))
    for mix in (as_f32, rng.standard_normal((2, 100000)).astype(np.float32), as_f32 * 1.5):
        crossed.clear()
        tracemalloc.start()
        try:
            up = pruntime.upload_mix(mix, device="cpu")
            numpy_peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        assert crossed == [np.float32] and up.dtype == torch.float32
        assert numpy_peak < mix.nbytes // 4  # an int16 copy alone is half the song's bytes
        np.testing.assert_array_equal(up.numpy(), mix)
        np.testing.assert_array_equal(up.numpy(), np.asarray(jax_demix._upload_mix(mix)))


class _Event:
    """A CUDA event's stand-in for the staging ring: after each ``record``
    it reports its copy running for ``busy`` queries, or until waited on."""

    def __init__(self, busy=0):
        self.busy, self.left, self.waits = busy, 0, 0

    def record(self):
        self.left = self.busy

    def query(self):
        if self.left:
            self.left -= 1
            return False
        return True

    def synchronize(self):
        self.left = 0
        self.waits += 1


def _stats_since(before):
    now = port_demix.upload_stats()
    return {k: now[k] - before[k] for k in now}


def test_staging_ring_copies_piece_by_piece():
    """A song longer than the ring crosses in slot-sized pieces, the last
    one partial, bit for bit; the slots are allocated once, when the ring
    is made, and reused by every later copy; a transposed view crosses as
    its values."""
    before = port_demix.upload_stats()
    ring = port_demix._StagingRing(lambda n: torch.empty(n), _Event, slots=3, slot_elems=1000)
    assert _stats_since(before)["staging_allocs"] == 3
    slots = [buf.data_ptr() for buf, _ in ring.slots]
    song = _mix(4567, 29)  # 9134 samples: 10 pieces, the last of 134
    dst = torch.empty(song.shape)
    ring.copy(song, dst)
    np.testing.assert_array_equal(dst.numpy(), song)
    assert _stats_since(before) == {"staging_allocs": 3, "staging_pieces": 10,
                                    "staging_waits": 0, "windows_built": 0}
    transposed, strided = np.ascontiguousarray(_mix(1700, 33).T).T, _mix(700, 37)[:, ::2]
    assert not transposed.flags.c_contiguous and not strided.flags.c_contiguous
    for mix in (_mix(1500, 31), transposed, strided):
        dst = torch.empty(mix.shape)
        ring.copy(mix, dst)
        np.testing.assert_array_equal(dst.numpy(), mix)
        np.testing.assert_array_equal(pruntime.upload_mix(mix, device="cpu").numpy(), mix)
    assert _stats_since(before)["staging_allocs"] == 3
    assert [buf.data_ptr() for buf, _ in ring.slots] == slots


def test_staging_ring_waits_for_a_busy_slot():
    """A slot whose last copy is still running is waited on before it is
    refilled, inside a ``sesa.sync.staging`` span, and counted; a slot
    whose copy is done is refilled at once."""
    from torch.profiler import ProfilerActivity, profile

    from sesa_tpu_torch.runtime.profiling import span

    before = port_demix.upload_stats()
    ring = port_demix._StagingRing(lambda n: torch.empty(n), lambda: _Event(busy=1), slots=2,
                                   slot_elems=100)
    song = _mix(250, 41)  # 5 pieces through 2 slots: pieces 2, 3 and 4 find theirs busy
    dst = torch.empty(song.shape)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("sesa.upload"):
            ring.copy(song, dst)
    np.testing.assert_array_equal(dst.numpy(), song)
    assert [e.waits for _, e in ring.slots] == [2, 1]
    assert _stats_since(before)["staging_waits"] == 3
    waits = [e for e in prof.events() if e.name == "sesa.sync.staging"]
    assert len(waits) == 3 and all(e.cpu_parent.name == "sesa.upload" for e in waits)
    # events that report the copy done: no wait
    ring = port_demix._StagingRing(lambda n: torch.empty(n), _Event, slots=2, slot_elems=100)
    ring.copy(song, dst)
    assert _stats_since(before)["staging_waits"] == 3


def test_staging_ring_shared_by_threads():
    """More threads than cores copy their own songs through one ring, with
    the interpreter switching threads as often as it can: every song
    arrives whole and every piece is counted."""
    before = port_demix.upload_stats()
    ring = port_demix._StagingRing(lambda n: torch.empty(n), _Event, slots=2, slot_elems=64)
    songs = [_mix(1000 + 37 * i, 100 + i) for i in range(2 * (os.cpu_count() or 4) + 1)]
    dsts = [torch.empty(s.shape) for s in songs]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ring.copy, args=(s, d)) for s, d in zip(songs, dsts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for s, d in zip(songs, dsts):
        np.testing.assert_array_equal(d.numpy(), s)
    assert _stats_since(before)["staging_pieces"] == sum(-(-s.size // 64) for s in songs)


def test_windows_cached_per_chunk_and_mode():
    """Demix's blend windows are built once per (chunk size, demucs mode,
    device): another batch size or stem count reuses them, another chunk
    size or mode builds its own; the cached stack is the JAX engine's, and
    demix with it warm matches the JAX engine."""
    port_demix._windows_device.cache_clear()
    before = port_demix.upload_stats()
    mix = _mix(60000, 43)
    jspec, spec = _specs(chunk_size=8192, num_overlap=2, batch_size=2, num_stems=2)
    ref = jax_demix.demix(_mix_model_jax, None, mix, jspec)
    for _ in range(2):
        np.testing.assert_allclose(_start(mix, spec).collect(), ref, atol=ATOL)
    assert _stats_since(before)["windows_built"] == 1
    _start(mix, port_demix.DemixSpec(chunk_size=8192, batch_size=3, num_stems=2)).collect()
    assert _stats_since(before)["windows_built"] == 1
    for n, (chunk, demucs) in enumerate(((4096, False), (8192, True)), start=2):
        jspec2, spec2 = _specs(chunk_size=chunk, batch_size=2, num_stems=2, demucs_mode=demucs)
        np.testing.assert_allclose(
            _start(mix, spec2).collect(), jax_demix.demix(_mix_model_jax, None, mix, jspec2),
            atol=ATOL)
        assert _stats_since(before)["windows_built"] == n
        cached = port_demix._windows_device(chunk, demucs, torch.device("cpu"))
        np.testing.assert_array_equal(cached.numpy(), jax_demix._windows(jspec2))
    assert _stats_since(before)["windows_built"] == 3


def test_affine_with_tta_matches_jax():
    """demix(raw, affine) and TTA on it (the inverted pass flips the mean)
    against the JAX engine, and against the host-normalised mix."""
    def model_jax(params, chunks):
        return (chunks * params["g"] + 0.1 * chunks[:, ::-1])[:, None]

    def model(params, chunks):
        return (chunks * params["g"] + 0.1 * chunks.flip(1))[:, None]

    jspec, spec = _specs(chunk_size=1000, num_overlap=2, batch_size=2, num_stems=1)
    mix = _mix(5000, 3)
    m, s = float(mix.mean()), float(mix.std())
    jp, pp = {"g": jnp.float32(0.7)}, {"g": torch.tensor(0.7)}
    jdev = jax_demix.demix(model_jax, jp, mix, jspec, affine=(m, s))
    ref = jax_demix.apply_tta(model_jax, jp, mix, jdev, jspec, affine=(m, s))
    dev = port_demix.demix(model, pp, mix, spec, device="cpu", affine=(m, s))
    np.testing.assert_allclose(dev, jdev, atol=ATOL)
    got = port_demix.apply_tta(model, pp, mix, dev, spec, device="cpu", affine=(m, s))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    host = port_demix.demix(model, pp, (mix - m) / s, spec, device="cpu")
    host_tta = port_demix.apply_tta(model, pp, (mix - m) / s, host, spec, device="cpu")
    np.testing.assert_allclose(got, host_tta, atol=ATOL)
    # a device mix is flipped and negated where it lies
    mix_dev = pruntime.upload_mix(mix, device="cpu")
    got_dev = port_demix.apply_tta(model, pp, mix_dev, torch.from_numpy(dev), spec, device="cpu",
                                   affine=(m, s), transport="device")
    np.testing.assert_allclose(got_dev.numpy(), ref, atol=ATOL)


def _sessions():
    """A JAX and a port session on the same simple model (normalising
    configs: the statistics come from the host mix)."""
    cfg = {"audio": {"chunk_size": 16384, "num_channels": 2, "sample_rate": SR},
           "training": {"instruments": ["vocals", "other"], "target_instrument": None},
           "inference": {"num_overlap": 2, "batch_size": 2, "normalize": True}}
    jspec, spec = _specs(chunk_size=16384, num_overlap=2, batch_size=2, num_stems=2)
    js = JaxSession("bs_roformer", cfg, None, jspec, compute_dtype=None)
    js._apply_fn_cache = {"None": _mix_model_jax}
    ps = InferenceSession("bs_roformer", AttrDict(cfg), None, spec, torch.device("cpu"),
                          compute_dtype=None)
    ps._model_apply = lambda dtype: _mix_model
    return js, ps


def test_session_separate_with_mix_device():
    js, ps = _sessions()
    mix = _mix(70000, 5) * 0.3 + 0.05
    mix_dev = pruntime.upload_mix(mix, device="cpu")
    ref = js.separate(mix, mix_device=jax_demix.upload_mix(mix))
    got = ps.separate(mix, mix_device=mix_dev)
    assert list(got) == list(ref) == ["vocals", "other"]
    plain = ps.separate(mix)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=ATOL)
        np.testing.assert_array_equal(got[k], plain[k])
    # a mono song becomes stereo: the mono device copy no longer fits and is dropped
    mono = mix[:1]
    got = ps.separate(mono, mix_device=pruntime.upload_mix(mono, device="cpu"))
    np.testing.assert_array_equal(got["vocals"], ps.separate(np.repeat(mono, 2, 0))["vocals"])
    # the int16 transport, within its floor of the exact stems
    q = ps.separate(mix, transport="int16", mix_device=mix_dev)
    for k in q:
        assert np.abs(q[k] - plain[k]).max() <= 2 * np.abs(plain[k]).max() / 32767.0


def test_auto_ensemble_uploads_once(tmp_path, monkeypatch):
    """Three models at one sample rate: one upload_mix, and every session
    separates from that one device copy."""
    homes = _homes(tmp_path, monkeypatch)
    uploads, seen = [], []
    real = pruntime.upload_mix

    def counting(mix, device=None):
        uploads.append(mix.shape)
        return real(mix, device)

    class Recording(FakeSession):
        def separate_with_extras(self, mix, mix_device=None, **kw):
            seen.append(mix_device)
            return super().separate_with_extras(mix, mix_device=mix_device, **kw)

    monkeypatch.setattr(pruntime, "upload_mix", counting)
    monkeypatch.setattr(pproc, "_make_session", lambda *a, **k: Recording())
    song = audio_io.write_audio(str(tmp_path / "song.wav"),
                                _mix(SR // 2, 1) * 0.2, SR)
    updates = list(pproc.auto_ensemble_process(
        song, ["Model A", "Model B", "Model C"],
        output_dir=os.path.join(homes["port"], "aeo")))
    assert updates[-1]["progress"] == 100
    assert uploads == [(2, SR // 2)]
    assert len(seen) == 3 and all(s is seen[0] for s in seen)
    assert isinstance(seen[0], torch.Tensor) and seen[0].shape == (2, SR // 2)
