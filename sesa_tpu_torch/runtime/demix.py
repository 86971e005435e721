"""Chunked overlap-add separation engine (counterpart of
sesa_tpu/runtime/demix.py).

The song, its chunks and the accumulators stay on the device. Numerics
match the JAX engine (and the reference at batch_size 1): outer reflect
border padding (utils.py:391-393), per-chunk reflect of short tails when
more than half a chunk remains (utils.py:417-421), a linear fade window
with no fade-in on the first chunk and no fade-out on the last
(utils.py:432-437), and division by the window counter with zero where
nothing was added (utils.py:457-459). Non-finite model output is not
scrubbed here: the session's bf16 -> f32 rescue must see it.

The job API is the JAX engine's. :func:`demix_start` queues every batch of
chunks in segments of ``seg_batches`` batches and returns a
:class:`DemixJob` without waiting for the device. After segment ``si`` the
slab ``[si·slab_len, (si+1)·slab_len)`` of the padded song is final (a later
chunk only adds at or after its own start, and segment si+1's first chunk
starts at (si+1)·slab_len), so it is divided by its counter there and then
and handed on:

- ``transport="f32"``: its device -> host copy is queued at once, into
  pinned memory on a copy stream, so it overlaps the next segment's (and
  the next job's) compute; ``collect()`` waits for each copy and assembles
  the numpy result;
- ``transport="int16"``: the slab crosses as scaled int16 (half the bytes,
  ~90 dB below the slab's peak), its f32 scale beside it;
- ``transport="device"``: nothing crosses; ``collect_device(stems=)``
  assembles the f32 stems on the device for a downstream stage.

:func:`demix` is ``demix_start(...).collect()``, except that
``transport="device"`` returns the f32 tensor on the device (the JAX
``demix`` returns numpy there: ROADMAP.md §3). :func:`upload_mix` puts a
song on the device once for several separations, as 16-bit-exact int16
where that is lossless.

With ``mesh`` (a ``parallel.make_mesh`` DeviceMesh) every rank of the mesh
calls demix with the same arguments: the rank at data coordinate d runs
chunks [d·b/D, (d+1)·b/D) of each batch and accumulates them locally, and
each slab's span of the accumulators is summed over the data axis's group
before it is finalised, so every rank gets the whole stems. Parameters are
held whole on each rank (the JAX engine's ``shard_map`` with
``in_specs=P()``).

``DemixSpec(demucs_mode=True)`` is the htdemucs mode (reference
utils.py:376-380, 443-445): no border, all-ones windows (plain averaging)
and short tails padded with zeros.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from sesa_tpu_torch import get_device, to_device
from sesa_tpu_torch.ops.windows import fade_window
from sesa_tpu_torch.runtime.profiling import span

# model_apply(params, chunks[B, ch, C]) -> [B, S, ch, C]
ModelApply = Callable[..., torch.Tensor]

# batches of chunks per segment: a slab is finalised after each segment
_SEG_BATCHES = 8
TRANSPORTS = ("f32", "int16", "device")


@dataclasses.dataclass(frozen=True)
class DemixSpec:
    """Static chunking parameters."""

    chunk_size: int
    num_overlap: int = 2
    batch_size: int = 4
    num_stems: int = 1
    num_channels: int = 2
    # plain averaging, zero tail padding, no fade window and no outer
    # border padding
    demucs_mode: bool = False

    @property
    def step(self) -> int:
        return self.chunk_size // self.num_overlap

    @property
    def border(self) -> int:
        return 0 if self.demucs_mode else self.chunk_size - self.step

    @property
    def fade_size(self) -> int:
        return self.chunk_size // 10

    def n_chunks(self, length: int) -> int:
        """The chunks a demix of a ``length``-sample song runs, the reflect
        border included."""
        if self.border > 0 and length > 2 * self.border:
            length += 2 * self.border
        return max(1, -(-length // self.step))


def _windows(spec: DemixSpec) -> np.ndarray:
    """(3, chunk) stack: [interior, first-chunk, last-chunk] blend windows."""
    c, f = spec.chunk_size, spec.fade_size
    if spec.demucs_mode:
        return np.ones((3, c), dtype=np.float32)
    base = fade_window(c, f).numpy()
    first = base.copy()
    first[:f] = 1.0
    last = base.copy()
    last[-f:] = 1.0
    return np.stack([base, first, last]).astype(np.float32)


def _chunk(mix: torch.Tensor, start: int, c: int, demucs_mode: bool = False) -> torch.Tensor:
    """Chunk at ``start`` of the (ch, L) mix; a short tail is reflected when
    more than half a chunk remains, else (and always in demucs mode)
    zero-padded."""
    m = min(max(mix.shape[-1] - start, 0), c)
    sliced = mix[:, start:start + m]
    if m == c:
        return sliced
    if m > c // 2 and not demucs_mode:
        k = torch.arange(m, c, device=mix.device)
        return torch.cat([sliced, sliced[:, 2 * m - 2 - k]], dim=-1)
    return F.pad(sliced, (0, c - m))


def upload_mix(mix, device=None) -> torch.Tensor:
    """A (channels, T) song on the device, once, for several demix calls.

    Audio decoded from 16-bit PCM is exactly ``n / 32768``: it crosses as
    int16 (half the bytes) and is rescaled on the device by 1/32768, which
    is bit-exact since the scale is a power of two. Anything else crosses as
    f32. On CUDA the copy is queued from pinned memory and does not wait for
    the device's queue (sesa_tpu/runtime/demix.py:347-362, 629-640)."""
    dev = get_device(device)
    mix = np.asarray(mix, dtype=np.float32)
    if mix.ndim != 2:
        raise ValueError(f"mix must be (channels, T), got {mix.shape}")
    scaled = mix * 32768.0
    host = None
    if np.all(np.abs(scaled) <= 32767):
        as_int = scaled.astype(np.int16)
        if np.array_equal(as_int.astype(np.float32), scaled):
            host = torch.from_numpy(as_int)
    exact16 = host is not None
    if not exact16:
        host = torch.from_numpy(mix)
    out = to_device(host, dev) if dev.type == "cuda" else host.clone()
    return out.float() * (1.0 / 32768.0) if exact16 else out


@dataclasses.dataclass
class _Slab:
    """One finalised slab: ``data`` (S, ch, needed) f32 or int16 with its
    device scale, and, for host transports, its pending host copy."""

    data: torch.Tensor
    scale: Optional[torch.Tensor] = None
    host: Optional[torch.Tensor] = None
    host_scale: Optional[torch.Tensor] = None
    done: Optional["torch.cuda.Event"] = None


def _copy_to_host(t: torch.Tensor, copy_stream):
    """Queue ``t``'s device -> host copy into pinned memory on ``copy_stream``
    after the compute stream's work so far; returns (host tensor, event).
    ``record_stream`` keeps the caching allocator from reusing ``t`` before
    the copy has read it. On the CPU the tensor is its own host copy."""
    if t.device.type != "cuda":
        return t, None
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(t.device))
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with torch.cuda.stream(copy_stream):
        copy_stream.wait_event(ready)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(copy_stream)
    t.record_stream(copy_stream)
    return host, done


_COPY_STREAMS = {}


def _copy_stream(dev: torch.device):
    if dev.type != "cuda":
        return None
    if dev not in _COPY_STREAMS:
        _COPY_STREAMS[dev] = torch.cuda.Stream(dev)
    return _COPY_STREAMS[dev]


def _quant16(slab: torch.Tensor):
    """Scaled int16 codes of a slab and its f32 scale m = max(max|s|, 1e-12):
    q = clip(round(s·32767/m), ±32767). torch.amax propagates NaN, so a
    non-finite sample makes the scale non-finite and the dequantised slab
    non-finite (the codes of a NaN are undefined, the scale carries it)."""
    m = slab.abs().amax().clamp_min(1e-12)
    q = torch.clamp(torch.round(slab * (32767.0 / m)), -32767.0, 32767.0)
    return q.to(torch.int16), m


class DemixJob:
    """A dispatched separation whose output has not been assembled yet
    (sesa_tpu/runtime/demix.py:461-535).

    ``slabs[si]`` is segment si's finalised slab, or None for a slab that
    lies wholly inside the reflect border (kept so indices stay positional).
    Host transports queued each slab's copy when it was finalised; starting
    a second job before collecting the first lets the first's copies hide
    behind the second's compute."""

    def __init__(self, spec: DemixSpec, slabs: List[Optional[_Slab]], slab_len: int, lo: int,
                 hi: int, transport: str):
        self.spec, self.slabs, self.slab_len = spec, slabs, slab_len
        self.lo, self.hi, self.transport = lo, hi, transport

    def _parts(self):
        """(slab, crop start, crop end, output start) of each slab with real
        samples."""
        for si, slab in enumerate(self.slabs):
            if slab is None:  # border-only slab skipped at dispatch
                continue
            s0 = si * self.slab_len
            c0, c1 = max(s0, self.lo), min(s0 + slab.data.shape[-1], self.hi)
            if c0 < c1:
                yield slab, c0 - s0, c1 - s0, c0 - self.lo

    def collect_device(self, stems: Optional[Sequence[int]] = None) -> torch.Tensor:
        """The f32 stems ``(S, ch, T)`` (or ``(len(stems), ch, T)``) assembled
        on the device, no host copy; an int16 job's slabs are dequantised
        there. A job meant for this should be started with
        ``transport="device"``: the host transports have queued their copies
        already."""
        parts = []
        for slab, a, b, _ in self._parts():
            part = slab.data[..., a:b]
            if stems is not None:
                part = part[list(stems)]
            if slab.scale is not None:
                part = part.float() * (slab.scale / 32767.0)
            parts.append(part.float())
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)

    def collect(self) -> np.ndarray:
        """The stems ``(S, ch, T)`` as a numpy f32 array: waits for each
        slab's host copy (a device job is copied here, at once)."""
        spec = self.spec
        est = np.empty((spec.num_stems, spec.num_channels, self.hi - self.lo), dtype=np.float32)
        for slab, a, b, o in self._parts():
            with span("sesa.sync.to_host"):
                if slab.host is None:  # a "device" job collected on the host anyway
                    data = slab.data.cpu()
                    scale = None if slab.scale is None else slab.scale.cpu()
                else:
                    if slab.done is not None:
                        slab.done.synchronize()
                    data, scale = slab.host, slab.host_scale
            part = data.numpy()[..., a:b]
            if scale is not None:
                # the JAX collect's factor: a Python float, f32 in the product;
                # the scale is in host memory here (its copy is covered by the
                # data's event), so reading it waits for nothing
                part = part.astype(np.float32) * (float(scale) / 32767.0)
            est[..., o:o + b - a] = part
        return est


def _mesh_share(mesh, batch_size: int):
    """(data group, first, last) of this rank's share of each batch."""
    if mesh is None:
        return None, 0, batch_size
    data = mesh["data"] if mesh.ndim > 1 else mesh
    size, coord = data.size(), data.get_local_rank()
    if batch_size % size:
        raise ValueError(f"batch_size {batch_size} must be divisible by the mesh data axis "
                         f"({size}) for sharded demix")
    share = batch_size // size
    return data.get_group(), coord * share, (coord + 1) * share


def demix_start(model_apply: ModelApply, params, mix, spec: DemixSpec, *, device=None,
                mesh=None, progress_cb: Optional[Callable[[float], None]] = None,
                seg_batches: int = _SEG_BATCHES, affine: Optional[tuple] = None,
                transport: str = "f32") -> DemixJob:
    """Queue a separation and return its :class:`DemixJob` (see :func:`demix`)
    without waiting for the device: nothing on this path reads a device
    value. ``mix`` is a numpy array (uploaded by :func:`upload_mix`) or a
    tensor, e.g. one :func:`upload_mix` returned, shared by several jobs."""
    if transport not in TRANSPORTS:
        raise ValueError(f"transport must be one of {TRANSPORTS}, got {transport!r}")
    dev = get_device(device)
    group, share0, share1 = _mesh_share(mesh, spec.batch_size)
    c, step, border, b = spec.chunk_size, spec.step, spec.border, spec.batch_size
    with span("sesa.upload"):
        if isinstance(mix, torch.Tensor):
            mix_t = mix.to(device=dev, dtype=torch.float32)
        else:
            mix_t = upload_mix(mix, dev)
        if mix_t.ndim != 2:
            raise ValueError(f"mix must be (channels, T), got {tuple(mix_t.shape)}")
        if affine is not None:
            mix_t = (mix_t - float(affine[0])) / float(affine[1])
        length_init = mix_t.shape[-1]
        padded = border > 0 and length_init > 2 * border
        if padded:
            mix_t = F.pad(mix_t[None], (border, border), mode="reflect")[0]
    length = mix_t.shape[-1]

    n_chunks = spec.n_chunks(length_init)
    n_batches = -(-n_chunks // b)
    n_segments = -(-n_batches // seg_batches)
    slab_len = seg_batches * b * step
    # the accumulators reach the last chunk and the last segment's whole slab
    l_buf = max((n_chunks - 1) * step + c, n_segments * slab_len)
    result = torch.zeros((spec.num_stems, spec.num_channels, l_buf), device=dev)
    counter = torch.zeros((l_buf,), device=dev)
    windows = to_device(_windows(spec), dev)
    lo, hi = (border, length - border) if padded else (0, length_init)
    copy_stream = _copy_stream(dev) if transport != "device" else None

    slabs: List[Optional[_Slab]] = []
    with span("sesa.dispatch"):
        for si in range(n_segments):
            for bi in range(si * seg_batches, min((si + 1) * seg_batches, n_batches)):
                ids = range(bi * b + share0, min(bi * b + share1, n_chunks))
                if len(ids):
                    chunks = torch.stack([_chunk(mix_t, i * step, c, spec.demucs_mode)
                                          for i in ids])
                    with span("sesa.model"):
                        out = model_apply(params, chunks).float()  # (B, S, ch, C)
                    for j, i in enumerate(ids):
                        win = windows[1 if i == 0 else 2 if i == n_chunks - 1 else 0]
                        result[..., i * step:i * step + c] += out[j] * win
                        counter[i * step:i * step + c] += win
                if progress_cb is not None:  # by batch (the JAX engine reports by segment)
                    progress_cb((bi + 1) / n_batches)
            s0 = si * slab_len
            needed = min(slab_len, hi - s0)
            if needed <= 0 or s0 + needed <= lo:
                # a slab wholly inside the reflect border (trailing when needed
                # <= 0, leading at high overlap) carries no real samples
                slabs.append(None)
            else:
                r = result[..., s0:s0 + needed]
                cnt = counter[s0:s0 + needed]
                if group is not None:  # sum the ranks' shares of the final span
                    r, cnt = r.contiguous(), cnt.contiguous()
                    torch.distributed.all_reduce(r, group=group)
                    torch.distributed.all_reduce(cnt, group=group)
                est = torch.where(cnt > 0, r / torch.where(cnt > 0, cnt, 1.0), 0.0)
                slab = _Slab(est)
                if transport == "int16":
                    slab.data, slab.scale = _quant16(est)
                if transport != "device":
                    if slab.scale is not None:  # first: the data's event then covers both
                        slab.host_scale, _ = _copy_to_host(slab.scale, copy_stream)
                    slab.host, slab.done = _copy_to_host(slab.data, copy_stream)
                slabs.append(slab)
    return DemixJob(spec, slabs, slab_len, lo, hi, transport)


def demix(model_apply: ModelApply, params, mix, spec: DemixSpec, *, device=None, mesh=None,
          progress_cb: Optional[Callable[[float], None]] = None,
          seg_batches: int = _SEG_BATCHES, affine: Optional[tuple] = None,
          transport: str = "f32",
          stems: Optional[Sequence[int]] = None) -> Union[np.ndarray, torch.Tensor]:
    """Separate ``mix`` (channels, T) into ``(num_stems, channels, T)`` stems.

    Runs on CUDA unless ``device="cpu"``. ``mix`` is a numpy array or a
    tensor (one already on the device is used where it lies).
    ``affine=(mean, std)`` normalises the mix on the device as
    (x - mean) / std. ``transport`` "f32" and "int16" return numpy
    (``demix_start(...).collect()``); "device" returns the f32 tensor on
    the device (``collect_device``). ``stems`` selects a subset of the
    stems, in the order given. ``mesh``: see the module docstring.
    """
    job = demix_start(model_apply, params, mix, spec, device=device, mesh=mesh,
                      progress_cb=progress_cb, seg_batches=seg_batches, affine=affine,
                      transport=transport)
    if transport == "device":
        return job.collect_device(stems)
    out = job.collect()
    return out if stems is None else out[list(stems)]


def _flip(a, axis: int):
    return a.flip(axis) if isinstance(a, torch.Tensor) else np.flip(a, axis).copy()


def apply_tta(model_apply: ModelApply, params, mix, stems, spec: DemixSpec, **demix_kwargs):
    """Test-time augmentation (reference utils.py:241-292): the channel-swapped
    result is swapped back and added, the polarity-inverted one subtracted,
    and the total divided by 3. ``mix`` and ``stems`` are numpy arrays or
    tensors (a device mix is flipped and negated on the device); ``stems``
    is of the kind that ``demix_kwargs``' transport gives."""
    if not isinstance(mix, torch.Tensor):
        mix = np.asarray(mix, dtype=np.float32)
    swapped = demix(model_apply, params, _flip(mix, 0), spec, **demix_kwargs)
    stems = stems + _flip(swapped, 1)
    inv_kwargs = dict(demix_kwargs)
    if inv_kwargs.get("affine") is not None:
        # -((x - m)/s) == ((-x) - (-m))/s: negate the raw mix, flip the mean
        m, s = inv_kwargs["affine"]
        inv_kwargs["affine"] = (-m, s)
    inverted = demix(model_apply, params, -mix, spec, **inv_kwargs)
    return (stems - inverted) / 3.0
