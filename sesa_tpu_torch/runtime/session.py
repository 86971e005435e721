"""Inference sessions (counterpart of sesa_tpu/runtime/session.py): a model,
its config, its weights on the device and a DemixSpec in one object whose
``separate`` runs a whole song."""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from sesa_tpu_torch import get_device
from sesa_tpu_torch.configs import load_config
from sesa_tpu_torch.convert import convert_checkpoint, load_torch_state_dict
from sesa_tpu_torch.models import get_model
from sesa_tpu_torch.runtime.demix import TRANSPORTS, DemixSpec, apply_tta, demix
from sesa_tpu_torch.runtime.profiling import span
from sesa_tpu_torch.tree import tree_map


Audio = Union[np.ndarray, torch.Tensor]


def normalize_audio(audio: Audio):
    """Mono-statistics normalisation (reference utils.py:199-217): the audio
    less the mono mix's mean over its (biased) std, and the statistics."""
    mono = audio.mean(0)
    if isinstance(mono, torch.Tensor):
        mean, std = float(mono.mean()), float(mono.std(correction=0))
    else:
        mean, std = mono.mean(), mono.std()
    return (audio - mean) / std, {"mean": mean, "std": std}


def denormalize_audio(audio: Audio, norm: Dict[str, float]) -> Audio:
    return audio * norm["std"] + norm["mean"]


def prefer_target_instrument(config) -> List[str]:
    """reference utils.py:480-499 (tolerant of configs without training)."""
    training = dict(config).get("training", {}) or {}
    if training.get("target_instrument"):
        return [training["target_instrument"]]
    if training.get("instruments"):
        return list(training["instruments"])
    return ["restored"]


def demix_spec(config, model_type: str, chunk_size: Optional[int] = None,
               num_overlap: Optional[int] = None, batch_size: Optional[int] = None,
               num_channels: Optional[int] = None) -> DemixSpec:
    """The demix chunking a config gives a model; an argument that is given
    (not None or 0) overrides the config's value. htdemucs chunks by its
    training segment and averages plainly (sesa_tpu session.py:87-98)."""
    audio_cfg = config.get("audio", {}) or {}
    inference_cfg = config.get("inference", {}) or {}
    training_cfg = config.get("training", {}) or {}
    demucs_mode = model_type == "htdemucs"
    if demucs_mode:
        chunk = int(training_cfg["samplerate"] * training_cfg["segment"])
        stems = len(training_cfg["instruments"])
    else:
        chunk = int(chunk_size or audio_cfg.get("chunk_size") or 352800)
        stems = len(prefer_target_instrument(config))
    return DemixSpec(
        chunk_size=chunk,
        num_overlap=int(num_overlap or inference_cfg.get("num_overlap", 2)),
        batch_size=int(batch_size or inference_cfg.get("batch_size", 4)),
        num_stems=stems,
        num_channels=int(num_channels or audio_cfg.get("num_channels", 2)),
        demucs_mode=demucs_mode,
    )


@dataclasses.dataclass
class InferenceSession:
    model_type: str
    config: object
    params: object
    spec: DemixSpec
    device: torch.device
    compute_dtype: Optional[torch.dtype] = torch.bfloat16
    # separations rerun in f32 because bf16 gave non-finite output
    rescues: int = 0
    # {compute dtype: the model's prepared weights}, for models with a
    # ``prepare`` step (casts and layout changes done once, not per call)
    _prepared: dict = dataclasses.field(default_factory=dict, repr=False)
    # a parallel.make_mesh DeviceMesh: every rank separates with the same
    # arguments, chunks split over its data axis (runtime.demix)
    mesh: Optional[object] = None

    @classmethod
    def create(cls, model_type: str, config_path, checkpoint_path: str = "", *,
               chunk_size: Optional[int] = None, num_overlap: Optional[int] = None,
               batch_size: Optional[int] = None, num_channels: Optional[int] = None,
               compute_dtype: Optional[torch.dtype] = torch.bfloat16, device=None,
               mesh=None, seed: int = 0) -> "InferenceSession":
        """Load config and weights (or init from ``seed`` without a checkpoint)
        and move the weights to ``device``: CUDA unless "cpu" is asked for.
        With ``mesh`` each rank holds the whole weights and separations split
        their chunks over the mesh's data axis (sesa_tpu session.py:57-104)."""
        dev = get_device(device)
        config = load_config(model_type, config_path)
        model = get_model(model_type)
        if checkpoint_path:
            params = convert_checkpoint(model_type, load_torch_state_dict(checkpoint_path),
                                        config)
        else:
            params = model.init(torch.Generator().manual_seed(seed), config)
        params = tree_map(lambda p: p.to(device=dev, dtype=torch.float32), params)
        spec = demix_spec(config, model_type, chunk_size, num_overlap, batch_size, num_channels)
        return cls(model_type, config, params, spec, dev, compute_dtype, mesh=mesh)

    @property
    def instruments(self) -> List[str]:
        if self.spec.demucs_mode:
            return list(self.config.training.instruments)
        return prefer_target_instrument(self.config)

    @property
    def sample_rate(self) -> int:
        """``audio.sample_rate``, else ``model.sr`` (Apollo). An htdemucs
        config names its variant in ``model`` as a string, so without an
        ``audio`` section this raises, as the JAX session does."""
        sr = (self.config.get("audio", {}) or {}).get("sample_rate")
        if sr is None:
            sr = (self.config.get("model", {}) or {}).get("sr", 44100)
        return int(sr)

    def _model_apply(self, compute_dtype):
        """The per-chunk-batch function demix calls. A model whose ``apply``
        takes no ``compute_dtype`` (ConformerMSS, scnet_unofficial) is called
        without one, on the f32 weights, whatever the session's dtype
        (sesa_tpu session.py:138-153). This is a signature check, not
        try/except: an error raised inside a model must surface."""
        model = get_model(self.model_type)
        config, stems = self.config, self.spec.num_stems
        prepare = getattr(model, "prepare", None)
        accepts_dtype = "compute_dtype" in inspect.signature(model.apply).parameters
        kw = {"compute_dtype": compute_dtype} if accepts_dtype else {}

        def apply_fn(params, chunks):
            if accepts_dtype and prepare is not None and params is self.params:
                if compute_dtype not in self._prepared:
                    self._prepared[compute_dtype] = prepare(params, config, compute_dtype)
                params = self._prepared[compute_dtype]
            with torch.inference_mode():
                out = model.apply(params, config, chunks, **kw)
            if out.ndim == 3:  # single-stem models may squeeze
                out = out[:, None]
            if out.shape[1] != stems:
                raise ValueError(f"model gave {out.shape[1]} stems, config names {stems}")
            return out

        return apply_fn

    def _as_channels(self, mix: Audio) -> Audio:
        """(T,) or (channels, T) audio as f32 (channels, T); a mono input is
        repeated when the model takes two channels."""
        if not isinstance(mix, torch.Tensor):
            mix = np.asarray(mix, dtype=np.float32)
        if mix.ndim == 1:
            mix = mix[None]
        if mix.shape[0] == 1 and self.spec.num_channels == 2:
            mix = mix.expand(2, -1) if isinstance(mix, torch.Tensor) else np.repeat(mix, 2, axis=0)
        return mix

    def separate(self, mix: Audio, *, use_tta: bool = False,
                 progress_cb: Optional[Callable[[float], None]] = None,
                 transport: str = "f32", mix_device: Optional[torch.Tensor] = None
                 ) -> Dict[str, Audio]:
        """(channels, T) -> {instrument: (channels, T)} separated stems.

        Mirrors reference run_folder (inference.py:84-132): optional
        mono-statistics normalisation, demix, optional TTA, denormalise. A
        bf16 separation with non-finite output is rerun in f32 and counted
        in ``rescues`` (sesa_tpu session.py:212-220).

        ``mix`` is a numpy array or a tensor (one on the session's device is
        used where it lies). ``mix_device`` (from ``runtime.upload_mix``) is
        the same song already on the device, shared by several sessions: the
        statistics come from ``mix``, the demix from ``mix_device``, and a
        channel fix-up that changes the shape drops it.

        ``transport="f32"`` (the default, bf16 sessions included: over PCIe
        the f32 copy is cheap, ROADMAP.md §3) keeps the stems on the device
        until the end and copies them to numpy arrays; ``"int16"`` moves
        each slab as scaled int16 (about 90 dB below its peak) and returns
        numpy arrays; ``"device"`` returns the f32 tensors, so that a chain
        of stages never crosses to the host. The rescue check reads one flag
        from the device, or the numpy stems of an int16 run. The rescue and
        its TTA run with an exact transport.

        Under a ``torch.profiler`` the call records its phases as host spans
        (``runtime.profiling.span``): ``sesa.separate`` around it all,
        demix's ``sesa.upload``, ``sesa.dispatch`` and ``sesa.model``, and a
        ``sesa.sync.<what>`` span at each place where the host waits for
        the device.
        """
        with span("sesa.separate"):
            return self._separate(mix, use_tta, progress_cb, transport, mix_device)

    def _separate(self, mix, use_tta, progress_cb, transport, mix_device):
        if transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}, got {transport!r}")
        mix = self._as_channels(mix)
        if mix_device is not None and tuple(mix_device.shape) != tuple(mix.shape):
            mix_device = None  # the channel fix-up changed the shape: demix uploads mix

        norm = affine = None
        if bool((self.config.get("inference", {}) or {}).get("normalize", False)):
            mono = mix.mean(0)
            if isinstance(mono, torch.Tensor):
                with span("sesa.sync.stats"):
                    norm = {"mean": float(mono.mean()), "std": float(mono.std(unbiased=False))}
            else:
                norm = {"mean": float(mono.mean()), "std": float(mono.std())}
            affine = (norm["mean"], norm["std"])

        # the engine's transport: int16 as asked, else the stems stay on the
        # device until the end
        engine = "int16" if transport == "int16" else "device"
        kw = dict(device=self.device, mesh=self.mesh, affine=affine)
        src = mix if mix_device is None else mix_device
        apply_fn = self._model_apply(self.compute_dtype)
        stems = demix(apply_fn, self.params, src, self.spec, progress_cb=progress_cb,
                      transport=engine, **kw)
        lossy = self.compute_dtype not in (None, torch.float32)
        if isinstance(stems, np.ndarray):
            finite = np.isfinite(stems).all()
        else:
            with span("sesa.sync.rescue"):
                finite = bool(torch.isfinite(stems).all())
        if lossy and not finite:
            print("non-finite output under bf16; retrying in float32")
            self.rescues += 1
            self.compute_dtype = None
            apply_fn = self._model_apply(None)
            engine = "device"  # the rescue is exact end to end, TTA included
            stems = demix(apply_fn, self.params, src, self.spec, progress_cb=progress_cb,
                          transport=engine, **kw)
        if use_tta:
            stems = apply_tta(apply_fn, self.params, src, stems, self.spec, transport=engine,
                              **kw)
        # final scrub after the rescue decision (reference utils.py:459)
        if isinstance(stems, np.ndarray):
            stems = np.nan_to_num(stems)
        else:
            stems = torch.nan_to_num(stems)
        if norm is not None:
            stems = denormalize_audio(stems, norm)
        if transport == "f32":
            with span("sesa.sync.to_host"):
                stems = stems.cpu().numpy()
        return {name: stems[i] for i, name in enumerate(self.instruments)}

    def separate_with_extras(self, mix: Audio, *, use_tta: bool = False,
                             extract_instrumental: bool = False,
                             demud_phaseremix_inst: bool = False,
                             progress_cb=None, transport: str = "f32",
                             mix_device: Optional[torch.Tensor] = None) -> Dict[str, Audio]:
        """separate() plus the reference CLI's derived outputs (reference
        inference.py:103-126): instrumental = mix − vocals, and the demud
        phase-remix re-separation. ``mix_device`` serves the first
        separation only, as in the JAX session. The derived stems are worked
        out inside a ``sesa.extras`` span."""
        mix_orig = self._as_channels(mix)
        if transport == "device":  # the derived stems are sums with the stems' kind
            with span("sesa.sync.upload"):  # from pageable memory: the stream drains first
                mix_orig = torch.as_tensor(mix_orig, device=self.device)
        elif isinstance(mix_orig, torch.Tensor):
            with span("sesa.sync.to_host"):
                mix_orig = mix_orig.cpu().numpy()
        kw = dict(use_tta=use_tta, transport=transport)

        waveforms = self.separate(mix_orig, progress_cb=progress_cb, mix_device=mix_device, **kw)
        instruments = list(waveforms)
        instr = "vocals" if "vocals" in instruments else instruments[0]
        with span("sesa.extras"):
            if demud_phaseremix_inst:
                if not any(i.lower() == "instrumental" for i in instruments):
                    second = self.separate(mix_orig - 2 * waveforms[instr], **kw)
                    waveforms["instrumental_phaseremix"] = mix_orig + second[instr]
                else:
                    mix_mod = 2 * waveforms[instr] - mix_orig
                    second = self.separate(mix_mod, **kw)
                    waveforms["instrumental_phaseremix"] = mix_orig + mix_mod - second[instr]
            if extract_instrumental and "instrumental" not in waveforms:
                waveforms["instrumental"] = mix_orig - waveforms[instr]
        return waveforms
