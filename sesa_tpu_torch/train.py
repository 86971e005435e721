"""Training: config-parsed optimizer, schedule and loss, the train step,
checkpoints and validation (counterpart of sesa_tpu/train.py).

The reference's PyTorch-Lightning scaffold (reference
models/bandit/core/__init__.py:61-743: ``parse_optimizer_config`` :73-100,
``parse_loss_config`` :125-136, ``training_step`` :336-353, fader-based
validation :363-433) as the JAX package has it, in eager PyTorch:

- torch optimizer and scheduler names parse to what the JAX package's optax
  transforms compute. Adam, AdamW and SGD are torch's own classes, which
  compute the same update. RMSprop, Adagrad, Adamax, NAdam and RAdam differ
  from optax's rules of the same names (eps inside the square root,
  Adagrad's accumulator starting at 0.1, Dozat's NAdam, RAdam's threshold),
  so their optax rules are written out here as ``torch.optim.Optimizer``
  subclasses;
- losses come from :mod:`sesa_tpu_torch.losses`;
- one train step runs the augmentor on the host, uploads the batch, and runs
  forward, loss and backward inside one ``net_precision`` block, so that the
  backward pass runs under the f32 net's TF32 policy (off) too; the model's
  ``apply`` is called directly, with no prepared-weight cache and no
  ``inference_mode``;
- with a mesh (``parallel.make_mesh``) every rank runs its share of the
  batch, the gradients and the loss are averaged over the data axis, and a
  layout rule splits the transformer weights over the model axis as
  DTensors (``parallel.shard_params``; with a model axis of size 1 they
  stay plain tensors); checkpoints are written whole;
- validation runs the port's chunked overlap-add engine
  (:func:`sesa_tpu_torch.runtime.demix`) under ``torch.no_grad`` and the
  chunk-median metrics of :mod:`sesa_tpu_torch.metrics`;
- checkpoints are one flat ``.npz`` (params by flat name, the optimizer's
  state tensors in a fixed order with a JSON description, the step and an
  extra JSON blob), written atomically, failing loudly on structure drift.
  A checkpoint that the JAX ``Trainer`` wrote loads too: its params go
  through ``convert.from_jax.params_from_jax``; its optax state cannot be
  carried into a torch optimizer and is refused.

The hand-written CUDA kernels have no backward pass (the JAX package's
Pallas kernels have none either): a wrapper raises when autograd would
record its launch (``ops._build.refuse_autograd``). Every model's f32 path
launches none, except bs_mamba2's, which reaches K8, so bs_mamba2 trains on
the CPU only until both packages have a backward kernel.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from sesa_tpu_torch import get_device
from sesa_tpu_torch import losses as losses_mod
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.ops.prec import net_precision
from sesa_tpu_torch.parallel.mesh import is_dtensor
from sesa_tpu_torch.tree import tree_map

__all__ = [
    "parse_optimizer_config", "parse_loss_config", "ReduceLROnPlateau",
    "Trainer", "save_checkpoint", "load_checkpoint", "TrainOptimizer",
]


# ---------------------------------------------------------------------------
# Schedules (optax step semantics: step 0 uses schedule(0))
# ---------------------------------------------------------------------------

def _schedule_from_config(base_lr: float, spec: Optional[Dict[str, Any]]
                          ) -> Callable[[int], float]:
    """torch lr_scheduler names -> a schedule ``step -> lr``, the values of
    the JAX package's optax schedules. ``ReduceLROnPlateau`` is driven by a
    metric, not the step: it is :class:`ReduceLROnPlateau` on the host and
    is refused here, as in the JAX package."""
    if not spec:
        return lambda step: base_lr
    name = spec["name"]
    kw = dict(spec.get("kwargs", {}))
    if name == "StepLR":  # optax.exponential_decay(staircase=True)
        size, gamma = int(kw["step_size"]), float(kw.get("gamma", 0.1))
        return lambda step: base_lr if step <= 0 else base_lr * gamma ** (step // size)
    if name == "ExponentialLR":
        gamma = float(kw["gamma"])
        return lambda step: base_lr if step <= 0 else base_lr * gamma ** step
    if name == "CosineAnnealingLR":
        # torch's closed form, which is periodic: past T_max the LR climbs back
        t_max = int(kw["T_max"])
        eta_min = float(kw.get("eta_min", 0.0))
        return lambda step: eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * step / t_max))
    if name == "LinearLR":  # optax.linear_schedule
        start = base_lr * float(kw.get("start_factor", 1.0 / 3.0))
        end = base_lr * float(kw.get("end_factor", 1.0))
        total = int(kw.get("total_iters", 5))
        if total <= 0:
            return lambda step: start
        return lambda step: (start - end) * (1 - min(max(step, 0), total) / total) + end
    if name == "ConstantLR":
        # the JAX package holds the base LR and ignores factor / total_iters
        return lambda step: base_lr
    if name == "ReduceLROnPlateau":
        raise ValueError(
            "ReduceLROnPlateau is metric-driven: construct "
            "sesa_tpu_torch.train.ReduceLROnPlateau and feed its scale to "
            "Trainer.set_lr_scale (reference parses it specially too, "
            "core/__init__.py:95-97)")
    raise NameError(f"unknown scheduler {name!r}")


# ---------------------------------------------------------------------------
# optax's update rules that torch's classes of the same names do not compute
# ---------------------------------------------------------------------------

def _bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay ** count``, taken in f32 as optax takes it."""
    f32 = np.float32
    return float(f32(1) - f32(decay) ** f32(count))


class _OptaxRule(torch.optim.Optimizer):
    """Base of the optax rules: a group holds ``lr`` (the schedule's value)
    and ``lr_scale``; the final update is ``rule(g) · lr_scale`` added to the
    parameter, in the order optax's chain and the JAX ``Trainer`` apply
    them."""

    def __init__(self, params, **defaults):
        super().__init__(params, dict(defaults, lr_scale=1.0))

    def _update(self, p, g, state, group) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{type(self).__name__} takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                u = self._update(p, p.grad, state, group)
                p.add_(u * group["lr_scale"])


class OptaxRMSprop(_OptaxRule):
    """optax.rmsprop as the JAX package calls it: ν = (1-decay)·g² + decay·ν,
    u = -lr · g / sqrt(ν + eps) (eps inside the root, torch's is outside),
    then optax's trace of the lr-scaled update with ``momentum`` (the JAX
    package always passes a momentum, 0.0 by default)."""

    def __init__(self, params, lr, alpha=0.99, eps=1e-8, momentum=0.0):
        super().__init__(params, lr=lr, alpha=alpha, eps=eps, momentum=momentum)

    def _update(self, p, g, state, group):
        if not state:
            state["nu"] = torch.zeros_like(p)
            state["trace"] = torch.zeros_like(p)
        decay = group["alpha"]
        state["nu"] = (1 - decay) * g ** 2 + decay * state["nu"]
        u = -group["lr"] * (torch.rsqrt(state["nu"] + group["eps"]) * g)
        state["trace"] = u + group["momentum"] * state["trace"]
        return state["trace"]


class OptaxAdagrad(_OptaxRule):
    """optax.adagrad: the sum of squares starts at 0.1 (torch's at 0), u =
    -lr · g / sqrt(s + eps) where s > 0, else 0."""

    def __init__(self, params, lr, eps=1e-10, initial_accumulator_value=0.1):
        super().__init__(params, lr=lr, eps=eps,
                         initial_accumulator_value=initial_accumulator_value)

    def _update(self, p, g, state, group):
        if not state:
            state["sum_of_squares"] = torch.full_like(p, group["initial_accumulator_value"])
        s = g * g + state["sum_of_squares"]
        state["sum_of_squares"] = s
        inv = torch.where(s > 0, torch.rsqrt(s + group["eps"]), torch.zeros_like(s))
        return -group["lr"] * (inv * g)


class _OptaxMoments(_OptaxRule):
    """Shared state of the Adam-like rules: the count and the two moments."""

    def _moments(self, p, state):
        if not state:
            state["count"] = 0
            state["mu"] = torch.zeros_like(p)
            state["nu"] = torch.zeros_like(p)
        state["count"] += 1
        return state["count"]


class OptaxAdamax(_OptaxMoments):
    """optax.adamax: μ = (1-b1)·g + b1·μ, ν = max(|g| + eps, b2·ν), u = -lr ·
    (μ / (1 - b1^t)) / ν."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, lr=lr, betas=tuple(betas), eps=eps)

    def _update(self, p, g, state, group):
        t = self._moments(p, state)
        b1, b2 = group["betas"]
        state["mu"] = (1 - b1) * g + b1 * state["mu"]
        state["nu"] = torch.maximum(g.abs() + group["eps"], b2 * state["nu"])
        mu_hat = state["mu"] / _bias_correction(b1, t)
        return -group["lr"] * (mu_hat / state["nu"])


class OptaxNAdam(_OptaxMoments):
    """optax.nadam (Dozat's NAdam, without torch's momentum-decay schedule):
    μ̂ = b1·μ/(1 - b1^(t+1)) + (1-b1)·g/(1 - b1^t), ν̂ = ν/(1 - b2^t), u = -lr ·
    μ̂ / (sqrt(ν̂) + eps)."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, lr=lr, betas=tuple(betas), eps=eps)

    def _update(self, p, g, state, group):
        t = self._moments(p, state)
        b1, b2 = group["betas"]
        state["mu"] = (1 - b1) * g + b1 * state["mu"]
        state["nu"] = (1 - b2) * g ** 2 + b2 * state["nu"]
        mu_hat = (b1 * (state["mu"] / _bias_correction(b1, t + 1))
                  + (1 - b1) * (g / _bias_correction(b1, t)))
        nu_hat = state["nu"] / _bias_correction(b2, t)
        return -group["lr"] * (mu_hat / (torch.sqrt(nu_hat) + group["eps"]))


class OptaxRAdam(_OptaxMoments):
    """optax.radam: Adam's moments; while the variance's degrees of freedom ρ
    are below the threshold 5 the update is -lr · μ̂, after it -lr · r · μ̂ /
    (sqrt(ν̂) + eps) with the rectification r. ρ and r are taken in f32, as
    optax takes them."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8, threshold=5.0):
        super().__init__(params, lr=lr, betas=tuple(betas), eps=eps, threshold=threshold)

    def _update(self, p, g, state, group):
        t = self._moments(p, state)
        b1, b2 = group["betas"]
        state["mu"] = (1 - b1) * g + b1 * state["mu"]
        state["nu"] = (1 - b2) * g ** 2 + b2 * state["nu"]
        mu_hat = state["mu"] / _bias_correction(b1, t)
        nu_hat = state["nu"] / _bias_correction(b2, t)
        f32 = np.float32
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = f32(b2) ** f32(t)
        ro = f32(ro_inf) - f32(2 * t) * b2t / (f32(1) - b2t)
        if not ro >= group["threshold"]:
            return -group["lr"] * mu_hat
        r = float(np.sqrt((ro - f32(4)) * (ro - f32(2)) * f32(ro_inf)
                          / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))
        return -group["lr"] * (r * mu_hat / (torch.sqrt(nu_hat) + group["eps"]))


class TrainOptimizer:
    """A parsed optimizer config: ``init(leaves)`` builds its
    ``torch.optim.Optimizer`` over the parameter leaves; ``step(count,
    lr_scale)`` sets the LR to ``schedule(count)`` (optax's count: 0 on the
    first step) times ``lr_scale`` and steps."""

    def __init__(self, factory: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
                 schedule: Callable[[int], float]):
        self.schedule = schedule
        self._factory = factory
        self.optimizer: Optional[torch.optim.Optimizer] = None

    def init(self, leaves: Sequence[torch.Tensor], foreach: Optional[bool] = None
             ) -> torch.optim.Optimizer:
        """``foreach=False`` steps torch's Adam, AdamW and SGD one tensor at a
        time: their multi-tensor kernels refuse a list that mixes DTensors
        with plain tensors (a tensor-parallel trainer's leaves); the optax
        rules step one tensor at a time anyway."""
        kw = {}
        cls = getattr(self._factory, "func", self._factory)
        if foreach is not None and not (isinstance(cls, type) and issubclass(cls, _OptaxRule)):
            kw["foreach"] = foreach
        self.optimizer = self._factory(list(leaves), **kw)
        return self.optimizer

    def step(self, count: int, lr_scale: float = 1.0) -> None:
        lr = float(self.schedule(count))
        for group in self.optimizer.param_groups:
            if isinstance(self.optimizer, _OptaxRule):
                # optax scales by the schedule inside its chain (before
                # RMSprop's trace) and the Trainer by lr_scale after it
                group["lr"], group["lr_scale"] = lr, float(lr_scale)
            else:  # torch's Adam, AdamW and SGD are linear in the LR
                group["lr"] = lr * float(lr_scale)
        self.optimizer.step()


def parse_optimizer_config(config: Dict[str, Any]) -> TrainOptimizer:
    """``{"optimizer": {"name", "kwargs"}, ["scheduler": ...]}`` -> a
    :class:`TrainOptimizer` that computes what the JAX package's
    ``parse_optimizer_config`` gives (reference core/__init__.py:73-100).

    Names: Adam, AdamW, SGD, RMSprop, Adagrad, Adamax, NAdam, RAdam; kwargs
    follow torch (``lr``, ``betas``, ``eps``, ``weight_decay``,
    ``momentum``, ``nesterov``, RMSprop's ``alpha``). As in the JAX package,
    ``weight_decay`` acts on Adam (coupled, added to the gradient), AdamW
    (decoupled) and SGD only; Adagrad's eps is 1e-10 whatever the config
    says (ROADMAP.md §3); ``foreach``, ``fused`` and ``amsgrad`` are dropped
    and any other kwarg raises ``TypeError``.
    """
    ocfg = config["optimizer"]
    name = ocfg["name"]
    kw = dict(ocfg.get("kwargs", {}))
    lr = float(kw.pop("lr", 1e-3))
    schedule = _schedule_from_config(lr, config.get("scheduler"))
    betas = tuple(float(b) for b in kw.pop("betas", (0.9, 0.999)))
    eps = float(kw.pop("eps", 1e-8))
    wd = float(kw.pop("weight_decay", 0.0))

    if name == "Adam":
        factory = functools.partial(torch.optim.Adam, lr=lr, betas=betas, eps=eps,
                                    weight_decay=wd)
    elif name == "AdamW":  # torch's AdamW defaults to 0.01: pass the decay
        factory = functools.partial(torch.optim.AdamW, lr=lr, betas=betas, eps=eps,
                                    weight_decay=wd)
    elif name == "SGD":
        momentum = float(kw.pop("momentum", 0.0))
        nesterov = bool(kw.pop("nesterov", False)) and momentum != 0.0
        factory = functools.partial(torch.optim.SGD, lr=lr, momentum=momentum,
                                    nesterov=nesterov, weight_decay=wd)
    elif name == "RMSprop":
        factory = functools.partial(OptaxRMSprop, lr=lr, alpha=float(kw.pop("alpha", 0.99)),
                                    eps=eps, momentum=float(kw.pop("momentum", 0.0)))
    elif name == "Adagrad":
        # the JAX package reads kw.pop("eps", 1e-10) after eps was popped:
        # the configured eps never reaches optax
        factory = functools.partial(OptaxAdagrad, lr=lr, eps=1e-10)
    elif name == "Adamax":
        factory = functools.partial(OptaxAdamax, lr=lr, betas=betas, eps=eps)
    elif name == "NAdam":
        factory = functools.partial(OptaxNAdam, lr=lr, betas=betas, eps=eps)
    elif name == "RAdam":
        factory = functools.partial(OptaxRAdam, lr=lr, betas=betas, eps=eps)
    else:
        raise NameError(f"unknown optimizer {name!r}")

    for knob in ("foreach", "fused", "amsgrad"):  # torch-only knobs
        kw.pop(knob, None)
    if kw:
        raise TypeError(f"unsupported {name} kwargs: {sorted(kw)}")
    return TrainOptimizer(factory, schedule)


class ReduceLROnPlateau:
    """Host-side metric-driven LR scaling (torch ReduceLROnPlateau).

    Call :meth:`step` with the monitored metric after each validation and
    pass the returned factor to ``Trainer.set_lr_scale``.
    """

    def __init__(self, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, min_lr: float = 0.0,
                 base_lr: float = 1.0):
        self.mode, self.factor, self.patience = mode, factor, patience
        self.min_lr = min_lr
        self.base_lr = base_lr
        self.best: Optional[float] = None
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        better = (self.best is None
                  or (metric < self.best if self.mode == "min"
                      else metric > self.best))
        if better:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                # torch floors the effective LR at min_lr; the scale is
                # relative, so the floor is min_lr / base_lr
                floor = self.min_lr / self.base_lr if self.base_lr else 0.0
                self.scale = max(self.scale * self.factor, floor)
                self.bad_epochs = 0
        return self.scale


# ---------------------------------------------------------------------------
# Loss parsing (reference core/__init__.py:116-136)
# ---------------------------------------------------------------------------

_LOSSES: Dict[str, Callable[..., Any]] = {
    "L1Loss": lambda **kw: losses_mod.l1,
    "MSELoss": lambda **kw: (lambda r, t: torch.mean(torch.square(r - t))),
    "MultiResSTFTL1": lambda **kw: functools.partial(losses_mod.multi_res_stft_l1, **kw),
    "SignalNoisePNormRatio": lambda **kw: functools.partial(
        losses_mod.signal_noise_pnorm_ratio, **kw),
    "MultichannelSingleSrcNegSDR": lambda **kw: functools.partial(losses_mod.neg_sdr, **kw),
    "NegSDR": lambda **kw: functools.partial(losses_mod.neg_sdr, **kw),
}


def parse_loss_config(config: Dict[str, Any]) -> Callable:
    """``{"name", "kwargs"}`` -> ``loss(recon, target) -> scalar``."""
    name = config["name"]
    if name not in _LOSSES:
        raise NameError(f"unknown loss {name!r}; available: {sorted(_LOSSES)}")
    return _LOSSES[name](**dict(config.get("kwargs", {})))


# ---------------------------------------------------------------------------
# Checkpoints: one flat npz
# ---------------------------------------------------------------------------

_FORMAT = "sesa_tpu_torch.train/2"
# the first format: optimizer state paired with the parameters by position
# only (read still, as before)
_FORMAT_BY_INDEX = "sesa_tpu_torch.train/1"


def _flatten(tree, prefix=""):
    """{dotted name: leaf} in the tree's order; the JAX package's names."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[k]) for k in sorted(keys, key=int)]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; a DTensor is gathered whole first (a
    collective: every rank of its mesh calls this)."""
    if is_dtensor(t):
        t = t.full_tensor()
    return t.detach().cpu().numpy()


def _param_names(optimizer: torch.optim.Optimizer, params) -> List[str]:
    """The dotted leaf name in ``params`` of each of ``optimizer``'s
    parameters, in the optimizer's order (matched by identity)."""
    by_id = {id(leaf): name for name, leaf in _flatten(params).items()}
    names = [by_id.get(id(p)) for g in optimizer.param_groups for p in g["params"]]
    if None in names:
        raise ValueError("the optimizer steps a tensor that is not a leaf of the params")
    return names


def _optimizer_payload(optimizer: torch.optim.Optimizer, names: Sequence[str]):
    """The optimizer's state as ``opt/<param index>.<key>`` arrays and a JSON
    description: its class, its param groups, the dotted leaf name of each
    param index (``names``, in the optimizer's order), and per param index
    the state keys, which of them are tensors, and the plain values."""
    sd = optimizer.state_dict()
    arrays, state = {}, {}
    for idx in sorted(sd["state"]):
        entry = {"tensors": [], "values": {}}
        for key in sorted(sd["state"][idx]):
            v = sd["state"][idx][key]
            if isinstance(v, torch.Tensor):
                arrays[f"opt/{idx}.{key}"] = _host(v)
                entry["tensors"].append(key)
            else:
                entry["values"][key] = v
        state[str(idx)] = entry
    desc = {"class": type(optimizer).__name__, "param_groups": sd["param_groups"],
            "names": list(names), "state": state}
    return arrays, desc


def save_checkpoint(path: str, params, optimizer: Optional[torch.optim.Optimizer] = None,
                    step: int = 0, extra: Optional[Dict[str, Any]] = None,
                    optimizer_payload=None) -> str:
    """Write params (+ the optimizer's state and the step) as one ``.npz``,
    through ``path + ".tmp"`` and ``os.replace``. Param names are the JAX
    package's (dotted paths), so its ``load_checkpoint`` reads the params.
    ``optimizer_payload`` is ``_optimizer_payload``'s result, gathered
    already (a sharded trainer's), in place of ``optimizer``."""
    payload = {"step": np.asarray(step), "format": np.asarray(_FORMAT)}
    payload.update({f"params/{k}": _host(v) if isinstance(v, torch.Tensor) else np.asarray(v)
                    for k, v in _flatten(params).items()})
    if optimizer is not None:
        optimizer_payload = _optimizer_payload(optimizer, _param_names(optimizer, params))
    if optimizer_payload is not None:
        arrays, desc = optimizer_payload
        payload.update(arrays)
        payload["opt_json"] = np.asarray(json.dumps(desc))
    if extra:
        payload["extra_json"] = np.asarray(json.dumps(extra))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # a file object: savez appends no .npz
        np.savez(f, **payload)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, model=None, config=None, optimizer_state: bool = True):
    """-> ``(params, opt_state, step, extra)``.

    ``params`` is a tree of f32 CPU tensors. ``opt_state`` is None, or
    ``(description, {name: array})`` for :meth:`Trainer.load`. A checkpoint
    of the JAX ``Trainer`` (it has a ``params_treedef``) loads too: with
    ``model`` (a model type string) and ``config`` its params go through
    ``params_from_jax``, which checks them against the port's own tree. Its
    optax optimizer state cannot become a torch optimizer's: with
    ``optimizer_state`` True such a checkpoint raises ``ValueError``; pass
    False to take its params and step only.
    """
    with np.load(path, allow_pickle=False) as z:
        step = int(z["step"])
        flat = {k[len("params/"):]: z[k] for k in z.files if k.startswith("params/")}
        extra = json.loads(str(z["extra_json"])) if "extra_json" in z.files else {}
        from_jax = "format" not in z.files and "params_treedef" in z.files
        opt_state = None
        if from_jax:
            if optimizer_state and "opt_treedef" in z.files:
                raise ValueError(
                    f"{path} holds the JAX Trainer's optax state: optax's chain keeps its "
                    "moments and counts in other places and forms than torch.optim (and "
                    "RMSprop's trace after the LR), so it cannot resume a torch optimizer; "
                    "load with optimizer_state=False to take the params and step only")
        elif "format" in z.files and str(z["format"]) not in (_FORMAT, _FORMAT_BY_INDEX):
            raise ValueError(f"{path}: unknown checkpoint format {str(z['format'])!r}")
        elif optimizer_state and "opt_json" in z.files:
            opt_state = (json.loads(str(z["opt_json"])),
                         {k: z[k] for k in z.files if k.startswith("opt/")})
    params = _unflatten(flat)
    if from_jax and model is not None:
        from sesa_tpu_torch.convert.from_jax import params_from_jax

        params = params_from_jax(params, model, config)
    else:
        params = tree_map(lambda a: torch.from_numpy(np.array(a, dtype=np.float32)), params)
    return params, opt_state, step, extra


def _restore_optimizer(optimizer: torch.optim.Optimizer, opt_state,
                       names: Sequence[str]) -> None:
    """Load ``(description, arrays)`` into ``optimizer``, whose parameters
    are the leaves ``names`` (in its order); raise on any drift of
    optimizer, parameters or state shapes.

    A description with ``names`` (format 2) pairs each saved state with the
    live parameter of the same leaf name, whatever order either tree keeps
    its keys in, and raises on a name missing from either side. One without
    (format 1) pairs them by position."""
    desc, arrays = opt_state
    if desc["class"] != type(optimizer).__name__:
        raise ValueError(f"checkpoint optimizer {desc['class']} does not match the trainer's "
                         f"{type(optimizer).__name__}")
    current = optimizer.state_dict()
    saved_ids = [i for g in desc["param_groups"] for i in g["params"]]
    ids = [i for g in current["param_groups"] for i in g["params"]]
    if len(saved_ids) != len(ids) or len(desc["param_groups"]) != len(current["param_groups"]):
        raise ValueError(f"checkpoint optimizer covers {len(saved_ids)} parameters, the "
                         f"trainer's {len(ids)}: optimizer config drift")
    if "names" in desc:
        saved, live = desc["names"], list(names)
        missing, extra = sorted(set(live) - set(saved)), sorted(set(saved) - set(live))
        if missing or extra or len(set(saved)) != len(saved) or len(saved) != len(saved_ids):
            raise ValueError(f"checkpoint optimizer state does not match the trainer's "
                             f"parameters by name: missing {missing[:5]}, extra {extra[:5]}")
        where = {name: i for i, name in enumerate(live)}
        index = {j: where[name] for j, name in enumerate(saved)}
    else:
        if saved_ids != ids:
            raise ValueError("checkpoint optimizer groups its parameters otherwise than the "
                             "trainer's: optimizer config drift")
        index = {i: i for i in saved_ids}
    groups = []
    for g, cur in zip(desc["param_groups"], current["param_groups"]):
        if sorted(index[i] for i in g["params"]) != sorted(cur["params"]):
            raise ValueError("checkpoint optimizer groups its parameters otherwise than the "
                             "trainer's: optimizer config drift")
        groups.append(dict(g, params=cur["params"]))
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = {}
    for idx, entry in desc["state"].items():
        i = index[int(idx)]
        st = dict(entry["values"])
        for key in entry["tensors"]:
            a = arrays[f"opt/{idx}.{key}"]
            if key != "step" and a.shape != tuple(params[i].shape):
                raise ValueError(f"checkpoint optimizer state {key} of parameter {i} has "
                                 f"shape {a.shape}, the parameter {tuple(params[i].shape)}")
            st[key] = torch.from_numpy(np.array(a))
            if is_dtensor(params[i]) and key != "step":  # a moment sits where its param sits
                from torch.distributed.tensor import distribute_tensor

                st[key] = distribute_tensor(st[key].to(params[i].device),
                                            params[i].device_mesh, params[i].placements)
        state[i] = st
    optimizer.load_state_dict({"state": state, "param_groups": groups})


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

def _tp_context(mesh):
    """``implicit_replication`` with a mesh (the plain constants a tensor-
    parallel branch reads meet its DTensors), else nothing."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def _model_type(model) -> Optional[str]:
    from sesa_tpu_torch.models import MODEL_TYPES

    return next((k for k, v in MODEL_TYPES.items() if v == getattr(model, "__name__", None)),
                None)


class Trainer:
    """Training of a model module of :mod:`sesa_tpu_torch.models`.

    Args:
      model: a module with ``init(generator, config)`` / ``apply(params,
        config, mix)``, or a model type string (``models.get_model``).
      config: the model's config. ``config.training.instruments`` (and an
        optional ``target_instrument``) give the stem order of the target.
      loss: a callable or a loss config dict (``parse_loss_config``).
        Default: waveform L1 + multi-resolution STFT L1 (reference
        bs_roformer.py:586-622).
      optimizer: a :class:`TrainOptimizer` or an optimizer config dict
        (``parse_optimizer_config``). Default Adam(1e-4).
      mesh: a ``parallel.make_mesh`` DeviceMesh; every rank builds the same
        trainer and calls it with the same global batch. The batch's dim 0
        splits over the mesh's "data" axis (``ValueError`` unless it
        divides); gradients and the loss are averaged over that axis, so the
        step is the single-device step up to summation order.
      param_rule: a ``parallel`` layout rule for tensor parallelism over the
        "model" axis (default with a mesh: ``roformer_tp_rule``, as in the
        JAX package); it is kept for :meth:`load`.
      augmentor: an optional ``data.StemAugmentor`` run on each host batch.
      seed: seeds ``init`` when ``params`` is None.
      params: the port's parameter tree (e.g. from ``params_from_jax``).
      device: CUDA when None (raises without a GPU), or "cpu".

    The model runs in f32. After each step every parameter leaf's ``.grad``
    holds that step's gradient (zeros for a leaf the loss does not reach, as
    ``jax.grad`` gives).
    """

    def __init__(self, model, config, *, loss=None, optimizer=None, mesh=None,
                 param_rule=None, augmentor=None, seed: int = 0, params=None, device=None):
        self.device = get_device(device)
        self.mesh = mesh
        self._param_rule = param_rule
        if isinstance(model, str):
            from sesa_tpu_torch.models import get_model

            self.model_type = model
            model = get_model(model)
        else:
            self.model_type = _model_type(model)
        self.model = model
        self.config = config if isinstance(config, AttrDict) else AttrDict(config)
        self.augmentor = augmentor
        self._lr_scale = 1.0

        if loss is None:
            loss = losses_mod.multi_res_stft_l1
        elif isinstance(loss, dict):
            loss = parse_loss_config(loss)
        self.loss_fn = loss

        if optimizer is None:
            optimizer = {"optimizer": {"name": "Adam", "kwargs": {"lr": 1e-4}}}
        if isinstance(optimizer, dict):
            optimizer = parse_optimizer_config(optimizer)
        self.tx = optimizer

        if params is None:
            params = model.init(torch.Generator().manual_seed(seed), self.config)
        params = tree_map(lambda p: torch.as_tensor(p).detach().to(self.device, torch.float32,
                                                                   copy=True), params)
        if mesh is not None:
            from sesa_tpu_torch.parallel import shard_params

            params = shard_params(mesh, params, rule=param_rule)
        self.params = tree_map(lambda p: p.requires_grad_(True), params)
        flat = _flatten(self.params)
        # the optimizer's parameters, in its order, and their dotted names
        self._names, self._leaves = list(flat), list(flat.values())
        # torch's foreach kernels take no DTensor beside plain tensors
        self.tx.init(self._leaves,
                     foreach=False if any(is_dtensor(p) for p in self._leaves) else None)
        self.step = 0

    # -- stem plumbing -----------------------------------------------------

    def target_stems(self) -> Sequence[str]:
        tr = self.config["training"]
        target = tr.get("target_instrument")
        if target:
            return [target]
        return list(tr["instruments"])

    def make_batch(self, item: Dict[str, Any]):
        """Batch dict -> (mix (B, C, T), target (B, S, C, T)) f32 tensors on
        the trainer's device."""
        audio = item["audio"]
        mix = np.asarray(audio["mixture"], np.float32)
        if mix.ndim == 2:
            mix = mix[None]
        target = np.stack([np.asarray(audio[s], np.float32) for s in self.target_stems()],
                          axis=1)
        if target.ndim == 3:
            target = target[None]
        return (torch.from_numpy(mix).to(self.device),
                torch.from_numpy(np.ascontiguousarray(target)).to(self.device))

    # -- public API ----------------------------------------------------------

    def set_lr_scale(self, scale: float) -> None:
        """For ReduceLROnPlateau-style host-driven LR control."""
        self._lr_scale = float(scale)

    def _data_axis(self):
        """(group, size, coordinate) of the mesh's data axis."""
        data = self.mesh["data"]
        return data.get_group(), data.size(), data.get_local_rank()

    def _share(self, mix, target):
        """This rank's share of the global batch along dim 0."""
        _, size, coord = self._data_axis()
        if mix.shape[0] % size:
            raise ValueError(f"batch of {mix.shape[0]} must be divisible by the mesh data "
                             f"axis ({size})")
        n = mix.shape[0] // size
        return mix[coord * n:(coord + 1) * n], target[coord * n:(coord + 1) * n]

    def _average_over_data(self, loss):
        """Every gradient and the loss averaged over the data axis: each
        rank's share is equal, so the mean of the ranks' means is the global
        mean. A DTensor gradient is first brought to its parameter's layout
        (a partial sum over the model axis is reduced), then its local shard
        is averaged. A data axis of one rank averages nothing."""
        import torch.distributed as dist

        group, size, _ = self._data_axis()
        if size == 1 and not any(is_dtensor(p) for p in self._leaves):
            return loss
        with torch.no_grad():
            for p in self._leaves:
                if is_dtensor(p) and p.grad.placements != p.placements:
                    p.grad = p.grad.redistribute(placements=p.placements)
                local = p.grad.to_local() if is_dtensor(p.grad) else p.grad
                dist.all_reduce(local, group=group)
                local.div_(size)
            loss = loss.detach().clone()
            dist.all_reduce(loss, group=group)
        return loss / size

    def train_batch(self, item: Dict[str, Any]) -> float:
        """One step: augment on the host, upload, forward + loss + backward
        under the f32 TF32 policy, optimizer step; returns the loss. With a
        mesh, each rank runs its share of the batch and the gradients and
        the loss are averaged over the data axis before the step."""
        if self.augmentor is not None:
            item = self.augmentor(item)
        mix, target = self.make_batch(item)
        if self.mesh is not None:
            mix, target = self._share(mix, target)
        for p in self._leaves:
            p.grad = None
        with torch.enable_grad(), net_precision(None), _tp_context(self.mesh):
            loss = self.loss_fn(self.model.apply(self.params, self.config, mix), target)
            loss.backward()
        for p in self._leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.mesh is not None:
            loss = self._average_over_data(loss)
        self.tx.step(self.step, self._lr_scale)
        self.step += 1
        return float(loss.detach())

    def fit(self, batches: Iterable[Dict[str, Any]], steps: int,
            log_cb: Optional[Callable[[int, float], None]] = None):
        """Run up to ``steps`` train steps over an iterator of batch dicts
        (e.g. :func:`sesa_tpu_torch.data.batch_iterator`); returns the losses."""
        history = []
        for item in batches:
            loss = self.train_batch(item)
            history.append(loss)
            if log_cb is not None:
                log_cb(self.step, loss)
            if len(history) >= steps:
                break
        return history

    def validate_track(self, item: Dict[str, Any], spec=None,
                       metric: str = "si_snr", window_seconds: float = 2.0):
        """Whole-track validation through the chunked overlap-add engine
        (the reference's OverlapAddFader, core/__init__.py:725-729) under
        ``torch.no_grad``, then chunk-median metrics per stem."""
        from sesa_tpu_torch.metrics import (chunk_median_sdr, chunk_median_si_snr,
                                            chunk_median_snr)
        from sesa_tpu_torch.runtime import DemixSpec, demix

        audio = item["audio"]
        mix = np.asarray(audio["mixture"], np.float32)
        audio_cfg = self.config.get("audio", {}) or {}
        if spec is None:
            spec = DemixSpec(chunk_size=int(audio_cfg.get("chunk_size", 131072)),
                             num_overlap=2, batch_size=2,
                             num_stems=len(self.target_stems()))
        with torch.no_grad(), _tp_context(self.mesh):
            est = demix(lambda p, x: self.model.apply(p, self.config, x), self.params, mix,
                        spec, device=self.device, mesh=self.mesh)
        window = int(window_seconds * int(audio_cfg.get("sample_rate", 44100)))
        fn = {"snr": chunk_median_snr, "si_snr": chunk_median_si_snr,
              "sdr": chunk_median_sdr}[metric]
        out = {}
        for si, stem in enumerate(self.target_stems()):
            ref = np.asarray(audio[stem], np.float32)
            out[stem] = fn(est[si][..., : ref.shape[-1]], ref, window)
        return out

    def save(self, path: str, extra: Optional[Dict[str, Any]] = None) -> str:
        """The checkpoint an unsharded trainer writes. With a mesh every rank
        calls this (the shards are gathered whole), rank 0 of the mesh writes,
        and all return once the file is there."""
        if self.mesh is None:
            return save_checkpoint(path, self.params, self.tx.optimizer, self.step, extra=extra)
        import torch.distributed as dist

        params = tree_map(_host, self.params)
        arrays, desc = _optimizer_payload(self.tx.optimizer, self._names)
        if dist.get_rank() == int(self.mesh.mesh.flatten()[0]):
            save_checkpoint(path, params, None, self.step, extra=extra,
                            optimizer_payload=(arrays, desc))
        dist.barrier()
        return path

    def load(self, path: str, optimizer_state: bool = True) -> None:
        """Params (copied into the trainer's tensors), step and, with
        ``optimizer_state``, the optimizer's state from a checkpoint of
        :meth:`save` (or the params and step of the JAX ``Trainer``'s with
        ``optimizer_state=False``). Raises on any structure drift."""
        params, opt_state, step, _ = load_checkpoint(
            path, model=self.model_type, config=self.config, optimizer_state=optimizer_state)

        def copy(dst, src):
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"checkpoint param of shape {tuple(src.shape)} where the "
                                 f"model has {tuple(dst.shape)}")
            return src

        loaded = tree_map(copy, self.params, params)
        if self.mesh is not None:  # re-shard with the trainer's own rule
            from sesa_tpu_torch.parallel import shard_params

            loaded = shard_params(self.mesh, tree_map(lambda t: t.to(self.device), loaded),
                                  rule=self._param_rule)
        with torch.no_grad():
            for dst, src in zip(self._leaves, _flatten(loaded).values()):
                dst.copy_(src)
        if opt_state is not None:
            _restore_optimizer(self.tx.optimizer, opt_state, self._names)
        self.step = step
