"""The port's training layer held against sesa_tpu.train on the CPU: the
optimizers and schedules against optax on one gradient sequence, a Trainer
step's gradients against jax.grad of the JAX Trainer's objective on the same
params, backward through every other registry key, the loss sequence of the
JAX Trainer, checkpoints both ways, and the kernels' autograd guard (meta
tensors stand in for the card)."""

import importlib
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ml_collections import ConfigDict

import sesa_tpu.train as jax_train
from sesa_tpu import losses as jax_losses
from sesa_tpu_torch import losses as losses_mod
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.convert.from_jax import params_from_jax
from sesa_tpu_torch.data import StemAugmentor, batch_iterator
from sesa_tpu_torch.models import get_model
from sesa_tpu_torch.ops import attention as A
from sesa_tpu_torch.ops import convblock as CB
from sesa_tpu_torch.ops import ff as FF
from sesa_tpu_torch.ops import ssd as SSD
from sesa_tpu_torch.train import (ReduceLROnPlateau, Trainer, _flatten, load_checkpoint,
                                  parse_loss_config, parse_optimizer_config, save_checkpoint)
from sesa_tpu_torch.tree import tree_map
from tests.test_mdx23c import tiny_config as mdx_config
from tests.test_roformer import bs_model_cfg, mel_model_cfg
from tests.test_scnet import tiny_kwargs

# optimizer and schedule updates against optax under jit, f32 on both sides:
# params within OPT_RTOL, plus OPT_MOVE_REL of the leaf's largest movement
# over the steps. optax takes Adam's 1 - b2^t in f32, where 1 - 0.999 is off
# by 1.3e-5, so its first update is off by 6.4e-6; torch's Adam and AdamW
# take it in f64 (measured: 9.3e-6 of the movement after 10 steps; the rules
# written out here, 1.5e-6 at most)
OPT_RTOL, OPT_MOVE_REL = 1e-6, 2e-5
# a Trainer step's gradient against jax.grad, per leaf, relative to the
# leaf's largest JAX gradient
GRAD_REL = 1e-4
# bs_mamba2 only: a floor of the model's largest gradient (see the test)
MAMBA_FLOOR = 1e-3
# the JAX Trainer's loss sequence
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _training(*stems):
    return {"instruments": list(stems), "target_instrument": None}


def _item(stems, t, b=1, seed=0):
    rng = np.random.default_rng(seed)
    audio = {s: (0.1 * rng.standard_normal((b, 2, t))).astype(np.float32) for s in stems}
    audio["mixture"] = sum(audio.values())
    return {"audio": audio, "track": ["t"] * b}


L1 = {"name": "L1Loss", "kwargs": {}}
SGD = {"optimizer": {"name": "SGD", "kwargs": {"lr": 1e-2}}}


def _mdx_dict():
    return mdx_config().to_dict()


# ---------------------------------------------------------------------------
# optimizers and schedules against optax
# ---------------------------------------------------------------------------

SCHEDULES = [
    {"name": "StepLR", "kwargs": {"step_size": 3, "gamma": 0.5}},
    {"name": "ExponentialLR", "kwargs": {"gamma": 0.8}},
    {"name": "CosineAnnealingLR", "kwargs": {"T_max": 4, "eta_min": 0.01}},
    {"name": "LinearLR", "kwargs": {"start_factor": 0.2, "total_iters": 6}},
    {"name": "ConstantLR", "kwargs": {"factor": 0.5}},
]
OPTIMIZERS = [
    ("Adam", {"lr": 1e-2}),
    ("Adam", {"lr": 1e-2, "betas": (0.8, 0.99), "eps": 1e-6, "weight_decay": 0.1}),
    ("AdamW", {"lr": 1e-2, "weight_decay": 0.05}),
    ("SGD", {"lr": 0.1}),
    ("SGD", {"lr": 0.1, "momentum": 0.9, "nesterov": True, "weight_decay": 0.01}),
    ("RMSprop", {"lr": 1e-2}),
    ("RMSprop", {"lr": 1e-2, "alpha": 0.9, "momentum": 0.5, "eps": 1e-4}),
    ("Adagrad", {"lr": 0.1}),
    ("Adamax", {"lr": 1e-2, "betas": (0.8, 0.95)}),
    ("NAdam", {"lr": 1e-2}),
    ("RAdam", {"lr": 1e-2}),
    ("RAdam", {"lr": 1e-2, "betas": (0.9, 0.9)}),
]
CASES = ([(name, kw, None, None) for name, kw in OPTIMIZERS]
         + [(opt, {"lr": 0.1, "momentum": 0.5}, s, None) for s in SCHEDULES
            for opt in ("SGD", "RMSprop")]
         + [(name, {"lr": 1e-2, "momentum": 0.5} if name == "RMSprop" else {"lr": 1e-2},
             None, (1.0, 0.5, 0.5, 0.0, 1.0, 0.25, 1.0, 1.0, 0.0, 2.0))
            for name in ("Adam", "RMSprop")])


def _run_both(name, kw, sched, scales, steps=10):
    """(params before, JAX's after, the port's after) ``steps`` updates fed
    one gradient sequence; JAX's through optax with lr_scale applied to the
    updates, as the JAX Trainer does."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((5, 7)).astype(np.float32),
              "b": rng.standard_normal((7,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(steps)]
    cfg = {"optimizer": {"name": name, "kwargs": dict(kw)}}
    if sched is not None:
        cfg["scheduler"] = sched
    scales = scales or (1.0,) * steps

    tx = jax_train.parse_optimizer_config(cfg)

    @jax.jit  # as in the JAX Trainer's step: pow and the schedules traced
    def update(g, state, p, s):
        upd, state = tx.update(g, state, p)
        return optax.apply_updates(p, jax.tree.map(lambda u: u * s, upd)), state

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g, s in zip(grads, scales):
        jp, state = update(g, state, jp, jnp.float32(s))

    opt = parse_optimizer_config(cfg)
    leaves = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in params.items()}
    opt.init(list(leaves.values()))
    for i, (g, s) in enumerate(zip(grads, scales)):
        for k, p in leaves.items():
            p.grad = torch.from_numpy(g[k])
        opt.step(i, s)
    return params, {k: np.asarray(v) for k, v in jp.items()}, {k: v.detach().numpy()
                                                               for k, v in leaves.items()}


def _assert_same_steps(p0, ref, got):
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=OPT_RTOL,
                                   atol=OPT_MOVE_REL * np.abs(ref[k] - p0[k]).max(), err_msg=k)


@pytest.mark.parametrize("name,kw,sched,scales", CASES, ids=[
    f"{c[0]}-{c[2]['name'] if c[2] else ('scaled' if c[3] else i)}"
    for i, c in enumerate(CASES)])
def test_optimizer_matches_optax(name, kw, sched, scales):
    _assert_same_steps(*_run_both(name, kw, sched, scales))


def test_adagrad_ignores_the_configured_eps_as_jax_does():
    """sesa_tpu/train.py:139-140 reads kw.pop("eps", 1e-10) after eps was
    popped, so optax always gets 1e-10 (ROADMAP.md §3); the port copies it."""
    kw = {"lr": 0.1, "eps": 0.5}
    _assert_same_steps(*_run_both("Adagrad", kw, None, None))
    opt = parse_optimizer_config({"optimizer": {"name": "Adagrad", "kwargs": kw}})
    assert opt.init([torch.zeros(2, requires_grad=True)]).param_groups[0]["eps"] == 1e-10
    # had eps 0.5 reached the rule, the step would differ
    from sesa_tpu_torch.train import OptaxAdagrad

    p = torch.ones(3, requires_grad=True)
    p.grad = torch.full((3,), 0.1)
    OptaxAdagrad([p], lr=0.1, eps=0.5).step()
    q = torch.ones(3, requires_grad=True)
    q.grad = torch.full((3,), 0.1)
    OptaxAdagrad([q], lr=0.1).step()
    assert not torch.allclose(p, q)


def test_parse_errors_match_jax():
    for cfg, err in [
        ({"optimizer": {"name": "DeepSpeedCPUAdam", "kwargs": {}}}, NameError),
        ({"optimizer": {"name": "Adam", "kwargs": {"lr": 1e-3, "bogus": 1}}}, TypeError),
        ({"optimizer": {"name": "SGD", "kwargs": {"dampening": 0.1}}}, TypeError),
        ({"optimizer": {"name": "SGD", "kwargs": {}},
          "scheduler": {"name": "ReduceLROnPlateau", "kwargs": {}}}, ValueError),
        ({"optimizer": {"name": "SGD", "kwargs": {}},
          "scheduler": {"name": "OneCycleLR", "kwargs": {}}}, NameError),
    ]:
        for parse in (jax_train.parse_optimizer_config, parse_optimizer_config):
            with pytest.raises(err):
                parse(cfg)
    ok = parse_optimizer_config({"optimizer": {"name": "Adam", "kwargs": {
        "lr": 1e-3, "foreach": True, "fused": False, "amsgrad": False}}})
    assert isinstance(ok.init([torch.zeros(1, requires_grad=True)]), torch.optim.Adam)
    with pytest.raises(NameError):
        parse_loss_config({"name": "Nope"})


def test_reduce_lr_on_plateau_matches_jax():
    kw = dict(patience=1, factor=0.3, min_lr=0.02, base_lr=0.5)
    a, b = jax_train.ReduceLROnPlateau(**kw), ReduceLROnPlateau(**kw)
    for m in (1.0, 1.2, 1.3, 0.9, 1.0, 1.0, 1.0, 1.0, 1.0, 0.1):
        assert b.step(m) == a.step(m)
    assert b.scale == pytest.approx(0.04)


@pytest.mark.parametrize("name,kw", [("L1Loss", {}), ("MSELoss", {}),
                                     ("MultiResSTFTL1", {"window_sizes": (256, 128),
                                                         "stft_n_fft": 256}),
                                     ("SignalNoisePNormRatio", {"p": 2}),
                                     ("MultichannelSingleSrcNegSDR", {"sdr_type": "sisdr"}),
                                     ("NegSDR", {})])
def test_parse_loss_config_matches_jax(name, kw):
    rng = np.random.default_rng(0)
    r, t = (rng.standard_normal((2, 2, 800)).astype(np.float32) for _ in range(2))
    ref = float(jax_train.parse_loss_config({"name": name, "kwargs": kw})(jnp.asarray(r),
                                                                          jnp.asarray(t)))
    got = float(parse_loss_config({"name": name, "kwargs": kw})(torch.from_numpy(r),
                                                               torch.from_numpy(t)))
    assert got == pytest.approx(ref, rel=1e-5)


# ---------------------------------------------------------------------------
# a Trainer step's gradients against jax.grad of the JAX Trainer's objective
# ---------------------------------------------------------------------------

MAMBA = dict(sr=44100, win=2048, stride=512, feature_dim=16, num_repeat_mask=1,
             num_repeat_map=1, num_output=2)
# model type -> (config, samples, perturbation of the init leaves)
GRAD_MODELS = {
    "mdx23c": (_mdx_dict, 8064, 0.0),
    "bs_roformer": (lambda: {"model": bs_model_cfg(), "training": _training("vocals", "other")},
                    2048, 0.0),
    "mel_band_roformer": (lambda: {"model": mel_model_cfg(), "training": _training("vocals")},
                          1280, 0.0),
    # the norms leave their identity init, so that every leaf matters
    "apollo": (lambda: {"model": {"sr": 16000, "win": 20, "feature_dim": 16, "layer": 2},
                        "training": _training("restored")}, 4800, 0.05),
    "bs_mamba2": (lambda: {"model": MAMBA, "training": _training("vocals", "other")},
                  8 * 512, 0.1),
    "scnet": (lambda: {"model": tiny_kwargs(),
                       "training": _training("drums", "bass", "other", "vocals")}, 4096, 0.0),
}
_GRAD_REFS = {}


@pytest.fixture(scope="module")
def jax_grads():
    """model type -> (config dict, params as numpy, batch item, JAX loss,
    JAX gradient by flat name), each built once under jax.jit. The params
    are the port's seeded init, perturbed with numpy; JAX's apply takes the
    tree as it is."""
    def get(model_type):
        if model_type not in _GRAD_REFS:
            cfg_fn, t, perturb = GRAD_MODELS[model_type]
            d = cfg_fn()
            jcfg = ConfigDict(d)
            rng = np.random.default_rng(0)
            p0 = tree_map(lambda p: p.numpy() + perturb * rng.standard_normal(p.shape)
                          .astype(np.float32),
                          get_model(model_type).init(torch.Generator().manual_seed(0),
                                                     AttrDict(d)))
            stems = d["training"]["instruments"]
            item = _item(stems, t)
            mix = jnp.asarray(item["audio"]["mixture"])
            target = jnp.asarray(np.stack([item["audio"][s] for s in stems], axis=1))
            jm = importlib.import_module(f"sesa_tpu.models.{model_type}")
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: jax_losses.l1(jm.apply(p, jcfg, mix), target)))(p0)
            _GRAD_REFS[model_type] = (d, p0, item, float(loss), {
                k: np.asarray(v) for k, v in _flatten(jax.tree.map(np.asarray, grads)).items()})
        return _GRAD_REFS[model_type]
    return get


@pytest.mark.parametrize("model_type", list(GRAD_MODELS))
def test_trainer_gradients_match_jax(jax_grads, model_type):
    d, p0, item, ref_loss, ref = jax_grads(model_type)
    cfg = AttrDict(d)
    trainer = Trainer(model_type, cfg, loss=L1, optimizer=SGD,
                      params=params_from_jax(p0, model_type, cfg), device="cpu")
    trainer.set_lr_scale(0.0)
    loss = trainer.train_batch(item)
    got = {k: v.grad.numpy() for k, v in _flatten(trainer.params).items()}
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    assert got.keys() == ref.keys()
    assert {k for k, g in got.items() if np.any(g)} == {k for k, g in ref.items() if np.any(g)}
    floor = 0.0
    if model_type == "bs_mamba2":
        # the JAX reference itself is not resolved to GRAD_REL here: its f32
        # gradient differs from its own f64 one (jax.enable_x64) by up to
        # 3.9e-4 of the model's largest gradient (the mask heads' band
        # convs), and the per-head SSD scalars A_log, dt_bias and D, whose
        # gradients cancel to ~1e-4 of their terms, by up to 1.5e-2 of their
        # own largest value; the port's f32 gradient is within 1.1e-4 of the
        # model's largest of that f64 reference. Every leaf is held to
        # GRAD_REL of its own largest value plus MAMBA_FLOOR of the model's.
        floor = MAMBA_FLOOR * max(float(np.abs(g).max()) for g in ref.values())
    bad = [(k, float(np.abs(got[k] - ref[k]).max()), float(np.abs(ref[k]).max()))
           for k in got
           if np.abs(got[k] - ref[k]).max() > GRAD_REL * np.abs(ref[k]).max() + floor]
    assert not bad, bad[:5]


# the other registry keys at the tiny configs of their test_torch_*.py:
# model type -> (config, samples)
def _demucs(fn, **kw):
    return lambda: fn(**kw).to_dict()


def _other_models():
    from tests.test_bandit_v1 import tiny_config as bandit_v1
    from tests.test_bandit_v2 import tiny_config as bandit_v2
    from tests.test_demucs_legacy import tiny_config as legacy
    from tests.test_efficientnet_unet import tiny_config as effnet
    from tests.test_hdemucs import hd_config
    from tests.test_htdemucs import tiny_config as htdemucs
    from tests.test_maxvit_unet import tiny_config as maxvit
    from tests.test_resnet_unet import tiny_config as resnet
    from tests.test_scnet import tiny_tran_kwargs
    from tests.test_scnet_unofficial import tiny_config as unofficial
    from tests.test_swin_upernet import tiny_config as swin
    from tests.test_torch_conformer import _melconf_cfg
    from tests.test_torch_conformer_mss import _fno_cfg, _mss_cfg

    frames = 64 * 64 - 64
    return {
        "bs_roformer_experimental": (lambda: {"model": bs_model_cfg(
            use_value_residual_learning=True, num_residual_streams=2)}, 1280),
        "bs_roformer_custom": (lambda: {"model": _fno_cfg()}, 1280),
        "mel_band_roformer_experimental": (lambda: {"model": mel_model_cfg(
            use_value_residual_learning=True)}, 1280),
        "mel_band_conformer": (lambda: {"model": _melconf_cfg()}, 1280),
        "conformer": (_mss_cfg, 2048),
        "scnet_tran": (lambda: {"model": tiny_tran_kwargs()}, 4096),
        "scnet_masked": (lambda: {"model": tiny_kwargs()}, 4096),
        "scnet_unofficial": (lambda: {"model": dict(unofficial().model)}, 4096),
        "experimental_mdx23c_stht": (_mdx_dict, 8064),
        "htdemucs": (_demucs(htdemucs), 8192),
        "htdemucs/hdemucs": (_demucs(hd_config), 8192),
        "htdemucs/demucs": (_demucs(legacy, lstm_layers=2), 30000),
        "bandit": (_demucs(bandit_v1), 4096),
        "bandit_v2": (_demucs(bandit_v2), 4096),
        "segm_models/maxvit": (_demucs(maxvit), frames),
        "segm_models/efficientnet": (_demucs(effnet), frames),
        "torchseg": (_demucs(resnet), frames),
        "swin_upernet": (_demucs(swin), 4096),
    }


OTHER_MODELS = ["bs_roformer_experimental", "bs_roformer_custom",
                "mel_band_roformer_experimental", "mel_band_conformer", "conformer",
                "scnet_tran", "scnet_masked", "scnet_unofficial", "experimental_mdx23c_stht",
                "htdemucs", "htdemucs/hdemucs", "htdemucs/demucs", "bandit", "bandit_v2",
                "segm_models/maxvit", "segm_models/efficientnet", "torchseg", "swin_upernet"]


@pytest.mark.parametrize("key", OTHER_MODELS)
def test_backward_through_every_other_model(key):
    """loss.backward() through the model in f32: every parameter that
    receives a gradient gets a finite one, and most do."""
    cfg_fn, t = _other_models()[key]
    cfg = AttrDict(cfg_fn())
    model = get_model(key.split("/")[0])
    params = tree_map(lambda p: p.detach().requires_grad_(True),
                      model.init(torch.Generator().manual_seed(0), cfg))
    x = torch.from_numpy((0.1 * np.random.default_rng(0).standard_normal((1, 2, t)))
                         .astype(np.float32))
    out = model.apply(params, cfg, x)
    assert out.dtype == torch.float32 and out.grad_fn is not None
    losses_mod.l1(out, torch.zeros_like(out)).backward()
    leaves = list(_flatten(params).values())
    reached = [p.grad for p in leaves if p.grad is not None]
    assert len(reached) >= 0.9 * len(leaves)
    assert all(bool(torch.isfinite(g).all()) for g in reached)
    assert sum(bool(g.abs().max() > 0) for g in reached) >= 0.8 * len(leaves)


# ---------------------------------------------------------------------------
# the JAX Trainer: its loss sequence and its checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Five SGD steps of the JAX Trainer on tiny mdx23c (momentum, a step
    schedule), from params as numpy: the losses, the params after, and its
    checkpoint."""
    d = _mdx_dict()
    opt = {"optimizer": {"name": "SGD", "kwargs": {"lr": 0.05, "momentum": 0.9}},
           "scheduler": {"name": "StepLR", "kwargs": {"step_size": 2, "gamma": 0.5}}}
    p0 = tree_map(lambda p: p.numpy(), get_model("mdx23c").init(
        torch.Generator().manual_seed(1), AttrDict(d)))
    trainer = jax_train.Trainer("mdx23c", ConfigDict(d), loss=L1, optimizer=opt,
                                params=jax.tree.map(jnp.asarray, p0))
    stems = d["training"]["instruments"]
    items = [_item(stems, 8064, b=2, seed=i) for i in range(5)]
    losses = [trainer.train_batch(it) for it in items]
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "jax.npz")
    trainer.save(path, extra={"from": "jax"})
    return dict(d=d, opt=opt, p0=p0, items=items, losses=losses, path=path,
                params={k: np.asarray(v) for k, v in _flatten(
                    jax.tree.map(np.asarray, jax.device_get(trainer.params))).items()})


def test_loss_sequence_matches_the_jax_trainer(jax_run):
    cfg = AttrDict(jax_run["d"])
    trainer = Trainer("mdx23c", cfg, loss=L1, optimizer=jax_run["opt"],
                      params=params_from_jax(jax_run["p0"], "mdx23c", cfg), device="cpu")
    losses = [trainer.train_batch(it) for it in jax_run["items"]]
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=LOSS_RTOL)
    assert trainer.step == 5


def test_load_the_jax_trainers_checkpoint(jax_run):
    cfg = AttrDict(jax_run["d"])
    params, opt_state, step, extra = load_checkpoint(jax_run["path"], "mdx23c", cfg,
                                                     optimizer_state=False)
    assert (opt_state, step, extra) == (None, 5, {"from": "jax"})
    got = {k: v.numpy() for k, v in _flatten(params).items()}
    assert got.keys() == jax_run["params"].keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v, jax_run["params"][k])
    trainer = Trainer("mdx23c", cfg, loss=L1, optimizer=SGD, device="cpu", seed=3)
    with pytest.raises(ValueError, match="optax"):
        trainer.load(jax_run["path"])
    trainer.load(jax_run["path"], optimizer_state=False)
    assert trainer.step == 5
    np.testing.assert_array_equal(_flatten(trainer.params)["final_conv2"].detach().numpy(),
                                  jax_run["params"]["final_conv2"])
    with pytest.raises(ValueError, match="does not match"):
        load_checkpoint(jax_run["path"], "mdx23c", AttrDict(dict(
            jax_run["d"], model=dict(jax_run["d"]["model"], num_channels=4))),
            optimizer_state=False)


# ---------------------------------------------------------------------------
# the port's Trainer
# ---------------------------------------------------------------------------

def _trainer(**kw):
    kw.setdefault("loss", L1)
    kw.setdefault("device", "cpu")
    return Trainer("mdx23c", AttrDict(_mdx_dict()), **kw)


def test_lr_scale_zero_freezes_params_but_advances_the_optimizer():
    trainer = _trainer(optimizer={"optimizer": {"name": "Adam", "kwargs": {"lr": 1e-2}}})
    trainer.set_lr_scale(0.0)
    before = [p.detach().clone() for p in _flatten(trainer.params).values()]
    trainer.train_batch(_item(["vocals", "other"], 8064))
    after = list(_flatten(trainer.params).values())
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    state = trainer.tx.optimizer.state[after[0]]
    assert float(state["step"]) == 1 and bool(state["exp_avg"].abs().max() > 0)
    trainer.set_lr_scale(1.0)
    trainer.train_batch(_item(["vocals", "other"], 8064))
    assert not all(torch.equal(a, b) for a, b in zip(before, after))


def test_checkpoint_round_trip(tmp_path):
    opt = {"optimizer": {"name": "RMSprop", "kwargs": {"lr": 1e-3, "momentum": 0.5}}}
    trainer = _trainer(optimizer=opt)
    trainer.train_batch(_item(["vocals", "other"], 8064))
    path = str(tmp_path / "ck.npz")
    trainer.save(path, extra={"note": "port"})
    other = _trainer(optimizer=opt, seed=7)
    other.load(path)
    assert other.step == 1
    for a, b in zip(_flatten(trainer.params).values(), _flatten(other.params).values()):
        assert torch.equal(a, b)
    batch = _item(["vocals", "other"], 8064, seed=3)
    assert trainer.train_batch(batch) == other.train_batch(batch)
    _, opt_state, step, extra = load_checkpoint(path)
    assert step == 1 and extra == {"note": "port"} and opt_state[0]["class"] == "OptaxRMSprop"
    # the JAX package reads the port's params by the same flat names
    jparams, _, jstep, _ = jax_train.load_checkpoint(path)
    assert jstep == 1
    np.testing.assert_array_equal(
        jparams["encoder"][1]["tfc_tdf"][0]["tfc1_conv"],
        _flatten(load_checkpoint(path)[0])["encoder.1.tfc_tdf.0.tfc1_conv"].numpy())
    assert not (tmp_path / "ck.npz.tmp").exists()


def test_checkpoint_refuses_drift(tmp_path):
    path = str(tmp_path / "ck.npz")
    _trainer(optimizer=SGD).save(path)
    with pytest.raises(ValueError, match="does not match"):
        _trainer(optimizer={"optimizer": {"name": "Adam", "kwargs": {}}}).load(path)
    small = Trainer("mdx23c", AttrDict(dict(_mdx_dict(), model=dict(
        _mdx_dict()["model"], num_channels=4))), loss=L1, device="cpu")
    with pytest.raises(ValueError):
        small.load(path)
    params = {"layer": {"w": np.ones((2, 2), np.float32)},
              "stack": [np.zeros((3,), np.float32), np.ones((1,), np.float32)]}
    save_checkpoint(str(tmp_path / "p.npz"), params, step=42, extra={"k": 1})
    loaded, opt_state, step, extra = load_checkpoint(str(tmp_path / "p.npz"))
    assert (opt_state, step, extra) == (None, 42, {"k": 1})
    assert isinstance(loaded["stack"], list) and loaded["layer"]["w"].dtype == torch.float32


ADAM = {"optimizer": {"name": "Adam", "kwargs": {"lr": 1e-2}}}


def _orders():
    """Two Adam trainers of tiny mdx23c on the same weights whose trees keep
    their keys in other orders: ``init`` from the port's init (insertion
    order), ``sorted`` from ``params_from_jax`` of the same weights as JAX
    hands them (sorted keys)."""
    cfg = AttrDict(_mdx_dict())
    init = _trainer(optimizer=ADAM, seed=1)
    as_jax = jax.tree.map(np.asarray, tree_map(lambda p: p.detach().numpy(), init.params))
    other = _trainer(optimizer=ADAM, params=params_from_jax(as_jax, "mdx23c", cfg))
    assert list(_flatten(init.params)) != list(_flatten(other.params))
    return {"init": init, "sorted": other}


def _moments(trainer):
    """{leaf name: (exp_avg, exp_avg_sq)} of an Adam trainer."""
    state = trainer.tx.optimizer.state
    return {name: (state[p]["exp_avg"], state[p]["exp_avg_sq"])
            for name, p in _flatten(trainer.params).items()}


@pytest.mark.parametrize("src,dst", [("sorted", "init"), ("init", "sorted")])
def test_optimizer_state_follows_leaf_names_across_key_orders(tmp_path, src, dst):
    """A checkpoint of a trainer whose tree keeps JAX's sorted keys loads into
    one built by the port's init (insertion order), and the other way: each
    leaf gets its own Adam moments, exactly, and one more step gives the
    same parameters on both."""
    trainers = _orders()
    a, b = trainers[src], trainers[dst]
    for seed in (0, 1):
        a.train_batch(_item(["vocals", "other"], 8064, seed=seed))
    path = str(tmp_path / "ck.npz")
    a.save(path)
    b.load(path)
    got, want = _moments(b), _moments(a)
    assert got.keys() == want.keys() and b.step == 2
    for name, (m, v) in want.items():
        assert torch.equal(got[name][0], m) and torch.equal(got[name][1], v), name
    batch = _item(["vocals", "other"], 8064, seed=5)
    a.train_batch(batch)
    b.train_batch(batch)
    pa, pb = _flatten(a.params), _flatten(b.params)
    for name, p in pa.items():
        assert torch.equal(pb[name], p), name


def _rewrite(path, out, fn):
    """``path``'s arrays into ``out`` with ``fn`` applied to the optimizer
    description and the format entry."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    desc, fmt = fn(json.loads(str(arrays["opt_json"])), str(arrays["format"]))
    arrays["opt_json"], arrays["format"] = np.asarray(json.dumps(desc)), np.asarray(fmt)
    with open(out, "wb") as f:
        np.savez(f, **arrays)
    return out


def test_format_1_checkpoint_pairs_the_state_by_position(tmp_path):
    """A checkpoint of the first format (no leaf names) still loads into a
    trainer of the same key order, its state paired by position."""
    a = _trainer(optimizer=ADAM)
    a.train_batch(_item(["vocals", "other"], 8064))
    path = a.save(str(tmp_path / "ck.npz"))
    old = _rewrite(path, str(tmp_path / "v1.npz"),
                   lambda d, f: ({k: v for k, v in d.items() if k != "names"},
                                 "sesa_tpu_torch.train/1"))
    b = _trainer(optimizer=ADAM, seed=7)
    b.load(old)
    for name, (m, v) in _moments(a).items():
        assert torch.equal(_moments(b)[name][0], m) and torch.equal(_moments(b)[name][1], v)


@pytest.mark.parametrize("drift", ["missing", "extra"])
def test_optimizer_state_refuses_a_missing_or_extra_name(tmp_path, drift):
    """A saved name list that lacks a live leaf (one name twice) or holds one
    the trainer does not have raises."""
    a = _trainer(optimizer=ADAM)
    a.train_batch(_item(["vocals", "other"], 8064))
    path = a.save(str(tmp_path / "ck.npz"))

    def edit(desc, fmt):
        names = desc["names"]
        names[1] = names[0] if drift == "missing" else "no.such.leaf"
        return desc, fmt

    bad = _rewrite(path, str(tmp_path / "bad.npz"), edit)
    with pytest.raises(ValueError, match="by name"):
        _trainer(optimizer=ADAM).load(bad)


def test_train_step_holds_tf32_off_through_backward():
    """Forward, loss and backward run inside one net_precision(None) block:
    a hook on the model's output reads both TF32 flags during the backward
    pass; the flags the caller had come back after the step."""
    seen = []

    def loss(recon, target):
        recon.register_hook(lambda g: seen.append(
            (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)) or g)
        return losses_mod.l1(recon, target)

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        _trainer(loss=loss).train_batch(_item(["vocals", "other"], 8064))
        assert seen == [(False, False)]
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_fit_with_augmentor_and_single_target():
    aug = StemAugmentor({"[default]": {"name": "Gain", "kwargs": {
        "min_gain_in_db": -3, "max_gain_in_db": 3, "p": 1.0}}}, seed=0)

    class _DS:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            item = _item(["vocals", "other"], 8064, seed=i)
            return {"audio": {k: v[0] for k, v in item["audio"].items()}, "track": f"t/{i}"}

    trainer = _trainer(augmentor=aug)
    history = trainer.fit(batch_iterator(_DS(), 2, seed=0), steps=3)
    assert len(history) == 3 and all(np.isfinite(history)) and trainer.step == 3
    d = _mdx_dict()
    d["training"]["target_instrument"] = "vocals"
    single = Trainer("mdx23c", d, loss=L1, device="cpu")
    assert single.target_stems() == ["vocals"]
    assert np.isfinite(single.train_batch(_item(["vocals", "other"], 8064)))
    assert _trainer(loss=None).loss_fn is losses_mod.multi_res_stft_l1


def test_validate_track():
    trainer = _trainer()
    item = _item(["vocals", "other"], 3 * 8064)
    track = {"audio": {k: v[0] for k, v in item["audio"].items()}, "track": "val/x"}
    for metric in ("si_snr", "snr"):
        scores = trainer.validate_track(track, metric=metric, window_seconds=0.05)
        assert set(scores) == {"vocals", "other"} and all(np.isfinite(list(scores.values())))
    assert all(p.grad is None for p in _flatten(trainer.params).values())


def test_trainer_device_and_mesh():
    """CUDA by default. ``mesh`` and ``param_rule`` are ported
    (tests/test_torch_parallel.py drives them on four gloo ranks): without a
    mesh a rule is kept (for ``load``) and the parameters stay plain tensors;
    a mesh needs a process group first."""
    if torch.cuda.is_available():
        assert _trainer(device=None).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _trainer(device=None)
    trainer = _trainer(param_rule=lambda path, leaf: None)
    assert trainer.mesh is None and trainer._param_rule is not None
    assert all(type(p) is torch.Tensor for p in _flatten(trainer.params).values())
    from sesa_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="init_process_group"):
        _trainer(mesh=make_mesh(1, device_type="cpu"))


# ---------------------------------------------------------------------------
# the kernels' autograd guard (meta tensors stand in for the card)
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, device="meta", dtype=dtype)


def _conv_params(d, e, k):
    return {"norm": {"weight": _meta(d), "bias": _meta(d)},
            "pw1": {"weight": _meta(2 * e, d, 1), "bias": _meta(2 * e)},
            "dw": {"weight": _meta(e, 1, k), "bias": _meta(e)},
            "bn": {"weight": _meta(e), "bias": _meta(e), "running_mean": _meta(e),
                   "running_var": _meta(e)},
            "pw2": {"weight": _meta(d, e, 1), "bias": _meta(d)}}


def _apollo_params(d, k):
    return {"dw_w": _meta(d, 1, k), "dw_b": _meta(d), "norm": _meta(d),
            "pw1_w": _meta(4 * d, d), "pw1_b": _meta(4 * d), "pw2_w": _meta(d, 4 * d),
            "pw2_b": _meta(d)}


# wrapper -> (kernel name, args builder, path of the input that requires grad)
GUARDED = {
    "vmem_attention": ("K3", A.vmem_attention,
                       lambda: ([_meta(2, 4, 256, 64) for _ in range(3)] + [0.125], {}), (0,)),
    "fused_attention_block": ("K1", A.fused_attention_block, lambda: (
        [_meta(2, 64, 128), _meta(128), _meta(384, 128), _meta(2, 128), _meta(2),
         _meta(128, 128), 2, 0.125, [_meta(64, 64), _meta(64, 64)]], {}), (8, 1)),
    "fused_ff_residual": ("K2", FF.fused_ff_residual, lambda: (
        [_meta(64, 128), _meta(128), _meta(256, 128), _meta(256), _meta(128, 256),
         _meta(128)], {}), (2,)),
    "fused_conformer_attention": ("K4", A.fused_conformer_attention, lambda: (
        [_meta(2, 64, 128), _meta(128), _meta(128), _meta(384, 128), _meta(33, 64),
         _meta(128, 128), _meta(128), 2], {}), (4,)),
    "fused_conformer_conv": ("K5", CB.fused_conformer_conv, lambda: (
        [_meta(2, 64, 128), _conv_params(128, 128, 7)], {}), (1, "bn", "running_var")),
    "fused_apollo_conv": ("K6", CB.fused_apollo_conv, lambda: (
        [_meta(2, 64, 128), _apollo_params(128, 5)], {}), (1, "pw2_w")),
    "fused_rope_attention": ("K7", A.fused_rope_attention, lambda: (
        [_meta(2, 64, 3 * 2 * 32), 2, 0.2, [_meta(64, 32), _meta(64, 32)]], {}), (3, 0)),
    "ssd_fused": ("K8", SSD.ssd_fused, lambda: (
        [_meta(1, 64, 2, 64, dtype=torch.float32), _meta(1, 64, 2, dtype=torch.float32),
         _meta(1, 64, 1, 128, dtype=torch.float32), _meta(1, 64, 1, 128, dtype=torch.float32)],
        {}), (0,)),
    "sdpa_int8": ("I8", A.sdpa_int8, lambda: ([_meta(1, 2, 64, 64) for _ in range(3)], {}),
                  (1,)),
}


def _requiring_grad(args, path):
    node = args
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = node[path[-1]].detach().requires_grad_(True)
    return args


def _call(fn, args, kwargs):
    try:
        fn(*args, **kwargs)
    except (ValueError, RuntimeError, KeyError, NotImplementedError) as e:
        return e
    return None


@pytest.mark.parametrize("name", list(GUARDED))
def test_kernel_wrappers_refuse_autograd(name):
    """On a non-CPU tensor each wrapper raises, naming its kernel, while grad
    mode is on and an input (nested ones too) requires grad; under no_grad,
    or with no input requiring grad, the guard lets the call through (it
    then stops at the meta device or the missing card); nothing launches."""
    kernel, fn, build, path = GUARDED[name]
    launches = fn.launches
    args, kwargs = build()
    args = _requiring_grad(args, path)
    err = _call(fn, args, kwargs)
    assert isinstance(err, RuntimeError) and "no backward" in str(err), err
    assert name in str(err) and kernel in str(err)
    with torch.no_grad():
        err = _call(fn, args, kwargs)
    assert err is None or "no backward" not in str(err)
    plain_args, kwargs = build()
    err = _call(fn, plain_args, kwargs)
    assert err is None or "no backward" not in str(err)
    assert fn.launches == launches


@pytest.mark.parametrize("name", list(GUARDED))
def test_kernel_wrappers_refuse_export(name, monkeypatch):
    """Under torch.export each wrapper raises ValueError naming its kernel
    where it would launch (ops._build.refuse_export): a ctypes call is no
    op the trace can record. Nothing launches."""
    kernel, fn, build, _ = GUARDED[name]
    launches = fn.launches
    args, kwargs = build()
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    err = _call(fn, args, kwargs)
    assert isinstance(err, ValueError) and "torch.export cannot trace" in str(err), err
    assert name in str(err) and kernel in str(err)
    assert fn.launches == launches


def test_plain_versions_stay_differentiable_on_the_cpu():
    """A CPU tensor takes the wrapper's plain version, which autograd
    records: the guard is for the card only."""
    rng = torch.Generator().manual_seed(0)
    x = torch.randn((1, 64, 2, 64), generator=rng).requires_grad_(True)
    a = -torch.rand((1, 64, 2), generator=rng)
    b, c = (torch.randn((1, 64, 1, 128), generator=rng) for _ in range(2))
    y = SSD.ssd_fused(x, a, b, c)
    y.sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    w = [torch.randn(s, generator=rng) * 0.1 for s in ((128,), (256, 128), (256,),
                                                      (128, 256), (128,))]
    xt = torch.randn((16, 128), generator=rng).requires_grad_(True)
    FF.fused_ff_residual(xt, *w).sum().backward()
    assert xt.grad is not None
