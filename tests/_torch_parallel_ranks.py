"""The rank side of tests/test_torch_parallel.py: one process per rank of a
gloo group on the CPU, each running every check and returning plain
results (numbers, strings, numpy arrays) through a queue. It imports no JAX:
the JAX references come from the parent, as numpy."""

import os
import traceback

import numpy as np

SR = 44100
# tests/test_parallel.py:111-139's mel_band_conformer
CONFORMER = {"model": dict(dim=32, depth=1, stereo=True, num_stems=1, num_bands=12,
                           time_conformer_depth=1, freq_conformer_depth=1, stft_n_fft=128,
                           stft_hop_length=32, stft_win_length=128),
             "audio": {"chunk_size": 2048, "sample_rate": SR},
             "training": {"instruments": ["vocals", "other"], "target_instrument": "vocals"}}
# tests/test_parallel.py:22-38's bs_roformer
ROFORMER = {"model": dict(dim=32, depth=1, stereo=True, num_stems=1, time_transformer_depth=1,
                          freq_transformer_depth=1,
                          freqs_per_bands=[2] * 8 + [4] * 4 + [16, 17], dim_head=8, heads=4,
                          stft_n_fft=128, stft_hop_length=32, stft_win_length=128)}
OPTIMIZER = {"optimizer": {"name": "SGD", "kwargs": {"lr": 0.05, "momentum": 0.9}}}
LOSS = {"name": "L1Loss"}


def _mesh_checks(torch, out):
    from torch.distributed.tensor import Replicate, Shard

    from sesa_tpu_torch.configs import AttrDict
    from sesa_tpu_torch.models import bs_roformer
    from sesa_tpu_torch.parallel import make_mesh, roformer_tp_rule, shard_chunks, shard_params

    mesh = make_mesh(4, model_parallel=2, device_type="cpu")
    out["mesh_shape"] = tuple(mesh.mesh.shape)
    out["mesh_names"] = tuple(mesh.mesh_dim_names)
    out["shard_chunks"] = shard_chunks(mesh) == (Shard(0), Replicate())
    cfg = AttrDict(ROFORMER)
    params = bs_roformer.init(torch.Generator().manual_seed(0), cfg)
    placed = shard_params(mesh, params)
    attn = placed["layers"][0]["time"]["layers"][0]["attn"]
    ff = placed["layers"][0]["time"]["layers"][0]["ff"]
    rule = roformer_tp_rule(mesh)
    out["roformer_rule"] = {
        name: [repr(p) for p in t.placements]
        for name, t in (("qkv_w", attn["qkv_w"]), ("out_w", attn["out_w"]),
                        ("lin1_b", ff["lin1_b"]), ("lin2_w", ff["lin2_w"]),
                        ("attn.norm_gamma", attn["norm_gamma"]))}
    out["roformer_rule_final_norm"] = [repr(p) for p in rule(("final_norm_gamma",),
                                                             params["final_norm_gamma"])]
    out["final_norm_plain"] = type(placed["final_norm_gamma"]).__name__
    out["qkv_local_rows"] = int(attn["qkv_w"].to_local().shape[0])
    # a model axis of size 1 splits nothing: every leaf stays a plain tensor
    flat = make_mesh(4, model_parallel=1, device_type="cpu")
    out["dp_only_same_tree"] = shard_params(flat, params) is params
    # a split leaf outside every pre-normed branch (Apollo's qkv_w sits beside
    # "input_norm") has no branch to enter or leave its layout
    try:
        shard_params(mesh, {"block": {"input_norm": torch.ones(4),
                                      "qkv_w": torch.ones(12, 4)}})
        out["unbranched_split"] = "no error"
    except ValueError as e:
        out["unbranched_split"] = str(e)
    return mesh


def _demix_checks(torch, mesh, out):
    from sesa_tpu_torch.runtime import DemixSpec, demix

    def model_apply(params, chunks):
        return (chunks * params["g"])[:, None]

    params = {"g": torch.tensor(0.5)}
    spec = DemixSpec(chunk_size=1000, num_overlap=2, batch_size=4, num_stems=1, num_channels=2)
    mix = np.random.default_rng(0).standard_normal((2, 7000)).astype(np.float32)
    ref = demix(model_apply, params, mix, spec, device="cpu")
    got = demix(model_apply, params, mix, spec, device="cpu", mesh=mesh, seg_batches=1)
    out["demix_err"] = float(np.abs(got - ref).max())
    bad = DemixSpec(chunk_size=1000, num_overlap=2, batch_size=3, num_stems=1, num_channels=2)
    try:
        demix(model_apply, params, mix, bad, device="cpu", mesh=mesh)
        out["demix_bad"] = "no error"
    except ValueError as e:
        out["demix_bad"] = str(e)


def _tp_forward(torch, mesh, jax_params, x, out):
    """The tensor-parallel forwards of the mel-band conformer (its rule) and
    of the bs_roformer (the default rule: the row-split fused qkv, the rope
    tables reaching the local heads, the head-split out_w) on weights carried
    from JAX, beside their replicated forwards."""
    from torch.distributed.tensor.experimental import implicit_replication

    from sesa_tpu_torch.configs import AttrDict
    from sesa_tpu_torch.convert.from_jax import params_from_jax
    from sesa_tpu_torch.models import bs_roformer, mel_band_conformer
    from sesa_tpu_torch.parallel import conformer_tp_rule, shard_params

    xt = torch.from_numpy(x)
    for name, model, cfg, convert, rule in (
            ("conformer", mel_band_conformer, AttrDict(CONFORMER), "mel_band_conformer",
             conformer_tp_rule(mesh)),
            ("roformer", bs_roformer, AttrDict(ROFORMER),
             bs_roformer.spec_from_config(ROFORMER["model"]), None)):
        params = params_from_jax(jax_params[name], convert, cfg)
        out[f"{name}_replicated"] = model.apply(params, cfg, xt).numpy()
        placed = shard_params(mesh, params, rule=rule)
        with implicit_replication():
            got = model.apply(placed, cfg, xt)
        out[f"{name}_tp_type"] = type(got).__name__
        out[f"{name}_tp"] = got.numpy()
        if name == "conformer":
            lin1 = placed["layers"][0]["time"]["layers"][0]["ff1"]["lin1"]["weight"]
            out["conformer_lin1"] = [repr(p) for p in lin1.placements]


def _trainer_checks(torch, mesh, workdir, out):
    from sesa_tpu_torch.configs import AttrDict
    from sesa_tpu_torch.parallel import conformer_tp_rule
    from sesa_tpu_torch.train import Trainer, _flatten

    from sesa_tpu_torch.models import bs_roformer, mel_band_conformer

    params = mel_band_conformer.init(torch.Generator().manual_seed(0), AttrDict(CONFORMER))
    rng = np.random.default_rng(5)
    item = {"audio": {"mixture": rng.standard_normal((4, 2, 2048)).astype(np.float32) * 0.3,
                      "vocals": rng.standard_normal((4, 2, 2048)).astype(np.float32) * 0.1}}
    cfg = AttrDict(CONFORMER)
    rule = conformer_tp_rule(mesh)
    single = Trainer("mel_band_conformer", cfg, optimizer=OPTIMIZER, loss=LOSS, params=params,
                     device="cpu")
    sharded = Trainer("mel_band_conformer", cfg, optimizer=OPTIMIZER, loss=LOSS, params=params,
                      device="cpu", mesh=mesh, param_rule=rule)
    out["loss_single"] = [single.train_batch(item) for _ in range(2)]
    out["loss_mesh"] = [sharded.train_batch(item) for _ in range(2)]

    def full(trainer):
        return {k: (v.full_tensor() if hasattr(v, "full_tensor") else v).detach().numpy()
                for k, v in _flatten(trainer.params).items()}

    a, b = full(single), full(sharded)
    out["param_keys_equal"] = sorted(a) == sorted(b)
    out["param_err"] = max(float(np.abs(a[k] - b[k]).max() / (np.abs(a[k]).max() + 1e-12))
                           for k in a)
    try:
        sharded.train_batch({"audio": {k: v[:3] for k, v in item["audio"].items()}})
        out["odd_batch"] = "no error"
    except ValueError as e:
        out["odd_batch"] = str(e)

    # save under the mesh (every rank calls, one writes), the unsharded file beside it
    path = sharded.save(os.path.join(workdir, "mesh.npz"))
    if torch.distributed.get_rank() == 0:
        single.save(os.path.join(workdir, "single.npz"))
    torch.distributed.barrier()
    with np.load(path) as zm, np.load(os.path.join(workdir, "single.npz")) as zs:
        out["save_keys_equal"] = sorted(zm.files) == sorted(zs.files)
        out["save_err"] = max(float(np.abs(zm[k] - zs[k]).max())
                              for k in zm.files if k.startswith(("params/", "opt/")))
    fresh = Trainer("mel_band_conformer", cfg, optimizer=OPTIMIZER, loss=LOSS, seed=1,
                    device="cpu", mesh=mesh, param_rule=rule)
    fresh.load(path)
    c = full(fresh)
    out["load_equal"] = all(np.array_equal(b[k], c[k]) for k in b)
    out["load_layout"] = [repr(p) for p in
                          fresh.params["layers"][0]["time"]["layers"][0]["ff1"]["lin1"]
                          ["weight"].placements]
    out["next_loss"] = [sharded.train_batch(item), fresh.train_batch(item)]
    out["step"] = fresh.step

    # the bs_roformer under the mesh's default rule (roformer_tp_rule)
    rcfg = AttrDict(dict(ROFORMER, audio={"chunk_size": 2048, "sample_rate": SR},
                         training=CONFORMER["training"]))
    rparams = bs_roformer.init(torch.Generator().manual_seed(0), rcfg)
    single = Trainer("bs_roformer", rcfg, optimizer=OPTIMIZER, loss=LOSS, params=rparams,
                     device="cpu")
    sharded = Trainer("bs_roformer", rcfg, optimizer=OPTIMIZER, loss=LOSS, params=rparams,
                      device="cpu", mesh=mesh)
    out["roformer_qkv_layout"] = [repr(p) for p in sharded.params["layers"][0]["time"]
                                  ["layers"][0]["attn"]["qkv_w"].placements]
    out["roformer_loss"] = [single.train_batch(item), sharded.train_batch(item)]
    a, b = full(single), full(sharded)
    out["roformer_param_err"] = max(float(np.abs(a[k] - b[k]).max() / (np.abs(a[k]).max()
                                                                        + 1e-12)) for k in a)


def rank_main(rank, world, port, inbox, workdir, queue):
    """One rank: every check, then its results on ``queue``. The JAX
    parameters and input of the forward check arrive on ``inbox`` while the
    other checks run."""
    out = {"rank": rank}
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world)
        import time
        t = [time.perf_counter()]
        try:
            mesh = _mesh_checks(torch, out)
            t.append(time.perf_counter())
            _demix_checks(torch, mesh, out)
            t.append(time.perf_counter())
            _trainer_checks(torch, mesh, workdir, out)
            t.append(time.perf_counter())
            _tp_forward(torch, mesh, *inbox.get(timeout=120), out)
            t.append(time.perf_counter())
            out["times"] = list(np.diff(t))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the test, which fails on it
        out["error"] = traceback.format_exc()
    queue.put(out)
