"""sesa_tpu_torch.parallel on four gloo ranks on the CPU (a 2 x 2 ("data",
"model") mesh), held against sesa_tpu's mesh tests (tests/test_parallel.py):
the mesh, the layouts, demix over the data axis, the tensor-parallel
mel_band_conformer and bs_roformer forwards against their replicated
forwards and JAX's apply, and the Trainer's steps (the conformer rule and
the default roformer rule), save and load under the mesh against one
process.

The ranks start once, in a module-scoped fixture, and run
tests/_torch_parallel_ranks.py; each case below asserts on what they
returned. A rank that does not report within 120 s fails the fixture."""

import multiprocessing as mp
import queue as queue_mod
import socket

import numpy as np
import pytest
import torch

import jax

from ml_collections import ConfigDict

from sesa_tpu.models import bs_roformer as jax_bs
from sesa_tpu.models import mel_band_conformer as jax_mbc
from tests import _torch_parallel_ranks as R

WORLD = 4
JOIN_S = 120


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_ref():
    """The JAX conformer's and bs_roformer's parameters (numpy), their one
    input and their outputs."""
    x = (np.random.default_rng(0).standard_normal((2, 2, 2048)) * 0.1).astype(np.float32)
    params, out = {}, {}
    for name, model, mcfg in (("conformer", jax_mbc, R.CONFORMER["model"]),
                              ("roformer", jax_bs, R.ROFORMER["model"])):
        cfg = ConfigDict({"model": mcfg})
        p = jax.jit(lambda k: model.init(k, cfg))(jax.random.PRNGKey(0))
        out[name] = np.asarray(jax.jit(lambda q, v: model.apply(q, cfg, v))(p, x))
        params[name] = jax.tree.map(np.asarray, p)
    return params, x, out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the ranks, build the JAX reference while they run their first
    checks, hand it to them, collect every rank's results."""
    ctx = mp.get_context("spawn")
    q, inbox = ctx.Queue(), ctx.Queue()
    port, work = _free_port(), str(tmp_path_factory.mktemp("mesh"))
    procs = [ctx.Process(target=R.rank_main, args=(r, WORLD, port, inbox, work, q))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    results = {}
    try:
        params, x, jax_out = _jax_ref()
        for _ in range(WORLD):
            inbox.put((params, x))
        for _ in range(WORLD):
            res = q.get(timeout=JOIN_S)
            results[res["rank"]] = res
    except queue_mod.Empty:
        pytest.fail(f"ranks {sorted(set(range(WORLD)) - set(results))} did not report "
                    f"within {JOIN_S} s")
    finally:
        for p in procs:
            p.join(timeout=JOIN_S)
            if p.is_alive():
                p.kill()
    for res in results.values():
        assert "error" not in res, res["error"]
    return [results[r] for r in range(WORLD)], jax_out


def test_make_mesh_needs_a_process_group():
    from sesa_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(4, model_parallel=2, device_type="cpu")


def test_make_mesh_shape_and_names(ranks):
    for r in ranks[0]:
        assert r["mesh_shape"] == (2, 2)
        assert r["mesh_names"] == ("data", "model")


def test_shard_chunks_placements(ranks):
    assert all(r["shard_chunks"] for r in ranks[0])


def test_roformer_rule_placements(ranks):
    """tests/test_parallel.py:22-38: qkv_w split on its rows over "model"
    (P("model", None)), out_w on its columns, the final norm replicated and
    left a plain tensor; inside a branch a replicated leaf is a DTensor."""
    for r in ranks[0]:
        assert r["roformer_rule"] == {
            "qkv_w": ["Replicate()", "Shard(dim=0)"], "out_w": ["Replicate()", "Shard(dim=1)"],
            "lin1_b": ["Replicate()", "Shard(dim=0)"], "lin2_w": ["Replicate()", "Shard(dim=1)"],
            "attn.norm_gamma": ["Replicate()", "Replicate()"]}
        assert r["roformer_rule_final_norm"] == ["Replicate()", "Replicate()"]
        assert r["final_norm_plain"] == "Tensor"
        assert r["qkv_local_rows"] == 3 * 4 * 8 // 2


def test_demix_over_the_data_axis(ranks):
    """demix(mesh) equals the single-process demix within 1e-6 on every
    rank; batch 3 over a data axis of 2 raises."""
    for r in ranks[0]:
        assert r["demix_err"] <= 1e-6
        assert "divisible" in r["demix_bad"]


def test_shard_params_without_a_model_axis_keeps_plain_tensors(ranks):
    """A (4, 1) mesh splits nothing: shard_params hands the tree back as it
    is, and data parallelism runs on plain tensors."""
    assert all(r["dp_only_same_tree"] for r in ranks[0])


def test_shard_params_refuses_a_split_outside_a_branch(ranks):
    """A rule that splits a leaf in no pre-normed attention or feed-forward
    module raises, naming the leaf, instead of leaving it whole unsaid."""
    for r in ranks[0]:
        assert "block/qkv_w" in r["unbranched_split"], r["unbranched_split"]


def test_tensor_parallel_conformer_forward(ranks):
    """GSPMD's test (tests/test_parallel.py:111-139) in DTensor: the
    tensor-parallel forward equals the replicated forward and JAX's apply
    within 2e-5, on weights carried from JAX."""
    results, ref = ranks
    for r in results:
        assert r["conformer_lin1"] == ["Replicate()", "Shard(dim=0)"]
        assert r["conformer_tp_type"] == "Tensor"
        np.testing.assert_allclose(r["conformer_tp"], r["conformer_replicated"], atol=2e-5)
        np.testing.assert_allclose(r["conformer_tp"], ref["conformer"], atol=2e-5)


def test_tensor_parallel_roformer_forward(ranks):
    """The same for the bs_roformer under the default rule (the row-split
    fused qkv gathered before the heads split, the rope tables reaching the
    local heads, the head-split out_w): the tensor-parallel forward equals
    the replicated forward and JAX's apply within 2e-5."""
    results, ref = ranks
    for r in results:
        assert r["roformer_tp_type"] == "Tensor"
        np.testing.assert_allclose(r["roformer_tp"], r["roformer_replicated"], atol=2e-5)
        np.testing.assert_allclose(r["roformer_tp"], ref["roformer"], atol=2e-5)


def test_trainer_steps_equal_one_process(ranks):
    """Two SGD steps of Trainer(mesh 2 x 2, conformer rule) on a global batch
    of 4 equal one process's two steps: losses within 1e-6 relative,
    every parameter within 1e-5 of its largest value (f32 sums taken in
    another order); a batch of 3 raises."""
    for r in ranks[0]:
        np.testing.assert_allclose(r["loss_mesh"], r["loss_single"], rtol=1e-6)
        assert r["loss_mesh"][1] < r["loss_mesh"][0]
        assert r["param_keys_equal"] and r["param_err"] <= 1e-5
        assert "divisible" in r["odd_batch"]


def test_trainer_default_rule_step_equals_one_process(ranks):
    """One SGD step of Trainer(mesh 2 x 2) on the bs_roformer with no rule
    (roformer_tp_rule, as in the JAX Trainer) equals one process's step:
    loss within 1e-6 relative, every parameter within 1e-5 of its largest
    value."""
    for r in ranks[0]:
        assert r["roformer_qkv_layout"] == ["Replicate()", "Shard(dim=0)"]
        single, mesh = r["roformer_loss"]
        np.testing.assert_allclose(mesh, single, rtol=1e-6)
        assert r["roformer_param_err"] <= 1e-5


def test_trainer_save_and_load_under_the_mesh(ranks):
    """save under the mesh writes the unsharded trainer's file (the same
    keys; values within 1e-6, the steps' sums differ); load into a fresh
    sharded trainer restores every parameter bit for bit on the trainer's
    own rule, and the next steps agree."""
    for r in ranks[0]:
        assert r["save_keys_equal"] and r["save_err"] <= 1e-6
        assert r["load_equal"]
        assert r["load_layout"] == ["Replicate()", "Shard(dim=0)"]
        assert r["next_loss"][0] == r["next_loss"][1]
        assert r["step"] == 3
