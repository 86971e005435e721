"""Device meshes: data-parallel chunk sharding and tensor parallelism
(counterpart of sesa_tpu/parallel/mesh.py).

JAX drives every device of a mesh from one process; torch runs one process
per device. So a mesh here is a ``torch.distributed`` DeviceMesh over the
ranks of the default process group, which the caller starts
(``torchrun --nproc-per-node N``, or ``init_process_group`` with its
address, world size and rank), and every rank makes the same calls:

- ``make_mesh`` builds the (data, model) mesh over ranks 0..n-1;
- ``shard_chunks`` gives the placements of a (batch, ch, chunk) batch on the
  data axis (``runtime.demix(..., mesh=)`` splits each batch's chunks so,
  with the weights whole on each rank);
- ``roformer_tp_rule`` / ``conformer_tp_rule`` and ``shard_params`` lay
  transformer weights out Megatron-style over the model axis as DTensors
  (qkv and ff-in split on the output dim, out and ff-out on the input dim),
  so each product runs on the local shards and each attention or
  feed-forward branch ends in one all-reduce, where GSPMD puts it in the
  JAX package. DTensor carries the placements through the branch's ops; the
  model enters a branch with ``tp_input`` and leaves it with
  ``local_replicated``, runs the attention cores on the local heads
  (``per_head``), so the residual stream and the rest of the model
  stay plain tensors (an op without a sharding rule, such as the complex
  iSTFT, would raise on a DTensor, and gradients must not carry DTensors
  into plain code). The training step runs under ``implicit_replication``
  for the plain constants a branch reads (rope tables, index tensors).
"""

from __future__ import annotations

import sys
from typing import Callable, Optional, Sequence

import torch

from sesa_tpu_torch.tree import tree_map

Rule = Callable[[tuple, torch.Tensor], tuple]


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              devices: Optional[Sequence[int]] = None, device_type: Optional[str] = None):
    """The 2-D ("data", "model") DeviceMesh of shape (n / model_parallel,
    model_parallel) over ranks ``devices`` (default 0..n-1) of the default
    process group; ``n`` defaults to the world size. ``device_type`` is
    "cuda" unless "cpu" is asked for (gloo, as the CPU tests run it)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a process group: start one rank per device "
                           "(torchrun) or call torch.distributed.init_process_group first")
    world = dist.get_world_size()
    n = n_devices or world
    if world < n:
        raise RuntimeError(f"make_mesh({n}): the process group has {world} ranks; start "
                           f"{n} (torch.distributed.init_process_group's world_size)")
    assert n % model_parallel == 0, (n, model_parallel)
    ranks = list(devices if devices is not None else range(n))[:n]
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(n // model_parallel, model_parallel)
    return DeviceMesh(device_type or "cuda", grid, mesh_dim_names=("data", "model"))


def shard_chunks(mesh) -> tuple:
    """Placements of a (batch, channels, chunk) batch: split on "data",
    replicated on "model"."""
    from torch.distributed.tensor import Replicate, Shard

    del mesh
    return (Shard(0), Replicate())


def _placements(*model_dim):
    from torch.distributed.tensor import Replicate, Shard

    return (Replicate(), Shard(model_dim[0]) if model_dim else Replicate())


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists; ``path`` is the
    tuple of keys and indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def replicate(mesh, tree):
    """A parameter tree replicated over the whole mesh, as DTensors."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda t: distribute_tensor(t, mesh, _placements()), tree)


def roformer_tp_rule(mesh) -> Rule:
    """The roformer tree's layout (sesa_tpu/parallel/mesh.py:50-65): qkv_w
    and lin1_w split on their rows, out_w and lin2_w on their columns,
    lin1_b on its rows, everything else replicated."""
    del mesh

    def rule(path, leaf):
        name = path[-1] if path else None
        if name in ("qkv_w", "lin1_w", "lin1_b"):
            return _placements(0)
        if name in ("out_w", "lin2_w"):
            return _placements(1)
        return _placements()

    return rule


def conformer_tp_rule(mesh) -> Rule:
    """The conformer family's layout (sesa_tpu/parallel/mesh.py:68-93): the
    (out, in) weights of lin1, to_q and to_kv split on their rows (lin1's
    bias too), lin2's and to_out's on their columns; the conv module and the
    norms replicated."""
    del mesh

    def rule(path, leaf):
        parent = path[-2] if len(path) >= 2 else None
        name = path[-1] if path else None
        if parent in ("lin1", "to_q", "to_kv") and name == "weight":
            return _placements(0)
        if parent == "lin1" and name == "bias":
            return _placements(0)
        if parent in ("lin2", "to_out") and name == "weight":
            return _placements(1)
        return _placements()

    return rule


def _branch_key(tree) -> Optional[str]:
    """The key that makes ``tree`` a tensor-parallel branch: the pre-norm
    ("norm_gamma" in the roformer tree, "norm" in the conformer family's)
    that every attention and feed-forward module starts with, or None."""
    if isinstance(tree, dict):
        for key in ("norm_gamma", "norm"):
            if key in tree:
                return key
    return None


def _branches(params, rule, split):
    """Paths of the pre-normed sub-modules around each leaf the rule splits:
    a tensor-parallel branch, whose every leaf becomes a DTensor. A split
    leaf outside every such module raises: nothing would enter or leave its
    product's layout."""
    out = set()

    def walk(tree, path, branch):
        if isinstance(tree, dict):
            if _branch_key(tree) is not None:
                branch = path
            items = tree.items()
        elif isinstance(tree, (list, tuple)):
            items = enumerate(tree)
        else:
            if split(rule(path, tree)):
                if branch is None:
                    raise ValueError(f"shard_params: the rule splits {'/'.join(map(str, path))}, "
                                     "which lies in no pre-normed attention or feed-forward "
                                     "module (a dict holding 'norm' or 'norm_gamma')")
                out.add(branch)
            return
        for k, v in items:
            walk(v, path + (k,), branch)

    walk(params, (), None)
    return out


def shard_params(mesh, params, rule: Optional[Rule] = None):
    """``params`` placed on ``mesh`` by ``rule(path, leaf)`` (default:
    :func:`roformer_tp_rule`), each rank keeping its shard.

    Every leaf of a tensor-parallel branch (the pre-normed attention or
    feed-forward module around a leaf the rule splits) becomes a DTensor,
    split or replicated as the rule says; the model enters such a branch
    with ``tp_input`` and leaves it with ``local_replicated``, so autograd
    sees one DTensor region per branch. Every other leaf stays a plain
    tensor, whole on each rank: the rest of the model runs as without a
    mesh. With a model axis of size 1 nothing is split, and every leaf stays
    plain (data parallelism needs no DTensor). A leaf split outside every
    branch raises ``ValueError``. Every rank passes the same full tensors
    (e.g. from one seed)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    rule = rule or roformer_tp_rule(mesh)
    split = lambda placements: any(not isinstance(p, Replicate)  # noqa: E731
                                   for p in placements)
    if mesh["model"].size() == 1:
        return params
    branches = _branches(params, rule, split)

    def place(path, t):
        if not any(path[:len(b)] == b for b in branches):
            return t
        return distribute_tensor(t, mesh, rule(path, t))

    return tree_map_with_path(place, params)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (none exists before torch.distributed.tensor
    is imported, so this imports nothing)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def tp_input(x, params):
    """``x`` entering a tensor-parallel branch whose parameters are
    ``params``: a replicated DTensor on their mesh when ``shard_params``
    made them DTensors (read from the branch's pre-norm, one leaf), else
    ``x`` as it is. Its backward sums the branch's partial gradients over
    the model axis and hands a plain tensor back."""
    ref = params.get(_branch_key(params))
    if isinstance(ref, dict):
        ref = ref.get("weight")
    if not is_dtensor(ref) or is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def replicated(x):
    """A DTensor made whole on every rank, still a DTensor (for a product
    whose split does not follow the heads: the roformer's fused qkv, whose
    rows are split as the JAX rule splits them); anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(placements=[Replicate()] * x.device_mesh.ndim)


def local_replicated(x):
    """``x`` as a plain tensor: a DTensor is made whole (an all-reduce of a
    partial sum, an all-gather of a shard) and its local tensor taken,
    differentiably; anything else is returned as it is. A tensor-parallel
    branch ends with this."""
    return replicated(x).to_local() if is_dtensor(x) else x


def per_head(fn, *tensors, shared=()):
    """``fn(*tensors, *shared)`` for a function whose heads are independent,
    over (b, h, ...) ``tensors``: with DTensors, each is brought to heads
    split over the model axis (replicated over the data axis), ``fn`` runs
    on the local heads as plain tensors, and the result is a DTensor split
    the same way. ``shared`` tensors (a position table, rope tables) reach
    every head whole; their gradient from this rank's heads is a partial sum
    over the model axis, and is marked so (a plain one gets its gradient back
    plain and summed). DTensor's own rules would flatten the batch and head
    dims inside an attention core's products, which torch 2.11 refuses while
    heads are split. Plain tensors run ``fn`` as it is."""
    if not any(is_dtensor(t) for t in tensors + tuple(shared)):
        return fn(*tensors, *shared)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = next(t for t in tensors + tuple(shared) if is_dtensor(t)).device_mesh
    whole = [Replicate()] * mesh.ndim
    split = whole[:-1] + [Shard(1)]
    local = [(t if is_dtensor(t) else DTensor.from_local(t, mesh, whole, run_check=False))
             .redistribute(placements=split).to_local() for t in tensors]
    common = [(t if is_dtensor(t) else DTensor.from_local(t, mesh, whole, run_check=False))
              .redistribute(placements=whole).to_local(grad_placements=whole[:-1] + [Partial()])
              for t in shared]
    out = fn(*local, *common)
    shape = (out.shape[0], tensors[0].shape[1]) + tuple(out.shape[2:])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(out, mesh, split, run_check=False, shape=shape, stride=stride)
