from sesa_tpu_torch.parallel.mesh import (  # noqa: F401
    conformer_tp_rule,
    make_mesh,
    replicate,
    roformer_tp_rule,
    shard_chunks,
    shard_params,
)
