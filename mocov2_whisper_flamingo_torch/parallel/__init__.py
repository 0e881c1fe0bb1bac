"""Multi-card parallelism (counterpart of ``parallel/``): the process mesh,
the sharding rules and the Megatron tensor-parallel functions.

The JAX package's single ``Mesh`` with GSPMD-placed collectives becomes one
process per card: ``torch.distributed`` process groups along the ``data``
and ``model`` axes, a flat all-reduce of the gradients over the data group,
and explicit column- and row-parallel linears over the model group.
"""

from mocov2_whisper_flamingo_torch.parallel.mesh import (  # noqa: F401
    DEFAULT_PARAM_RULES,
    Mesh,
    batch_sharding,
    gather_state_dict,
    initialize_distributed,
    load_whole_state_dict,
    make_mesh,
    param_sharding,
    shard_batch,
    shard_module,
)
