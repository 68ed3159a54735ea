"""The port's parallel layer: the data-parallel group (``mesh``) and the
train and eval steps (``train_step``). The model-axis layouts of the JAX
package (``fsdp``, ``tensor_parallel``, ``pipeline``, ``moe``) are not
ported yet."""

from xpretrain_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    DataMesh,
    current_mesh,
    destroy_distributed,
    gather_rows,
    local_batch_size,
    maybe_init_distributed,
    mesh_from_config,
    shard_host_batch,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "DataMesh",
    "current_mesh",
    "destroy_distributed",
    "gather_rows",
    "local_batch_size",
    "maybe_init_distributed",
    "mesh_from_config",
    "shard_host_batch",
]
