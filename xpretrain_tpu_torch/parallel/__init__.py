"""The port's parallel layer: the mesh and its process groups (``mesh``),
tensor parallelism (``tensor_parallel``), ZeRO-3 and the trainers' layout
policy (``fsdp``), and the train and eval steps (``train_step``). The JAX
package's ``pipeline``, ``moe`` and ``ops/ring_attention`` are not ported
yet (ROADMAP Queue 1)."""

from xpretrain_tpu_torch.parallel.fsdp import (
    apply_layouts,
    fsdp_pspec,
    gathered,
    resolve_shardings,
)
from xpretrain_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    DataMesh,
    current_mesh,
    destroy_distributed,
    gather_rows,
    init_model_axis,
    local_batch_size,
    maybe_init_distributed,
    mesh_from_config,
    shard_host_batch,
)
from xpretrain_tpu_torch.parallel.tensor_parallel import (
    apply_tensor_parallel,
    hybrid_state_pspec,
    tp_pspec,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "DataMesh",
    "apply_layouts",
    "apply_tensor_parallel",
    "current_mesh",
    "destroy_distributed",
    "fsdp_pspec",
    "gather_rows",
    "gathered",
    "hybrid_state_pspec",
    "init_model_axis",
    "local_batch_size",
    "maybe_init_distributed",
    "mesh_from_config",
    "resolve_shardings",
    "shard_host_batch",
    "tp_pspec",
]
