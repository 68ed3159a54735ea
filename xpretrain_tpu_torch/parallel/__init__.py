"""The port's parallel layer: the mesh and its process groups (``mesh``),
the ring shift (``p2p``), tensor parallelism (``tensor_parallel``), ZeRO-3
and the trainers' layout policy (``fsdp``), the GPipe pipeline
(``pipeline``), the expert-parallel MoE FFN (``moe``), and the train and
eval steps (``train_step``). Ring attention is ``ops/ring_attention.py``.
Every name the JAX package's ``parallel`` exports is exported here; a
``*_sharding(s)`` name gives the port's form of JAX's sharding: a partition
spec as a tuple (flax layout), or, for the pipeline and the experts, the
rank's slice itself."""

from xpretrain_tpu_torch.parallel.fsdp import (
    apply_layouts,
    fsdp_param_shardings,
    fsdp_pspec,
    fsdp_state_shardings,
    gathered,
    resolve_shardings,
)
from xpretrain_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    DataMesh,
    batch_sharding,
    create_mesh,
    current_mesh,
    destroy_distributed,
    gather_rows,
    init_model_axis,
    local_batch_size,
    maybe_init_distributed,
    mesh_from_config,
    replicated_sharding,
    shard_host_batch,
)
from xpretrain_tpu_torch.parallel.moe import (
    EXPERT_AXIS,
    MoeFfn,
    moe_param_shardings,
    moe_params_from_flax,
    moe_pspec,
)
from xpretrain_tpu_torch.parallel.p2p import ring_shift
from xpretrain_tpu_torch.parallel.pipeline import (
    PIPE_AXIS,
    make_pipeline,
    pipeline_param_shardings,
    pipelined_bert_encoder,
    stack_layer_params,
    stacked_bert_params_from_flax,
    unstack_layer_params,
)
from xpretrain_tpu_torch.parallel.tensor_parallel import (
    apply_tensor_parallel,
    hybrid_state_pspec,
    hybrid_state_shardings,
    tp_param_shardings,
    tp_pspec,
)

__all__ = [
    "DATA_AXIS",
    "EXPERT_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "DataMesh",
    "MoeFfn",
    "apply_layouts",
    "apply_tensor_parallel",
    "batch_sharding",
    "create_mesh",
    "current_mesh",
    "destroy_distributed",
    "fsdp_param_shardings",
    "fsdp_pspec",
    "fsdp_state_shardings",
    "gather_rows",
    "gathered",
    "hybrid_state_pspec",
    "hybrid_state_shardings",
    "init_model_axis",
    "local_batch_size",
    "make_pipeline",
    "maybe_init_distributed",
    "mesh_from_config",
    "moe_param_shardings",
    "moe_params_from_flax",
    "moe_pspec",
    "pipeline_param_shardings",
    "pipelined_bert_encoder",
    "replicated_sharding",
    "resolve_shardings",
    "ring_shift",
    "shard_host_batch",
    "stack_layer_params",
    "stacked_bert_params_from_flax",
    "tp_param_shardings",
    "tp_pspec",
    "unstack_layer_params",
]
