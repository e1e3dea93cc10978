"""Parallelism of the port on ``torch.distributed``: the counterpart of
``stylish_tts_tpu/parallel``.

* ``mesh.py``: data parallelism (the JAX 1-D data mesh), and the data and
  model axes with the model axis's differentiable collectives;
* ``sharding_rules.py``: the JAX package's 2-D ("data", "model") and hybrid
  ("dcn", "data", "model") meshes, with the same Megatron column/row rules
  over the same parameter paths, ``shard_state`` / ``gather_state`` and the
  step wrappers ``parallel_2d_step`` / ``parallel_hybrid_step``.
"""

from .mesh import (
    COLLECTIVES,
    PeerStepFailed,
    agree,
    all_mean,
    announce_failure,
    barrier,
    check_same,
    copy_to_model,
    gather_from_model,
    gather_host,
    gather_model_tensor,
    gather_rows,
    global_count,
    global_mean,
    global_sum,
    init_axes,
    init_data_parallel,
    is_writer,
    model_all_min,
    model_rank,
    model_size,
    pmean_grads,
    rank,
    reduce_from_model,
    scatter_to_model,
    shard_rows,
    shutdown,
    sum_over_model,
    world_size,
    world_size_global,
)
from .sharding_rules import (
    DATA_AXIS,
    DCN_AXIS,
    MODEL_AXIS,
    Mesh,
    gather_grads,
    gather_state,
    make_2d_mesh,
    make_hybrid_mesh,
    module_specs,
    parallel_2d_step,
    parallel_hybrid_step,
    shard_module,
    shard_state,
    sharded_parameters,
    spec_for_leaf,
)

__all__ = [
    "COLLECTIVES", "DATA_AXIS", "DCN_AXIS", "MODEL_AXIS", "Mesh", "PeerStepFailed",
    "agree", "all_mean", "announce_failure", "barrier", "check_same", "copy_to_model",
    "gather_from_model", "gather_grads", "gather_host", "gather_model_tensor",
    "gather_rows", "gather_state", "global_count", "global_mean", "global_sum",
    "init_axes", "init_data_parallel", "is_writer", "make_2d_mesh", "make_hybrid_mesh",
    "model_all_min", "model_rank", "model_size", "module_specs", "parallel_2d_step",
    "parallel_hybrid_step", "pmean_grads", "rank", "reduce_from_model",
    "scatter_to_model", "shard_module", "shard_rows", "shard_state",
    "sharded_parameters", "shutdown", "spec_for_leaf", "sum_over_model", "world_size",
    "world_size_global",
]
