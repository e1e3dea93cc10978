"""Data parallelism of the port (``parallel/mesh.py``): the counterpart of
``stylish_tts_tpu/parallel``'s 1-D data mesh. The JAX package's 2-D and
hybrid meshes (``sharding_rules.py``) have no counterpart: no trainer path
uses them."""

from .mesh import (
    COLLECTIVES,
    PeerStepFailed,
    agree,
    all_mean,
    announce_failure,
    barrier,
    check_same,
    gather_host,
    gather_rows,
    global_count,
    global_mean,
    global_sum,
    init_data_parallel,
    is_writer,
    pmean_grads,
    rank,
    shard_rows,
    shutdown,
    world_size,
)

__all__ = [
    "COLLECTIVES", "PeerStepFailed", "agree", "all_mean", "announce_failure",
    "barrier", "check_same", "gather_host", "gather_rows",
    "global_count", "global_mean", "global_sum", "init_data_parallel",
    "is_writer", "pmean_grads", "rank", "shard_rows", "shutdown", "world_size",
]
