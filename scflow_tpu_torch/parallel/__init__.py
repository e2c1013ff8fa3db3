"""Data parallelism over torch.distributed: the port's counterpart of
scflow_tpu/parallel (dist.py: the process bootstrap, gathers and the global
batch of a train step; mesh.py: the device mesh and batch placement)."""

from scflow_tpu_torch.parallel.dist import (
    LAUNCHERS,
    all_gather_object,
    average_gradients,
    average_logs,
    barrier,
    broadcast_module,
    global_batch,
    is_main,
    launch_env,
    maybe_initialize_distributed,
    merge_sharded_results,
    rank_world,
)
from scflow_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    replicate,
    replicated_sharding,
)

__all__ = [
    "LAUNCHERS",
    "Mesh",
    "all_gather_object",
    "average_gradients",
    "average_logs",
    "barrier",
    "batch_sharding",
    "broadcast_module",
    "global_batch",
    "is_main",
    "launch_env",
    "make_mesh",
    "maybe_initialize_distributed",
    "merge_sharded_results",
    "rank_world",
    "replicate",
    "replicated_sharding",
]
