"""Process bootstrap, cross-process gathers and the global batch: the port's
counterpart of scflow_tpu/parallel/dist.py over torch.distributed.

JAX wires every host into one runtime and runs one jitted step on the
sharded global batch, so XLA computes that step's batch statistics, loss
denominators and gradients over the whole global batch.  Here each rank
runs its own step on its local batch, and the reductions that JAX's step
makes over the batch cross the ranks explicitly:

- `global_batch(group)` is the scope of one train step: inside it
  `batch_sum` (BatchNorm's training statistics, with gradient),
  `batch_total` (raft_loss's valid-pixel count, without) and `batch_rows`
  (the rows of the global batch the render augmentations draw for) span the
  ranks of `group`; outside it, or for a group of one rank, they are the
  local values, so a run without a launcher computes what it did before.
- `average_gradients` and `average_logs` make the step's gradients and
  logs the global batch's.

The bootstrap is env-gated as JAX's is: `maybe_initialize_distributed`
with launcher 'none' and no SCFLOW_DIST in the environment does nothing.
"""

import contextlib
import contextvars
import os
import subprocess
from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

LAUNCHERS = ("none", "jax", "pytorch", "slurm", "mpi")

_GROUP: contextvars.ContextVar = contextvars.ContextVar("scflow_global_batch", default=None)


def _env_int(environ: Mapping[str, str], *names: str, default: Optional[int] = None) -> int:
    for name in names:
        if environ.get(name, "") != "":
            return int(environ[name])
    if default is None:
        raise RuntimeError(f"the launcher's environment sets none of {names}")
    return default


def _split_address(address: str):
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r} is not HOST:PORT")
    return host, int(port)


def launch_env(launcher: str, environ: Optional[Mapping[str, str]] = None) -> Dict[str, Any]:
    """The process's place in the job from the launcher's environment:
    {rank, world_size, local_rank, local_world_size, master_addr,
    master_port}.

    'pytorch' and 'jax' read torchrun's RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT; JAX's SCFLOW_COORDINATOR
    (HOST:PORT), SCFLOW_NUM_PROCESSES and SCFLOW_PROCESS_ID take their
    places where set.  'slurm' reads SLURM_PROCID, SLURM_NTASKS,
    SLURM_LOCALID and SLURM_NTASKS_PER_NODE, the address from MASTER_ADDR or
    the first host of SLURM_NODELIST (mmcv's _init_dist_slurm), the port
    from MASTER_PORT (default 29500).  'mpi' reads OMPI_COMM_WORLD_RANK,
    _SIZE, _LOCAL_RANK and _LOCAL_SIZE, with MASTER_ADDR (default
    127.0.0.1) and MASTER_PORT (default 29500), as mmcv's _init_dist_mpi."""
    env = os.environ if environ is None else environ
    if launcher not in LAUNCHERS or launcher == "none":
        raise ValueError(f"launcher {launcher!r}: expected one of {LAUNCHERS[1:]}")
    if launcher == "slurm":
        rank = _env_int(env, "SLURM_PROCID")
        world = _env_int(env, "SLURM_NTASKS")
        local = _env_int(env, "SLURM_LOCALID", default=0)
        per_node = env.get("SLURM_NTASKS_PER_NODE", "").split("(")[0]
        local_world = int(per_node) if per_node.isdigit() else world
        addr = env.get("MASTER_ADDR") or subprocess.run(
            ["scontrol", "show", "hostname", env["SLURM_NODELIST"]], capture_output=True,
            text=True, check=True).stdout.split()[0]
        port = _env_int(env, "MASTER_PORT", default=29500)
    elif launcher == "mpi":
        rank = _env_int(env, "OMPI_COMM_WORLD_RANK")
        world = _env_int(env, "OMPI_COMM_WORLD_SIZE")
        local = _env_int(env, "OMPI_COMM_WORLD_LOCAL_RANK", default=0)
        local_world = _env_int(env, "OMPI_COMM_WORLD_LOCAL_SIZE", default=world)
        addr = env.get("MASTER_ADDR") or "127.0.0.1"
        port = _env_int(env, "MASTER_PORT", default=29500)
    else:
        rank = _env_int(env, "SCFLOW_PROCESS_ID", "RANK")
        world = _env_int(env, "SCFLOW_NUM_PROCESSES", "WORLD_SIZE")
        local = _env_int(env, "LOCAL_RANK", default=rank)
        local_world = _env_int(env, "LOCAL_WORLD_SIZE", default=world)
        if env.get("SCFLOW_COORDINATOR"):
            addr, port = _split_address(env["SCFLOW_COORDINATOR"])
        else:
            addr = env.get("MASTER_ADDR") or "127.0.0.1"
            port = _env_int(env, "MASTER_PORT")
    if not 0 <= rank < world or not 0 <= local < local_world:
        raise ValueError(f"rank {rank} of {world} (local {local} of {local_world}) is not a "
                         "place in the job")
    return dict(rank=rank, world_size=world, local_rank=local, local_world_size=local_world,
                master_addr=addr, master_port=port)


def maybe_initialize_distributed(launcher: str = "none", device=None,
                                 logger=None) -> torch.device:
    """Join the job the launcher started (torch.distributed.init_process_group
    over tcp://MASTER_ADDR:MASTER_PORT, launch_env's rank and world size) and
    return this rank's device.  launcher 'none' without SCFLOW_DIST=1 in the
    environment starts nothing and returns resolve_device(device); 'jax' and
    the mmcv names 'pytorch', 'slurm' and 'mpi' all mean "a job was launched
    around me" (SCFLOW_DIST=1 with 'none' reads torchrun's variables).

    The device is cuda:{LOCAL_RANK % cards}, or the CPU when device='cpu'
    is asked for.  The backend follows from that layout: 'nccl' when every
    local rank has a card of its own, 'gloo' on the CPU or when ranks share
    a card (NCCL refuses two ranks on one device); `logger` (default: the
    port's) gets the choice.  A group that fails to start raises; nothing
    falls back to another backend or to one process."""
    from scflow_tpu_torch.device import resolve_device

    gated = os.environ.get("SCFLOW_DIST", "").lower() in ("1", "true", "yes")
    if launcher not in LAUNCHERS:
        raise ValueError(f"unknown launcher {launcher!r}; expected one of {LAUNCHERS}")
    if launcher == "none" and not gated:
        return resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized in this process")
    place = launch_env("pytorch" if launcher == "none" else launcher)
    if device is not None and torch.device(device).type == "cpu":
        dev, backend, why = torch.device("cpu"), "gloo", "the CPU"
    else:
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                               "ranks on the CPU")
        dev = torch.device("cuda", place["local_rank"] % cards)
        torch.cuda.set_device(dev)
        if place["local_world_size"] <= cards:
            backend, why = "nccl", "a card per local rank"
        else:
            backend, why = "gloo", (f"{place['local_world_size']} local ranks share {cards} "
                                    "card(s), which NCCL refuses")
    dist.init_process_group(backend, init_method=f"tcp://{place['master_addr']}:"
                            f"{place['master_port']}", rank=place["rank"],
                            world_size=place["world_size"])
    if logger is None:
        from scflow_tpu_torch.runtime.logger import get_logger

        logger = get_logger()
    logger.info(f"torch.distributed: rank {place['rank']} of {place['world_size']} "
                f"(local {place['local_rank']} of {place['local_world_size']}) on {dev}, "
                f"backend {backend} ({why})")
    return dev


def rank_world(group=None):
    """(rank, world size) in `group` (default: the whole job); (0, 1)
    without an initialized process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def is_main() -> bool:
    """True on rank 0, the rank that writes files (and without a group)."""
    return rank_world()[0] == 0


def barrier() -> None:
    """Wait for every rank (nothing without a group of more than one)."""
    if rank_world()[1] > 1:
        dist.barrier()


def all_gather_object(obj: Any) -> List[Any]:
    """A picklable object from every rank, in rank order, on every rank
    (torch.distributed.all_gather_object); [obj] without a group."""
    world = rank_world()[1]
    if world == 1:
        return [obj]
    out: List[Any] = [None] * world
    dist.all_gather_object(out, obj)
    return out


def merge_sharded_results(per_process: Sequence[List[Any]]) -> List[Any]:
    """Restore dataset order from per-process result lists produced by the
    order[process_index::process_count] index sharding: image k was handled
    by process k % pc at local position k // pc, so a round-robin interleave
    reconstructs 0..n-1 (reference collect_results_cpu merge,
    tools/eval.py:173-180)."""
    queues = [list(r) for r in per_process]
    merged: List[Any] = []
    while any(queues):
        for q in queues:
            if q:
                merged.append(q.pop(0))
    return merged


def broadcast_module(module: torch.nn.Module, src: int = 0) -> torch.nn.Module:
    """Rank `src`'s parameters and buffers into `module` on every rank, in
    place (nothing without a group of more than one rank)."""
    if rank_world()[1] > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src)
    return module


# ------------------------------------------------------------ global batch


@contextlib.contextmanager
def global_batch(group):
    """The scope of one data-parallel train step over `group` (a process
    group, torch.distributed.group.WORLD for the whole job): batch_sum,
    batch_total and batch_rows span its ranks.  None, or a group of one
    rank, changes nothing.  The ranks' local batches must have equal
    shapes, as the loader's samples_per_step gives them."""
    if group is None or dist.get_world_size(group) == 1:
        yield
        return
    token = _GROUP.set(group)
    try:
        yield
    finally:
        _GROUP.reset(token)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks of the current global batch, with gradient
    (the backward sums the ranks' gradients of the result); x outside one."""
    group = _GROUP.get()
    if group is None:
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, group=group)


def batch_total(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks of the current global batch, without
    gradient; x outside one."""
    group = _GROUP.get()
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def batch_rows(n: int):
    """(first row, global row count) of this rank's n local rows in the
    current global batch: (0, n) outside one."""
    group = _GROUP.get()
    if group is None:
        return 0, n
    return dist.get_rank(group) * n, dist.get_world_size(group) * n


def batch_world() -> int:
    """The number of ranks in the current global batch (1 outside one)."""
    group = _GROUP.get()
    return 1 if group is None else dist.get_world_size(group)


def average_gradients(params: Sequence[torch.nn.Parameter], group) -> None:
    """Every parameter's .grad replaced by its mean over the ranks of
    `group`, in one all-reduce of the flattened gradients (a missing .grad
    counts as zeros, as JAX's gradients are).  Nothing for None or a group
    of one rank."""
    if group is None or dist.get_world_size(group) == 1:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    pos = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[pos:pos + n].view_as(p.grad))
        pos += n


def average_logs(logs: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The step's 0-d logs as their means over the ranks of `group`, in one
    all-reduce: with equal local batches the global batch's losses (each
    rank's flow loss is its share of the global one, raft_loss).  The logs
    unchanged for None or a group of one rank."""
    if group is None or dist.get_world_size(group) == 1:
        return logs
    keys = list(logs)
    flat = torch.stack([logs[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return {k: flat[i] for i, k in enumerate(keys)}
