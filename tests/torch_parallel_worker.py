"""One rank of tests/test_torch_parallel.py's data-parallel train steps, run
as a process of its own with torchrun's variables set:

    RANK=r WORLD_SIZE=2 ... python tests/torch_parallel_worker.py IN.pt OUT_DIR

IN.pt holds the global batch and the two models' initial weights.  The rank
joins the job over gloo (parallel.maybe_initialize_distributed('pytorch',
'cpu')), runs on its rows of the batch: 2 data-parallel SCFlow steps, 2
RAFT steps, and 1 SCFlow step each with per-rank BatchNorm statistics and
with a per-rank flow-loss count patched in (the steps the test shows would
fail), and writes OUT_DIR/rank{r}.pt."""

import sys

import torch

torch.set_num_threads(1)


def main(inp: str, out_dir: str) -> None:
    import torch.distributed as dist

    import torch_parallel_helpers as tph
    from scflow_tpu_torch.losses import basic
    from scflow_tpu_torch.models import layers
    from scflow_tpu_torch.parallel import maybe_initialize_distributed, rank_world

    dev = maybe_initialize_distributed("pytorch", device="cpu")
    assert dev == torch.device("cpu") and dist.get_backend() == "gloo"
    rank, world = rank_world()
    data = torch.load(inp, weights_only=False)
    local = tph.rows(data["batch"], rank, world)
    group = dist.group.WORLD
    res = {k: tph.run_steps(k, data[k], local, group) for k in ("scflow", "raft")}
    global_sum = layers.batch_sum
    layers.batch_sum = lambda x: x  # each rank's own statistics
    res["scflow_rank_bn"] = tph.run_steps("scflow", data["scflow"], local, group, steps=1)
    layers.batch_sum = global_sum
    basic.batch_total = lambda x: x * basic.batch_world()  # each rank's own count
    res["scflow_rank_count"] = tph.run_steps("scflow", data["scflow"], local, group, steps=1)
    torch.save(res, f"{out_dir}/rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
