"""The data-parallel layer of the port (scflow_tpu_torch/parallel/ over
torch.distributed) on the CPU over gloo, against one process and the JAX
package.  The semantics are JAX's: N ranks together compute what one
device computes on the global batch.

- The train steps: 2 ranks, each on its half of tests/
  torch_parallel_helpers.py's global batch (4 samples at 64^2, halves with
  other valid-pixel counts and feature statistics), equal the one-process
  step on the whole batch, SCFlow and RAFT with the render augmentations
  on: every step's logs (loss and grad_norm included) and every weight and
  BatchNorm buffer after 2 steps at rtol 1e-5, atol 1e-6.  The updates are
  SGD's, linear in the gradient: Adam's first step g/|g| turns the float32
  noise of mathematically zero gradients (conv biases before a norm) into
  +-lr, so weights after Adam steps are no yardstick
  (tests/test_torch_train.py).  A step with each rank's own BatchNorm
  statistics, or its own flow-loss pixel count, misses the bound.  The
  one-process step on the global batch is held to JAX's step on it at
  tests/test_torch_train.py's bounds (log_vars rtol 2e-4, gradient leaves
  rel L2 2e-2, AdamW, without augmentations: the packages draw them from
  other generators, tests/test_torch_augment.py).
- The loader's shards: each rank's batches, indices and worker seeds, are
  JAX's DataLoader's for that process index.
- The launchers' environments, and the mesh helpers.

The rank processes (tests/torch_parallel_worker.py) import torch and the
port only; every process group lives in a child process."""

import random
import threading

import numpy as np
import pytest
import torch

import torch_parallel_helpers as tph
from scflow_tpu_torch.parallel import (LAUNCHERS, Mesh, batch_sharding, launch_env, make_mesh,
                                       merge_sharded_results, rank_world, replicate,
                                       replicated_sharding)

from torch_port_helpers import keep_torch_rng, no_tf32  # noqa: F401
from torch_train_helpers import Draws, keep_global_rngs  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The rank processes' results and the one-process steps on the global
    batch."""
    tmp = tmp_path_factory.mktemp("parallel")
    weights = {k: tph.build_model(k).state_dict() for k in ("scflow", "raft")}
    batch = tph.make_batch()
    torch.save(dict(batch=batch, **weights), tmp / "in.pt")
    procs = tph.start_ranks(["tests/torch_parallel_worker.py", str(tmp / "in.pt"), str(tmp)], 2)
    try:
        with torch.random.fork_rng(devices=[]):
            one = {k: tph.run_steps(k, weights[k], batch) for k in ("scflow", "raft")}
    finally:
        tph.wait_ranks(procs)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return dict(ranks=ranks, one=one, batch=batch)


def _close(got: float, want: float) -> bool:
    return abs(got - want) <= ATOL + RTOL * abs(want)


@pytest.mark.parametrize("kind", ["scflow", "raft"])
def test_two_ranks_equal_one_process_on_the_global_batch(runs, kind):
    one, ranks = runs["one"][kind], [r[kind] for r in runs["ranks"]]
    assert len(one["logs"]) == 2
    for step, want in enumerate(one["logs"]):
        for r in ranks:  # the logs are the global batch's on every rank
            assert set(r["logs"][step]) == set(want)
            bad = {k: (r["logs"][step][k], v) for k, v in want.items()
                   if not _close(r["logs"][step][k], v)}
            assert not bad, (step, bad)
    assert one["logs"][0]["grad_norm"] > tph.CLIP[kind]  # the clip acted
    for name, want in one["state"].items():
        for r in ranks:
            got = r["state"][name]
            if want.is_floating_point():
                torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL, msg=name)
            else:
                assert torch.equal(got, want), name
        assert torch.equal(ranks[0]["state"][name], ranks[1]["state"][name]), name
    moved = max(float((one["state"][k] - v).abs().max())
                for k, v in tph.build_model(kind, None).state_dict().items()
                if k.endswith("running_var"))
    assert moved > 1e-3  # the BatchNorm buffers took the steps' statistics


def test_the_halves_differ_where_per_rank_reductions_would_show(runs):
    """The batch's halves differ in valid flow pixels and image statistics,
    and a step with either reduction taken per rank misses the bound."""
    b = runs["batch"]
    px = b["gt_masks"].reshape(tph.N, -1).sum(1)
    assert px[2:].sum() > 1.5 * px[:2].sum()
    want = runs["one"]["scflow"]["logs"][0]
    for variant in ("scflow_rank_bn", "scflow_rank_count"):
        got = runs["ranks"][0][variant]["logs"][0]
        for k in ("loss", "grad_norm"):
            assert abs(got[k] - want[k]) > 5 * (ATOL + RTOL * abs(want[k])), (variant, k)


def test_one_process_step_on_the_global_batch_matches_jax(runs, no_tf32):
    """tests/test_torch_train.py's protocol on the global batch: JAX's
    make_scflow_train_step and the port's, one AdamW step each from the same
    weights (lookup 'xla', no augmentations), the weights of
    torch_port_helpers.scflow_pair_torch_init (the pose head's output
    drawn small, so that the poses move).  The yardstick is JAX's step with
    the network in float64, as in tests/test_torch_raft_train.py: on this
    batch JAX's float32 gradients of the BatchNorm context encoder sit up to
    4% from its float64 ones (grad_norm 3.5e-3), the port's float32 ones
    within 0.5% (grad_norm 1e-5)."""
    import jax

    import test_torch_train as tt
    from torch_port_helpers import scflow_pair_torch_init
    from scflow_tpu.refiners import system as jsystem
    from scflow_tpu.render.meshbank import make_synthetic_bank as j_bank
    from scflow_tpu_torch.refiners.system import make_scflow_train_step
    from scflow_tpu_torch.runtime.optim import build_optimizer
    from scflow_tpu_torch.runtime.train_state import TrainState

    fmodel, variables, port = scflow_pair_torch_init(tph.NCLASS, tph.H, tph.ITERS,
                                                     **tph.SCFLOW_KW)
    jb = j_bank(tph.NCLASS)
    s = dict(fmodel=fmodel, batch=dict(runs["batch"], real_images=np.asarray(
                 runs["batch"]["real_images"], np.float64)),
             variables=jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables),
             j_render=jsystem.RenderAssets.from_bank(jb),
             j_loss=jsystem.loss_assets_from_bank(jb, tph.SYM))
    assert tt.H == tph.H and tt.NCLASS == tph.NCLASS and tt.ITERS == tph.ITERS
    with jax.enable_x64(True):
        _, j_logs, j_grads = tt._jax_step(s, "xla")
    model = tph.build_model("scflow", port.state_dict())
    tx, _ = build_optimizer(model.parameters(), tt.OPT, None, grad_clip=10.0)
    render, loss = tph.assets()
    step = make_scflow_train_step(model, render, loss, image_size=(tph.H, tph.H),
                                  render_chunk=16, device="cpu")
    state, logs = step(TrainState(model, tx), runs["batch"])
    assert set(logs) == set(j_logs)
    for k, v in j_logs.items():
        np.testing.assert_allclose(float(logs[k]), v, rtol=2e-4, err_msg=k)
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    assert tt._worst_grad_rel(grads, j_grads) <= 2e-2


# ------------------------------------------------------------------ loader


def _batches(loader, n=2):
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def test_loader_shards_are_jax_shards():
    """Each process index's batches, indices and draws, equal JAX's
    DataLoader's (one thread worker, which draws from the global RNGs); the
    2 shards of a step hold the step's 6 indices of the epoch's
    permutation.  In process mode the port's shard yields the same indices
    and its worker w of process p draws from seed + w + p x workers, JAX's
    seeds (datasets/loader.py there), which the spawned workers show."""
    from scflow_tpu.datasets.loader import DataLoader as JDataLoader
    from scflow_tpu_torch.datasets.loader import DataLoader

    data = Draws(12)
    shards = []
    for pi in range(2):
        kw = dict(samples_per_step=3, num_workers=1, seed=5, process_index=pi,
                  process_count=2, collate_fn=list)
        random.seed(1)
        np.random.seed(1)
        got = _batches(DataLoader(data, **kw))
        random.seed(1)
        np.random.seed(1)
        before = set(threading.enumerate())
        want = _batches(JDataLoader(data, **kw))
        for t in set(threading.enumerate()) - before:  # JAX's close leaves its worker
            t.join(timeout=10)  # finishing a sample, which draws from the global RNGs
        assert got == want, pi
        shards.append(got)
    order = np.random.default_rng(5).permutation(len(data))
    for k in range(2):
        idx = [s[0] for shard in shards for s in shard[k]]
        assert sorted(idx) == sorted(order[6 * k:6 * (k + 1)].tolist())
    workers = 2
    proc = _batches(DataLoader(data, samples_per_step=3, num_workers=workers, seed=5,
                               process_index=1, process_count=2, collate_fn=list,
                               worker_mode="process"))
    assert [[s[0] for s in b] for b in proc] == [[s[0] for s in b] for b in shards[1]]
    for w in range(workers):  # sample j went to worker j % workers
        rng = np.random.RandomState(5 + w + 1 * workers)
        draws = [s[1] for b in proc for s in b][w::workers]
        assert draws == [rng.random_sample() for _ in draws], w


# --------------------------------------------------------------- launchers


@pytest.mark.parametrize("launcher,env,want", [
    ("pytorch", dict(RANK="3", WORLD_SIZE="8", LOCAL_RANK="1", LOCAL_WORLD_SIZE="2",
                     MASTER_ADDR="10.0.0.2", MASTER_PORT="29501"),
     (3, 8, 1, 2, "10.0.0.2", 29501)),
    ("jax", dict(SCFLOW_COORDINATOR="host-a:1234", SCFLOW_NUM_PROCESSES="4",
                 SCFLOW_PROCESS_ID="2", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1"),
     (2, 4, 0, 1, "host-a", 1234)),
    ("slurm", dict(SLURM_PROCID="5", SLURM_NTASKS="8", SLURM_LOCALID="1",
                   SLURM_NTASKS_PER_NODE="4(x2)", MASTER_ADDR="node7"),
     (5, 8, 1, 4, "node7", 29500)),
    ("mpi", dict(OMPI_COMM_WORLD_RANK="1", OMPI_COMM_WORLD_SIZE="2",
                 OMPI_COMM_WORLD_LOCAL_RANK="1", OMPI_COMM_WORLD_LOCAL_SIZE="2",
                 MASTER_PORT="4000"),
     (1, 2, 1, 2, "127.0.0.1", 4000)),
])
def test_launch_env_reads_each_launcher(launcher, env, want):
    got = launch_env(launcher, env)
    assert (got["rank"], got["world_size"], got["local_rank"], got["local_world_size"],
            got["master_addr"], got["master_port"]) == want


def test_launch_env_refuses_what_it_cannot_read():
    from scflow_tpu_torch import cli
    from scflow_tpu_torch.parallel import maybe_initialize_distributed

    assert cli.LAUNCHERS == LAUNCHERS == ("none", "jax", "pytorch", "slurm", "mpi")
    with pytest.raises(RuntimeError, match="sets none of"):
        launch_env("pytorch", {})
    with pytest.raises(ValueError, match="not a place in the job"):
        launch_env("pytorch", dict(RANK="2", WORLD_SIZE="2", MASTER_PORT="1"))
    with pytest.raises(ValueError, match="HOST:PORT"):
        launch_env("jax", dict(SCFLOW_COORDINATOR="nohost", SCFLOW_NUM_PROCESSES="1",
                               SCFLOW_PROCESS_ID="0"))
    with pytest.raises(ValueError, match="unknown launcher"):
        maybe_initialize_distributed("horovod", device="cpu")
    # 'none' without SCFLOW_DIST starts nothing
    assert maybe_initialize_distributed("none", device="cpu") == torch.device("cpu")
    assert rank_world() == (0, 1)


# -------------------------------------------------------------------- mesh


def test_mesh_helpers_in_one_process():
    """A process's mesh: batches split evenly in mesh order, replicas share
    a device's copy."""
    mesh = Mesh(["cpu", "cpu"])
    assert mesh.size == 2 and mesh.devices == [torch.device("cpu")] * 2
    assert make_mesh(devices=["cpu", "cpu", "cpu"], n_devices=2).size == 2
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    assert [b.tolist() for b in batch_sharding(mesh).place(x)] == [x[:2].tolist(),
                                                                    x[2:].tolist()]
    assert all(torch.equal(b, torch.from_numpy(x)) for b in replicated_sharding(mesh).place(x))
    with pytest.raises(ValueError, match="split evenly"):
        batch_sharding(mesh).place(x[:3])
    lin = torch.nn.Linear(2, 2)
    assert replicate(lin, mesh) == [lin, lin]
    assert merge_sharded_results([[0, 2, 4], [1, 3]]) == [0, 1, 2, 3, 4]
