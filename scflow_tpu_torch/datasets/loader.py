"""Host-side data loading: batch collation, and the DataLoader that runs the
(numpy) pipeline in worker threads or spawned worker processes over a
per-epoch shuffled index stream sharded by process.  The port's copy of
scflow_tpu/datasets/loader.py (the reference's torch DataLoader +
DistributedSampler, train.py:48-84).  Nothing here touches a card: batches
are numpy arrays, and IterRunner.put_batch moves them."""

import multiprocessing as mp
import queue
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List

import numpy as np


class _WorkerError:
    """Carries a worker's exception to the consuming generator."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _stoppable_put(q, item, stop) -> bool:
    """put() that re-checks `stop` every 0.1 s: a thread parked in a plain
    blocking put would never see the iterator closed."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _process_worker(dataset, idx_q, res_q, seed=None):
    """A worker process's loop (module level, so spawn can pickle it).
    `seed` (seed + worker id + process_index x num_workers, mmcv's
    worker_init_fn) seeds numpy's global RNG and Python's `random`, which
    the pipeline's augmentations draw from.  idx_q is this worker's own
    round-robin queue, so it draws in a fixed sample order whatever the
    scheduling."""
    if seed is not None:
        np.random.seed(seed % (2**32))
        random.seed(seed)
    while True:
        task = idx_q.get()
        if task is None:
            res_q.put(("done",))
            return
        seq, idx = task
        try:
            item = dataset[idx]
        except Exception as exc:  # a summary crosses the queue; tracebacks do not pickle
            res_q.put(("err", f"{type(exc).__name__}: {exc}"))
            return
        res_q.put(("ok", seq, item))


def collate_batch(samples: List[Dict], train: bool = True) -> Dict[str, np.ndarray]:
    """Flatten per-image object patches into one dense batch (the reference
    does this inside format_data_*, base_refiner.py:85-91,146-151).

    Returns arrays keyed for the train/infer steps plus 'img_metas' (list,
    host-only) and 'per_img_patch_num' for regrouping at eval."""
    out: Dict[str, Any] = {}
    per_img = [len(s["annots"]["labels"]) for s in samples]
    out["per_img_patch_num"] = per_img
    out["img_metas"] = [s["img_metas"] for s in samples]

    imgs = np.concatenate([np.asarray(s["img"], np.float32) for s in samples], axis=0)
    out["real_images"] = imgs

    def cat(key, dtype=np.float32):
        return np.concatenate(
            [np.asarray(s["annots"][key], dtype) for s in samples], axis=0
        )

    a0 = samples[0]["annots"]
    out["ref_rotations"] = cat("ref_rotations")
    out["ref_translations"] = cat("ref_translations")
    out["labels"] = cat("labels", np.int32)
    out["k"] = cat("k")
    if "gt_rotations" in a0:
        out["gt_rotations"] = cat("gt_rotations")
        out["gt_translations"] = cat("gt_translations")
    if "gt_masks" in a0:
        masks = []
        for s in samples:
            masks.append(s["annots"]["gt_masks"].to_array(np.float32))
        out["gt_masks"] = np.concatenate(masks, axis=0)
    for key in ("init_add_error", "init_rot_error", "init_trans_error"):
        if key in a0:
            out[key] = cat(key)
    return out


class DataLoader:
    """Iterates dataset indices sharded per process (process_index of
    process_count), runs the pipeline in `num_workers` worker threads
    (worker_mode 'thread') or spawned processes ('process'), collates
    `samples_per_step` samples per batch and keeps up to `prefetch` batches
    ready.  Each epoch's order is default_rng(seed + epoch).permutation
    (shuffle) or the index order.  A worker's exception surfaces as
    RuntimeError("DataLoader worker failed"); closing the iterator stops
    every worker.

    Thread workers share numpy's global RNG (with one worker the draws come
    in sample order).  Process workers are seeded seed + worker id +
    process_index x num_workers, take samples round robin over private
    queues and their results are put back in sequence order, so the batches
    are a pure function of (seed, num_workers)."""

    def __init__(self, dataset, samples_per_step: int, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 0, process_index: int = 0,
                 process_count: int = 1, infinite: bool = True,
                 collate_fn: Callable = collate_batch, prefetch: int = 2,
                 drop_last: bool = True, worker_mode: str = "thread"):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be thread|process, got {worker_mode}")
        self.dataset = dataset
        self.samples_per_step = samples_per_step
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 1)
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.infinite = infinite
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.worker_mode = worker_mode

    def _index_stream(self) -> Iterator[int]:
        epoch = 0
        n = len(self.dataset)
        while True:
            order = np.arange(n)
            if self.shuffle:
                order = np.random.default_rng(self.seed + epoch).permutation(n)
            yield from order[self.process_index::self.process_count].tolist()
            epoch += 1
            if not self.infinite:
                return

    def _results_bound(self) -> int:
        # bounded, so workers cannot run the infinite index stream far ahead
        # of a slower consumer (the JAX package measured 116 GB over 850 steps
        # unbounded)
        return max(self.samples_per_step * (self.prefetch + 1), self.num_workers * 2)

    def __iter__(self):
        if self.worker_mode == "process":
            return self._iter_process()
        return self._iter_thread()

    @staticmethod
    def _drain(out_q):
        while True:
            batch = out_q.get()
            if batch is None:
                return
            if isinstance(batch, _WorkerError):
                raise RuntimeError("DataLoader worker failed") from batch.exc
            yield batch

    def _iter_process(self):
        """Spawned worker processes (spawn, not fork: the parent may hold a
        CUDA context and threads).  Samples come back pickled over one
        result queue; collation stays in this process."""
        ctx = mp.get_context("spawn")
        idx_stream = self._index_stream()
        idx_qs = [ctx.Queue(maxsize=4) for _ in range(self.num_workers)]
        res_q = ctx.Queue(maxsize=self._results_bound())
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(q, item):
            return _stoppable_put(q, item, stop)

        procs = [ctx.Process(target=_process_worker,
                             args=(self.dataset, idx_qs[wid], res_q,
                                   self.seed + wid + self.process_index * self.num_workers),
                             daemon=True)
                 for wid in range(self.num_workers)]
        # a spawn start blocks until its child has read the pickled dataset,
        # which imports what unpickling needs (torch): one after the other,
        # eight workers took 20 s to start on an 8-core host; from threads
        # they import at once
        with ThreadPoolExecutor(self.num_workers) as pool:
            list(pool.map(lambda p: p.start(), procs))

        def producer():
            for seq, idx in enumerate(idx_stream):
                if not put(idx_qs[seq % self.num_workers], (seq, idx)):
                    return
            for q in idx_qs:
                if not put(q, None):
                    return

        def batcher():
            done_workers, expected, buf, reorder = 0, 0, [], {}
            while done_workers < self.num_workers and not stop.is_set():
                try:
                    msg = res_q.get(timeout=0.1)
                except queue.Empty:
                    # a worker killed without a word (OOM, a crash) would
                    # leave the consumer waiting forever
                    dead = [p for p in procs if not p.is_alive() and p.exitcode not in (0, None)]
                    if dead:
                        put(out_q, _WorkerError(RuntimeError(
                            f"worker process died with exitcode {dead[0].exitcode}")))
                        return
                    continue
                if msg[0] == "err":
                    put(out_q, _WorkerError(RuntimeError(msg[1])))
                    return
                if msg[0] == "done":
                    done_workers += 1
                    continue
                _, seq, item = msg
                reorder[seq] = item
                while expected in reorder:  # strictly in sequence order
                    buf.append(reorder.pop(expected))
                    expected += 1
                    if len(buf) == self.samples_per_step:
                        if not put(out_q, self.collate_fn(buf)):
                            return
                        buf = []
            if buf and not self.drop_last and not stop.is_set():
                put(out_q, self.collate_fn(buf))
            put(out_q, None)

        threads = [threading.Thread(target=producer, daemon=True),
                   threading.Thread(target=batcher, daemon=True)]
        for t in threads:
            t.start()
        try:
            yield from self._drain(out_q)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=1.0)
            for q in idx_qs:  # a worker between samples leaves at once
                try:
                    q.put_nowait(None)
                except queue.Full:
                    pass
            deadline = time.monotonic() + 1.0
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 0.0))
            for p in procs:  # one blocked in a put, or still in a sample
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5.0)
            for q in idx_qs + [res_q]:
                q.cancel_join_thread()
                q.close()

    def _iter_thread(self):
        idx_stream = self._index_stream()
        sample_q: "queue.Queue" = queue.Queue(maxsize=self.num_workers * 4)
        results: "queue.Queue" = queue.Queue(maxsize=self._results_bound())
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        cancelled = object()

        def put(q, item):
            return _stoppable_put(q, item, stop)

        def get(q):
            while not stop.is_set():
                try:
                    return q.get(timeout=0.1)
                except queue.Empty:
                    continue
            return cancelled

        def producer():
            for idx in idx_stream:
                if not put(sample_q, idx):
                    return
            for _ in range(self.num_workers):
                if not put(sample_q, None):
                    return

        def worker():
            while not stop.is_set():
                idx = get(sample_q)
                if idx is cancelled:
                    return
                if idx is None:
                    put(results, None)
                    return
                try:
                    item = self.dataset[idx]
                except Exception as exc:  # to the consumer, not a silent thread death
                    put(results, _WorkerError(exc))
                    return
                put(results, item)

        def batcher():
            done_workers, buf = 0, []
            while done_workers < self.num_workers and not stop.is_set():
                item = get(results)
                if item is cancelled:
                    return
                if isinstance(item, _WorkerError):
                    put(out_q, item)
                    return
                if item is None:
                    done_workers += 1
                    continue
                buf.append(item)
                if len(buf) == self.samples_per_step:
                    if not put(out_q, self.collate_fn(buf)):
                        return
                    buf = []
            if buf and not self.drop_last and not stop.is_set():
                put(out_q, self.collate_fn(buf))
            put(out_q, None)

        threads = [threading.Thread(target=producer, daemon=True)]
        threads += [threading.Thread(target=worker, daemon=True)
                    for _ in range(self.num_workers)]
        threads.append(threading.Thread(target=batcher, daemon=True))
        for t in threads:
            t.start()
        try:
            yield from self._drain(out_q)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=1.0)
