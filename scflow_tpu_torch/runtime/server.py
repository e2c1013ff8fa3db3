"""Online serving runtime: request queue -> micro-batcher -> serve fn on the
card -> HTTP front end.  The port's copy of scflow_tpu/runtime/server.py.

Clients POST one camera frame plus initial poses; the server coalesces
concurrent requests into one padded batch (default max_objects=64) and
answers with refined poses in the original camera frame
(scflow_tpu_torch/serving.py does the crop, render and refinement).

- One batch shape by default (fixed_bucket=True pads every batch to
  max_objects); fixed_bucket=False pads to shared powers of two.
- The frame bank is always padded to max_frames: the crop gathers frames
  per object, so unused frames cost memory only.
- PoseService.dispatch returns once the batch is queued on the card: its
  copies of the real rows of the fetched outputs go to pinned host memory
  behind the computation, followed by an event, and `fetch` waits on that
  event alone.  A batcher with a fetch stage so prepares and queues batch
  N+1 while the card computes batch N.
- Everything else is the standard library (http.server, threading,
  queue); payloads are npz (numpy.savez), so any numpy client can talk to
  it.
"""

import io
import json
from contextlib import nullcontext
import queue
import threading
import time
import zipfile
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from scflow_tpu_torch.parallel.mesh import Mesh, batch_sharding, replicated_sharding
from scflow_tpu_torch.runtime.eval_loop import _bucket

_STOP = object()


# ---------------------------------------------------------------- requests


@dataclass
class RefineRequest:
    """One client request: a frame and the objects to refine in it."""

    frame: np.ndarray  # (Hf, Wf, 3) uint8 or float32 in [0, 1]
    rotations: np.ndarray  # (P, 3, 3) float32 initial rotations
    translations: np.ndarray  # (P, 3) float32 initial translations (mm)
    k: np.ndarray  # (3, 3) or (P, 3, 3) float32 intrinsics
    labels: np.ndarray  # (P,) int32 class ids
    future: object = None  # concurrent.futures.Future, set by the batcher
    t_enqueue: float = 0.0

    @property
    def num_objects(self) -> int:
        return int(self.rotations.shape[0])


def validate_request(req: RefineRequest, frame_hw, num_class: int,
                     max_objects: Optional[int] = None):
    """Raise ValueError for a request the server cannot run."""
    h, w = frame_hw
    if req.frame.ndim != 3 or req.frame.shape[2] != 3:
        raise ValueError(f"frame must be (H, W, 3), got {req.frame.shape}")
    if req.frame.shape[:2] != (h, w):
        raise ValueError(f"frame must be {h}x{w} (server frame_hw), got "
                         f"{req.frame.shape[0]}x{req.frame.shape[1]}")
    if req.frame.dtype != np.uint8 and req.frame.size:
        m = float(req.frame.max())
        if not np.isfinite(m):
            raise ValueError("frame contains non-finite values")
        if m > 1.5:
            raise ValueError(f"float frames must be in [0, 1] (got max {m:.1f}); "
                             "send uint8 for 0-255 data")
    for name in ("rotations", "translations", "k"):
        if not np.isfinite(getattr(req, name)).all():
            raise ValueError(f"{name} contain non-finite values")
    p = req.num_objects
    if p == 0:
        raise ValueError("request has no objects")
    if max_objects is not None and p > max_objects:
        raise ValueError(f"request has {p} objects, server batch budget is {max_objects} "
                         "(split the request)")
    if req.rotations.shape != (p, 3, 3):
        raise ValueError(f"rotations must be (P, 3, 3), got {req.rotations.shape}")
    if req.translations.shape != (p, 3):
        raise ValueError(f"translations must be (P, 3), got {req.translations.shape}")
    if req.k.shape not in ((3, 3), (p, 3, 3)):
        raise ValueError(f"k must be (3, 3) or (P, 3, 3), got {req.k.shape}")
    if req.labels.shape != (p,):
        raise ValueError(f"labels must be (P,), got {req.labels.shape}")
    lmin, lmax = int(req.labels.min()), int(req.labels.max())
    if lmin < 0 or lmax >= num_class:
        raise ValueError(f"labels out of range [0, {num_class}): min {lmin} max {lmax}")


# ------------------------------------------------------------------- stats


def nearest_rank(sorted_vals, p: float):
    """Nearest-rank percentile over an ascending sequence (None if empty).
    Shared by the server stats and the load-test client so both sides of a
    report use the same convention."""
    if not sorted_vals:
        return None
    return sorted_vals[min(len(sorted_vals) - 1, int(p * len(sorted_vals)))]


class ServingStats:
    """Thread-safe counters + latency quantiles over a sliding window."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._lat = deque(maxlen=window)
        self.requests = 0
        self.objects = 0
        self.batches = 0
        self.errors = 0
        self.started = time.time()

    def record_batch(self, n_requests: int, n_objects: int):
        with self._lock:
            self.batches += 1
            self.requests += n_requests
            self.objects += n_objects

    def record_latency(self, seconds: float):
        with self._lock:
            self._lat.append(seconds)

    def record_error(self):
        with self._lock:
            self.errors += 1

    def snapshot(self) -> Dict:
        with self._lock:
            lat = sorted(self._lat)
            requests, objects, batches = self.requests, self.objects, self.batches
            errors = self.errors
            uptime = time.time() - self.started

        def q(p):
            v = nearest_rank(lat, p)
            return None if v is None else round(v * 1e3, 3)

        return {
            "uptime_s": round(uptime, 1),
            "requests": requests,
            "objects": objects,
            "batches": batches,
            "errors": errors,
            "mean_objects_per_batch": round(objects / batches, 2) if batches else None,
            "mean_requests_per_batch": round(requests / batches, 2) if batches else None,
            "latency_ms": {"p50": q(0.50), "p95": q(0.95), "p99": q(0.99)},
        }


# ----------------------------------------------------------------- service


def _default_k(h: int, w: int) -> np.ndarray:
    return np.array([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1]], np.float32)


class PoseService:
    """Pads coalesced requests into one fixed-shape batch and runs the serve
    fn (scflow_tpu_torch.serving.make_serving_fn) on `device` (None: CUDA).

    JAX's PoseService(serve_fn, variables, ...) takes the model's variables;
    here the serve fn holds its model, so there is no `variables` argument,
    and `device` is added.

    With `mesh` (parallel.Mesh) serving is data-parallel over the mesh's
    devices, as JAX's: serve_fn is then a sequence of serve fns, one per
    mesh device and bound to it (apis.make_serving_from_cfg on each of
    parallel.replicate's replicas); the bucket is rounded up to a multiple
    of the device count, the padded object rows are split evenly over the
    devices in mesh order (parallel.batch_sharding) and the frames copied
    to each (replicated_sharding); every shard is launched before any is
    fetched, and the real rows come back in order.
    """

    def __init__(self, serve_fn: Callable, frame_hw=(480, 640), num_class: int = 21,
                 max_frames: int = 8, max_objects: int = 64, fixed_bucket: bool = True,
                 mesh=None, fetch_keys: Sequence[str] = ("rotations", "translations"),
                 post_fn: Optional[Callable] = None, device=None):
        """`fetch_keys` limits the device->host copy to what the response
        (or `post_fn`) reads.  `post_fn(out)` runs on the fetched numpy dict
        and returns a dict with 'rotations' and 'translations': the host PnP
        stage of RAFT-family serving."""
        if mesh is None:
            mesh, serve_fn = Mesh([device]), [serve_fn]
        elif not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.Mesh, got {type(mesh).__name__}")
        elif callable(serve_fn) or len(serve_fn) != mesh.size:
            raise ValueError(f"a mesh of {mesh.size} devices needs one serve fn per "
                             "device, a sequence of that length")
        self.mesh = mesh
        self.serve_fns = list(serve_fn)
        self.fetch_keys = tuple(fetch_keys)
        self.post_fn = post_fn
        self.frame_hw = tuple(frame_hw)
        self.num_class = num_class
        self.max_frames = max_frames
        self.max_objects = max_objects
        self.fixed_bucket = fixed_bucket
        self._cuda = any(d.type == "cuda" for d in mesh.devices)

    def _host(self, shape, dtype) -> torch.Tensor:
        """A host buffer: pinned when the batch goes to a card."""
        return torch.empty(shape, dtype=dtype, pin_memory=self._cuda)

    def dispatch(self, requests: Sequence[RefineRequest]):
        """Pad and queue one batch on the device(s); returns a handle for
        `fetch`.  On a card it returns once the work is queued: the inputs
        go up from pinned memory without waiting, and only the real rows of
        the fetch keys come back, into pinned buffers, behind an event per
        shard."""
        h, w = self.frame_hw
        frames = self._host((self.max_frames, h, w, 3), torch.float32)
        frames_np = frames.numpy()
        rot, trans, ks, labels, fidx, counts = [], [], [], [], [], []
        for i, req in enumerate(requests):
            if req.frame.dtype == np.uint8:
                frames_np[i] = req.frame.astype(np.float32) / 255.0
            else:
                frames_np[i] = np.asarray(req.frame, np.float32)
            p = req.num_objects
            rot.append(np.asarray(req.rotations, np.float32))
            trans.append(np.asarray(req.translations, np.float32))
            k = np.asarray(req.k, np.float32)
            ks.append(np.tile(k[None], (p, 1, 1)) if k.ndim == 2 else k)
            labels.append(np.asarray(req.labels, np.int32))
            fidx.append(np.full((p,), i, np.int32))
            counts.append(p)
        frames_np[len(requests):] = 0.0

        n = int(sum(counts))
        shards = self.mesh.size
        b = _bucket(n, self.max_objects, fixed=self.fixed_bucket)
        b = -(-b // shards) * shards  # the object rows split evenly over the devices
        pad = b - n

        def cat(parts, pad_row):
            out = np.concatenate(parts, axis=0)
            if pad:
                out = np.concatenate([out, np.tile(pad_row, (pad,) + (1,) * (out.ndim - 1))],
                                     axis=0)
            return out

        args = (cat(fidx, np.zeros((1,), np.int32)),
                cat(rot, np.eye(3, dtype=np.float32)[None]),
                cat(trans, np.array([[0.0, 0.0, 1000.0]], np.float32)),
                cat(ks, _default_k(h, w)[None]),
                cat(labels, np.zeros((1,), np.int32)))
        rows = b // shards
        host, events = {}, []
        with torch.inference_mode():
            frames_on = replicated_sharding(self.mesh).place(frames)
            args_on = zip(*(batch_sharding(self.mesh).place(a) for a in args))
            for i, (dev, serve_fn, f, a) in enumerate(zip(self.mesh.devices, self.serve_fns,
                                                          frames_on, args_on)):
                first, last = i * rows, min(n, (i + 1) * rows)
                with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
                    out = serve_fn(f, *a)
                    for k in self.fetch_keys:
                        if k not in out or last <= first:
                            continue
                        x = out[k][:last - first]
                        if x.is_floating_point() and x.dtype != torch.float32:
                            x = x.float()
                        if k not in host:
                            host[k] = self._host((n,) + tuple(x.shape[1:]), x.dtype)
                        host[k][first:last].copy_(x, non_blocking=dev.type == "cuda")
                    if dev.type == "cuda":
                        events.append(torch.cuda.Event())
                        events[-1].record(torch.cuda.current_stream(dev))
        return host, events or None, counts

    def fetch(self, handle) -> List[Dict[str, np.ndarray]]:
        """Wait for a `dispatch` handle's copies and slice the result back
        per request.  Only the keys the response carries, and only the real
        object rows, were copied: padding would otherwise inflate the copy
        and run post_fn's host PnP on phantom objects."""
        host, events, counts = handle
        for event in events or ():
            event.synchronize()
        out = {k: v.numpy() for k, v in host.items()}
        if self.post_fn is not None:
            out = self.post_fn(out)
        results, start = [], 0
        for p in counts:
            results.append({"rotations": out["rotations"][start:start + p],
                            "translations": out["translations"][start:start + p]})
            start += p
        return results

    def run(self, requests: Sequence[RefineRequest]) -> List[Dict[str, np.ndarray]]:
        return self.fetch(self.dispatch(requests))

    def warmup(self, buckets: Optional[Sequence[int]] = None):
        """Run the serve fn once at every bucket it can see (one under
        fixed_bucket, the default): cuDNN's plans and the allocator's pools
        are set up before the first request."""
        if buckets is None:
            if self.fixed_bucket:
                buckets = [self.max_objects]
            else:
                buckets, b = [], 1
                while b <= self.max_objects:
                    buckets.append(b)
                    b *= 2
        h, w = self.frame_hw
        for b in buckets:
            self.run([RefineRequest(
                frame=np.zeros((h, w, 3), np.uint8),
                rotations=np.tile(np.eye(3, dtype=np.float32)[None], (b, 1, 1)),
                translations=np.tile(np.array([[0.0, 0.0, 1000.0]], np.float32), (b, 1)),
                k=_default_k(h, w), labels=np.zeros((b,), np.int32))])


class DeviceKeepAlive:
    """Background ticker that runs `tick` every `interval_s` seconds while
    the server is idle (make_service_keepalive_tick: the real serve fn on
    one synthetic object).  JAX added it for remote-attached TPU backends,
    where an idle path went cold; it ships off by default.  Tick failures
    are swallowed: a dead device must surface through real requests, not
    kill the server."""

    def __init__(self, tick: Callable[[], object], interval_s: float = 30.0):
        self.interval = interval_s
        self._tick = tick
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="scflow-keepalive",
                                        daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop_evt.wait(self.interval):
            try:
                self._tick()
            except Exception:
                pass

    def stop(self):
        self._stop_evt.set()
        self._thread.join(timeout=5)


def make_service_keepalive_tick(service: PoseService) -> Callable[[], object]:
    """A keep-alive tick that runs the service's serve fn on one synthetic
    object (the same fixed bucket as traffic).  It bypasses the batcher, so
    /v1/stats reflect only real requests."""
    h, w = service.frame_hw
    req = RefineRequest(frame=np.zeros((h, w, 3), np.uint8),
                        rotations=np.eye(3, dtype=np.float32)[None],
                        translations=np.array([[0.0, 0.0, 1000.0]], np.float32),
                        k=_default_k(h, w), labels=np.zeros((1,), np.int32))
    return lambda: service.run([req])


# ----------------------------------------------------------------- batcher


class MicroBatcher:
    """Coalesces concurrent requests into device batches.

    The first request in an empty queue opens a window of `max_delay_ms`;
    requests arriving inside it join the batch until `max_frames` requests
    or `max_objects` total objects are reached.  A request that would
    overflow the object budget is held for the next batch (never dropped,
    never split).
    """

    def __init__(self, run_batch: Callable[[Sequence[RefineRequest]], List[Dict]],
                 max_frames: int = 8, max_objects: int = 64, max_delay_ms: float = 5.0,
                 stats: Optional[ServingStats] = None, fetch_batch: Optional[Callable] = None):
        """With only `run_batch`, batches run one at a time.  With
        `fetch_batch`, `run_batch` is a dispatch (PoseService.dispatch) whose
        handle `fetch_batch` (PoseService.fetch) resolves on a second
        thread: the card computes batch N while this thread pads and queues
        batch N+1."""
        self._run_batch = run_batch
        self._fetch_batch = fetch_batch
        self.max_frames = max_frames
        self.max_objects = max_objects
        self.max_delay = max_delay_ms / 1e3
        self.stats = stats or ServingStats()
        self._q = queue.Queue()
        self._held = None
        self._threads = []
        if fetch_batch is not None:
            # maxsize 2: one batch on the device and one handle waiting is
            # enough pipelining; more would only grow the queue's latency
            self._inflight = queue.Queue(maxsize=2)
            self._threads.append(threading.Thread(target=self._fetch_loop,
                                                  name="scflow-fetcher", daemon=True))
        self._threads.append(threading.Thread(target=self._loop, name="scflow-batcher",
                                              daemon=True))
        for t in self._threads:
            t.start()

    def submit(self, req: RefineRequest):
        """Queue a request; returns its concurrent.futures.Future."""
        from concurrent.futures import Future

        req.future = Future()
        req.t_enqueue = time.perf_counter()
        self._q.put(req)
        return req.future

    def stop(self):
        """Finish the queued batches, stop the threads, and fail whatever is
        left (submitted after stop, or behind the sentinel) so its waiters
        error at once."""
        self._q.put(_STOP)
        for t in self._threads:
            t.join(timeout=30)
        leftovers = []
        if self._held is not None and self._held is not _STOP:
            leftovers.append(self._held)
            self._held = None
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except queue.Empty:
                break
        for req in leftovers:
            if req is not _STOP and getattr(req, "future", None) is not None:
                req.future.set_exception(RuntimeError("server shutting down"))

    def _collect(self) -> Optional[List[RefineRequest]]:
        first = self._held or self._q.get()
        self._held = None
        if first is _STOP:
            return None
        batch = [first]
        objs = first.num_objects
        deadline = first.t_enqueue + self.max_delay
        while len(batch) < self.max_frames:
            timeout = deadline - time.perf_counter()
            try:
                # past the window, still take what is already queued: under
                # load the batcher comes back after a dispatch, past the
                # first request's deadline, and closing the batch then would
                # run one request per batch
                nxt = self._q.get_nowait() if timeout <= 0 else self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is _STOP:
                self._held = _STOP
                break
            if objs + nxt.num_objects > self.max_objects:
                self._held = nxt
                break
            batch.append(nxt)
            objs += nxt.num_objects
        return batch

    def _resolve(self, batch, results):
        now = time.perf_counter()
        self.stats.record_batch(len(batch), sum(r.num_objects for r in batch))
        for req, res in zip(batch, results):
            self.stats.record_latency(now - req.t_enqueue)
            req.future.set_result(res)

    def _fail(self, batch, e):
        self.stats.record_error()
        for req in batch:
            req.future.set_exception(e)

    def _loop(self):
        while True:
            batch = self._collect()
            if batch is None:
                if self._fetch_batch is not None:
                    self._inflight.put(_STOP)
                return
            try:
                out = self._run_batch(batch)
            except Exception as e:  # the error reaches every waiter
                self._fail(batch, e)
                continue
            if self._fetch_batch is None:
                self._resolve(batch, out)
            else:
                self._inflight.put((batch, out))

    def _fetch_loop(self):
        while True:
            item = self._inflight.get()
            if item is _STOP:
                return
            batch, handle = item
            try:
                results = self._fetch_batch(handle)
            except Exception as e:
                self._fail(batch, e)
                continue
            self._resolve(batch, results)


# ----------------------------------------------------------- HTTP frontend


def _npz_bytes(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _parse_npz(body: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def make_http_server(service: PoseService, batcher: MicroBatcher, host: str = "127.0.0.1",
                     port: int = 8080, request_timeout: float = 60.0):
    """HTTP front end.  POST /v1/refine (npz: frame, ref_rotations,
    ref_translations, k, labels) -> npz {rotations, translations};
    GET /healthz -> ok; GET /v1/stats -> JSON counters.  Port 0 binds a
    free port: server_address[1] names it."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet; the stats carry the signal
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif self.path == "/v1/stats":
                self._send(200, json.dumps(batcher.stats.snapshot()).encode(),
                           "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def _drain_body(self):
            """Read the request body, so HTTP/1.1 keep-alive stays in sync
            (an unread payload would be parsed as the next request line)."""
            length = int(self.headers.get("Content-Length", 0) or 0)
            while length > 0:
                chunk = self.rfile.read(min(length, 1 << 20))
                if not chunk:
                    break
                length -= len(chunk)

        def do_POST(self):
            if self.path != "/v1/refine":
                self._drain_body()
                self._send(404, b"not found", "text/plain")
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                data = _parse_npz(self.rfile.read(length))
                req = RefineRequest(frame=data["frame"], rotations=data["ref_rotations"],
                                    translations=data["ref_translations"], k=data["k"],
                                    labels=data["labels"])
                validate_request(req, service.frame_hw, service.num_class,
                                 max_objects=batcher.max_objects)
            except (KeyError, ValueError, OSError, EOFError, zipfile.BadZipFile) as e:
                # np.load raises EOFError on an empty body and BadZipFile on
                # a corrupt zip: client errors, not crashes
                batcher.stats.record_error()
                self._send(400, str(e).encode(), "text/plain")
                return
            try:
                result = batcher.submit(req).result(timeout=request_timeout)
            except Exception as e:
                self._send(500, str(e).encode(), "text/plain")
                return
            self._send(200, _npz_bytes(result), "application/octet-stream")

    return ThreadingHTTPServer((host, port), Handler)


def refine_remote(url: str, frame, rotations, translations, k, labels,
                  timeout: float = 60.0) -> Dict[str, np.ndarray]:
    """Minimal numpy client for the HTTP server (stdlib urllib)."""
    from urllib.request import Request, urlopen

    body = _npz_bytes({"frame": np.asarray(frame),
                       "ref_rotations": np.asarray(rotations, np.float32),
                       "ref_translations": np.asarray(translations, np.float32),
                       "k": np.asarray(k, np.float32),
                       "labels": np.asarray(labels, np.int32)})
    req = Request(url.rstrip("/") + "/v1/refine", data=body,
                  headers={"Content-Type": "application/octet-stream"})
    with urlopen(req, timeout=timeout) as resp:
        return _parse_npz(resp.read())
