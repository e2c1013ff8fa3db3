"""The port's serving runtime (scflow_tpu_torch/runtime/server.py), the
config-built serving pipeline (apis.make_serving_from_cfg) and the serve
command line, on the CPU: the cases of tests/test_server.py (request
validation, MicroBatcher semantics with a fake backend, PoseService slicing
and padding invariance, HTTP end to end), the three branches of
make_serving_from_cfg, and parse_serve_args.  Threads and HTTP calls each
carry their own timeout; servers bind port 0."""

import http.client
import json
import threading
import time
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import numpy as np
import pytest
import torch

from scflow_tpu_torch import apis, cli
from scflow_tpu_torch.config import Config
from scflow_tpu_torch.refiners.build import build_refiner_from_config
from scflow_tpu_torch.refiners.scflow import SCFlowRefiner
from scflow_tpu_torch.refiners.system import RenderAssets
from scflow_tpu_torch.render.meshbank import make_synthetic_bank
from scflow_tpu_torch.runtime.server import (DeviceKeepAlive, MicroBatcher, PoseService,
                                             RefineRequest, ServingStats, make_http_server,
                                             make_service_keepalive_tick, nearest_rank,
                                             refine_remote, validate_request)
from scflow_tpu_torch.serving import make_serving_fn

from torch_port_helpers import keep_torch_rng  # noqa: F401

REPO = __import__("pathlib").Path(__file__).resolve().parents[1]
HW, IMG, NCLASS = (96, 128), 64, 2
# the padding-invariance bounds of tests/test_server.py
ROT, TRANS = dict(rtol=0, atol=2e-5), dict(rtol=0, atol=2e-3)


def make_request(p=2, hw=(32, 40), num_class=2, seed=0):
    rng = np.random.default_rng(seed)
    return RefineRequest(
        frame=rng.integers(0, 255, (*hw, 3)).astype(np.uint8),
        rotations=np.tile(np.eye(3, dtype=np.float32)[None], (p, 1, 1)),
        translations=np.tile(np.array([[0, 0, 500.0]], np.float32), (p, 1)),
        k=np.array([[50.0, 0, hw[1] / 2], [0, 50.0, hw[0] / 2], [0, 0, 1]], np.float32),
        labels=rng.integers(0, num_class, p).astype(np.int32))


# -------------------------------------------------------------- validation


@pytest.mark.parametrize("mutate,msg", [
    (None, None),
    (lambda r: setattr(r, "frame", r.frame.astype(np.float32)), "float frames"),
    (lambda r: setattr(r, "frame", r.frame / 255.0 * np.nan), "non-finite"),
    (lambda r: setattr(r, "frame", r.frame[:16]), "frame must be"),
    (lambda r: setattr(r, "frame", r.frame[..., :2]), r"frame must be \(H, W, 3\)"),
    (lambda r: setattr(r, "rotations", r.rotations[:1]), "translations must be"),
    (lambda r: setattr(r, "translations", r.translations + np.inf), "non-finite"),
    (lambda r: setattr(r, "k", np.zeros((2, 2), np.float32)), "k must"),
    (lambda r: setattr(r, "labels", r.labels + 99), "labels out of range"),
    (lambda r: setattr(r, "labels", r.labels[:1]), "labels must be"),
    (lambda r: setattr(r, "rotations", r.rotations[:0]), "no objects"),
    ("budget", "batch budget"),
])
def test_validate_request(mutate, msg):
    """A well-formed request passes (uint8 and [0, 1] float frames); each
    malformed one raises ValueError naming its fault."""
    req = make_request(p=9 if mutate == "budget" else 2)
    if mutate is None:
        validate_request(req, (32, 40), 2)
        req.frame = req.frame / 255.0
        validate_request(req, (32, 40), 2)
        return
    if callable(mutate):
        mutate(req)
    with pytest.raises(ValueError, match=msg):
        validate_request(req, (32, 40), 2, max_objects=8)


# ----------------------------------------------------------------- batcher


class FakeBackend:
    """Counts batches; echoes per-object translations + 1."""

    def __init__(self, delay=0.0):
        self.batches = []
        self.delay = delay

    def __call__(self, requests):
        self.batches.append([r.num_objects for r in requests])
        if self.delay:
            time.sleep(self.delay)
        return [{"rotations": r.rotations, "translations": r.translations + 1.0}
                for r in requests]


def test_single_request_roundtrip():
    backend = FakeBackend()
    b = MicroBatcher(backend, max_delay_ms=1.0)
    try:
        res = b.submit(make_request(p=3)).result(timeout=10)
        assert res["translations"].shape == (3, 3) and np.all(res["translations"][:, 2] == 501.0)
        assert backend.batches == [[3]]
    finally:
        b.stop()


@pytest.mark.parametrize("case", ["window", "past_deadline", "object_budget"])
def test_requests_coalesce(case):
    """Concurrent requests share batches inside the delay window; requests
    that queued while the backend was busy join one batch although the
    first one's window has long passed (JAX's regression: under load every
    batch closed at one request); a request over the object budget waits
    for the next batch, whole."""
    if case == "window":
        backend, stats = FakeBackend(delay=0.05), ServingStats()
        b = MicroBatcher(backend, max_delay_ms=200.0, stats=stats)
        try:
            for f in [b.submit(make_request(p=2, seed=i)) for i in range(4)]:
                f.result(timeout=30)
            assert len(backend.batches) < 4 and stats.snapshot()["requests"] == 4
        finally:
            b.stop()
    elif case == "past_deadline":
        gate, batches = threading.Event(), []

        def slow_backend(requests):
            batches.append([r.num_objects for r in requests])
            if len(batches) == 1:
                gate.wait(timeout=10)  # hold batch 1 until the queue fills
            return [{"rotations": r.rotations, "translations": r.translations}
                    for r in requests]

        b = MicroBatcher(slow_backend, max_delay_ms=1.0)
        try:
            first = b.submit(make_request(p=1, seed=0))
            time.sleep(0.2)  # batch 1 is in the backend, well past 1 ms
            futs = [b.submit(make_request(p=1, seed=i)) for i in range(1, 6)]
            time.sleep(0.05)
            gate.set()
            for f in [first] + futs:
                f.result(timeout=10)
            assert batches == [[1], [1] * 5], batches
        finally:
            gate.set()
            b.stop()
    else:
        backend = FakeBackend(delay=0.05)
        b = MicroBatcher(backend, max_objects=4, max_delay_ms=500.0)
        try:
            for f in [b.submit(make_request(p=3, seed=i)) for i in range(2)]:
                f.result(timeout=30)
            assert backend.batches == [[3], [3]]  # 3 + 3 > 4
        finally:
            b.stop()


@pytest.mark.parametrize("stage", ["dispatch", "fetch"])
def test_errors_reach_every_waiter(stage):
    """A failing backend (one stage) or fetch (two stages) fails every
    request of its batch and counts an error."""
    def boom(requests):
        raise RuntimeError("device on fire")

    if stage == "dispatch":
        b = MicroBatcher(boom, max_delay_ms=50.0)
    else:
        b = MicroBatcher(lambda requests: requests, fetch_batch=boom, max_delay_ms=50.0)
    try:
        futs = [b.submit(make_request(seed=i)) for i in range(2)]
        for f in futs:
            with pytest.raises(RuntimeError, match="device on fire"):
                f.result(timeout=10)
        assert b.stats.snapshot()["errors"] >= 1
    finally:
        b.stop()


def test_two_stage_pipelines_dispatch_and_fetch():
    """With fetch_batch set, batch N+1's dispatch runs while batch N is
    being fetched."""
    fetch_started, second_dispatched, overlap = threading.Event(), threading.Event(), []

    def dispatch(requests):
        if fetch_started.is_set():
            second_dispatched.set()
        return [{"rotations": r.rotations, "translations": r.translations} for r in requests]

    def fetch(handle):
        fetch_started.set()
        overlap.append(second_dispatched.wait(timeout=10))
        return handle

    b = MicroBatcher(dispatch, fetch_batch=fetch, max_delay_ms=1.0)
    try:
        f1 = b.submit(make_request(seed=0))
        assert fetch_started.wait(timeout=10)
        f2 = b.submit(make_request(seed=1))
        assert f1.result(timeout=30) is not None and f2.result(timeout=30) is not None
        assert overlap and overlap[0], "the second dispatch did not overlap the first fetch"
    finally:
        b.stop()


def test_stop_fails_stranded_requests():
    b = MicroBatcher(FakeBackend(), max_delay_ms=1.0)
    b.stop()
    fut = b.submit(make_request())  # queued after the sentinel
    b.stop()
    with pytest.raises(RuntimeError, match="shutting down"):
        fut.result(timeout=5)


def test_stats_quantiles():
    s = ServingStats()
    for ms in [1, 2, 3, 4, 100]:
        s.record_latency(ms / 1e3)
    s.record_batch(2, 5)
    snap = s.snapshot()
    assert snap["latency_ms"]["p50"] == 3.0 and snap["latency_ms"]["p99"] == 100.0
    assert snap["mean_objects_per_batch"] == 5.0 and snap["mean_requests_per_batch"] == 2.0
    assert nearest_rank([], 0.5) is None and nearest_rank([1, 2, 3, 4], 0.9) == 4


def test_device_keepalive_ticks_and_stops():
    """The ticker calls its tick at the interval, swallows a raising tick,
    and joins on stop."""
    calls = []

    def tick():
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("transient")

    ka = DeviceKeepAlive(tick, interval_s=0.02)
    time.sleep(0.2)
    assert ka._thread.is_alive()
    ka.stop()
    assert not ka._thread.is_alive() and len(calls) >= 3


# ----------------------------------------------------------------- service


@pytest.fixture(scope="module")
def tiny_service():
    """A PoseService over a small SCFlowRefiner (2 classes, 64^2 patches, 2
    iterations, seeded weights) on the CPU, with its keep-alive tick."""
    bank = make_synthetic_bank(NCLASS, kind="sphere", subdivisions=2, size=70.0)
    ra = RenderAssets.from_bank(bank, device="cpu")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = SCFlowRefiner(num_class=NCLASS, image_size=(IMG, IMG), iters=2,
                              detach_depth_for_xy=True)
    serve_fn = make_serving_fn(model, ra, ra.verts, ra.vert_valid, image_size=IMG, device="cpu")
    service = PoseService(serve_fn, frame_hw=HW, num_class=NCLASS, max_frames=4, max_objects=8,
                          device="cpu")
    service.warmup()
    return service


def test_run_slices_per_request_and_keepalive_tick(tiny_service):
    reqs = [make_request(p=2, hw=HW, seed=0), make_request(p=3, hw=HW, seed=1)]
    out = tiny_service.run(reqs)
    assert [o["rotations"].shape for o in out] == [(2, 3, 3), (3, 3, 3)]
    assert [o["translations"].shape for o in out] == [(2, 3), (3, 3)]
    for o in out:
        rtr = np.einsum("pij,pik->pjk", o["rotations"], o["rotations"])
        np.testing.assert_allclose(rtr, np.tile(np.eye(3), (len(rtr), 1, 1)), atol=1e-4)
    assert make_service_keepalive_tick(tiny_service)()[0]["rotations"].shape == (1, 3, 3)


@pytest.mark.parametrize("fixed_bucket", [True, False])
def test_padding_invariance(tiny_service, fixed_bucket):
    """A request refined alone equals the same request sharing a batch with
    others, in the fixed bucket and in power-of-two buckets (rotations
    2e-5, translations 2e-3: tests/test_server.py's bounds)."""
    svc = PoseService(tiny_service.serve_fns[0], frame_hw=HW, num_class=NCLASS, max_frames=4,
                      max_objects=8, fixed_bucket=fixed_bucket, device="cpu")
    req = make_request(p=2, hw=HW, seed=0)
    alone = svc.run([req])[0]
    shared = svc.run([make_request(p=3, hw=HW, seed=1), req])[1]
    np.testing.assert_allclose(alone["rotations"], shared["rotations"], **ROT)
    np.testing.assert_allclose(alone["translations"], shared["translations"], **TRANS)


def test_dispatch_pads_and_fetches_only_the_real_rows(tiny_service):
    """What the serve fn is given (frames padded to max_frames, objects to
    the bucket with identity poses at 1 m and label 0) and what fetch
    copies (the fetch keys' real rows)."""
    seen = {}

    def serve(frames, frame_idx, R, t, K, labels):
        seen.update(frames=frames, frame_idx=frame_idx, t=t, labels=labels)
        return {"rotations": R, "translations": t, "extra": t}

    svc = PoseService(serve, frame_hw=HW, num_class=NCLASS, max_frames=4, max_objects=8,
                      fixed_bucket=False, device="cpu")
    reqs = [make_request(p=2, hw=HW, seed=0), make_request(p=1, hw=HW, seed=1)]
    host, event, counts = svc.dispatch(reqs)
    assert event is None and counts == [2, 1] and set(host) == {"rotations", "translations"}
    assert host["translations"].shape == (3, 3)
    assert seen["frames"].shape == (4,) + HW + (3,) and seen["frames"][2:].abs().max() == 0
    np.testing.assert_array_equal(seen["frames"][1].numpy(), reqs[1].frame / np.float32(255))
    assert seen["frame_idx"].tolist() == [0, 0, 1, 0] and seen["labels"][3] == 0
    assert seen["t"][3].tolist() == [0.0, 0.0, 1000.0]
    out = svc.fetch((host, event, counts))
    np.testing.assert_array_equal(out[1]["translations"], reqs[1].translations)


def test_mesh_raises(tiny_service):
    """mesh= takes a parallel.Mesh and one serve fn per device of it."""
    from scflow_tpu_torch.parallel import Mesh

    with pytest.raises(TypeError, match="parallel.Mesh"):
        PoseService(tiny_service.serve_fns, frame_hw=HW, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="one serve fn per device"):
        PoseService(tiny_service.serve_fns[0], frame_hw=HW, mesh=Mesh(["cpu", "cpu"]))
    with pytest.raises(ValueError, match="one serve fn per device"):
        PoseService(tiny_service.serve_fns, frame_hw=HW, mesh=Mesh(["cpu", "cpu"]))


def test_end_to_end_http(tiny_service):
    """The two-stage batcher behind the HTTP server on port 0: healthz, two
    concurrent clients equal to the direct run, stats, a malformed and an
    empty payload answered 400, an unknown POST path 404 without breaking
    keep-alive."""
    batcher = MicroBatcher(tiny_service.dispatch, fetch_batch=tiny_service.fetch, max_frames=4,
                           max_objects=8, max_delay_ms=20.0)
    httpd = make_http_server(tiny_service, batcher, "127.0.0.1", 0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{port}"
    try:
        assert urlopen(url + "/healthz", timeout=10).read() == b"ok"
        req = make_request(p=2, hw=HW, seed=0)
        direct = tiny_service.run([req])[0]
        results = {}

        def client(i):
            results[i] = refine_remote(url, req.frame, req.rotations, req.translations, req.k,
                                       req.labels, timeout=120)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert set(results) == {0, 1}
        for r in results.values():
            np.testing.assert_allclose(r["rotations"], direct["rotations"], **ROT)
            np.testing.assert_allclose(r["translations"], direct["translations"], **TRANS)
        snap = json.loads(urlopen(url + "/v1/stats", timeout=10).read())
        assert snap["requests"] == 2 and snap["errors"] == 0
        for body in (b"not-an-npz", b""):
            with pytest.raises(HTTPError) as ei:
                urlopen(Request(url + "/v1/refine", data=body), timeout=10)
            assert ei.value.code == 400
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("POST", "/nope", body=b"x" * 4096)
        assert conn.getresponse().read() == b"not found"
        conn.request("GET", "/healthz")
        assert conn.getresponse().read() == b"ok"
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.stop()
        thread.join(timeout=10)


# ------------------------------------------------------- config and command


@pytest.fixture(scope="module")
def cfg_assets():
    bank = make_synthetic_bank(21, kind="cube")
    return RenderAssets.from_bank(bank, device="cpu")


def _cfg(name, **opts):
    cfg = Config.fromfile(str(REPO / "configs" / "refine_models" / name))
    cfg.merge_from_dict({"model.renderer.image_size": (IMG, IMG), **opts})
    return cfg


def _model(cfg):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return build_refiner_from_config(cfg.model)


@pytest.mark.parametrize("branch", ["scflow", "raft_device", "raft_host"])
def test_serving_from_cfg_branches(cfg_assets, branch, recwarn):
    """SCFlow: pose-only serving, poses fetched; RAFT with test_cfg.
    pnp_backend 'device': poses fetched, and sample_points mode 'random'
    warns (the device PnP takes the top-k); RAFT with 'host': the flow,
    occlusion, depth, K' and reference poses fetched, and post_fn solves
    the poses with cv2 on the host.  Each runs a 1-object request through
    PoseService."""
    opts = {}
    if branch == "raft_device":
        opts = {"model.test_cfg.pnp_backend": "device",
                "model.test_cfg.sample_points": dict(num=300, mode="random"),
                "model.test_cfg.iters": 2}
    elif branch == "raft_host":
        opts = {"model.test_cfg.iters": 2}
    cfg = _cfg("scflow.py" if branch == "scflow" else "raft.py",
               **(opts or {"model.test_cfg.iters": 2}))
    model = _model(cfg)
    serve_fn, keys, post_fn = apis.make_serving_from_cfg(cfg, model, cfg_assets, device="cpu")
    warned = [w for w in recwarn.list if "sample_points mode='random'" in str(w.message)]
    assert bool(warned) == (branch == "raft_device")
    if branch == "raft_host":
        assert keys == ("flow", "occlusion", "rendered_depths", "new_k", "ref_rotations",
                        "ref_translations") and post_fn is not None
    else:
        assert keys == ("rotations", "translations") and post_fn is None
    svc = PoseService(serve_fn, frame_hw=HW, num_class=21, max_frames=1, max_objects=1,
                      fetch_keys=keys, post_fn=post_fn, device="cpu")
    req = make_request(p=1, hw=HW, num_class=21)
    req.translations[:, 2] = 800.0
    out = svc.run([req])[0]
    assert out["rotations"].shape == (1, 3, 3) and out["translations"].shape == (1, 3)
    assert np.isfinite(out["rotations"]).all() and np.isfinite(out["translations"]).all()
    if branch == "raft_host":
        from scflow_tpu_torch.refiners.flow_pose import solve_poses_from_flow

        host = svc.fetch(svc.dispatch([req]))  # the same request, again
        raw = {k: v.numpy() for k, v in svc.dispatch([req])[0].items()}
        R, t, _ = solve_poses_from_flow(raw["flow"], raw["rendered_depths"], raw["ref_rotations"],
                                        raw["ref_translations"], raw["new_k"],
                                        occlusion=raw["occlusion"],
                                        sample_points=cfg.model.test_cfg.sample_points)
        np.testing.assert_allclose(host[0]["rotations"], R, atol=1e-6)
        np.testing.assert_allclose(host[0]["translations"], t, atol=1e-4)


def test_serve_and_loadtest_arguments():
    """parse_serve_args: JAX's flags and defaults, and --device; the
    command table; export still names its ROADMAP item; the load test's
    request is seeded."""
    a = cli.parse_serve_args(["c.py", "--checkpoint", "w.pth"])
    assert (a.host, a.port, a.frame_hw, a.max_objects, a.max_frames, a.max_delay_ms,
            a.pow2_buckets, a.keepalive_s, a.cfg_options, a.device) == (
        "127.0.0.1", 8080, [480, 640], 64, 8, 5.0, False, 0.0, [], None)
    a = cli.parse_serve_args(["c.py", "--checkpoint", "w.pth", "--port", "0", "--frame-hw",
                              "240", "320", "--max-objects", "32", "--max-frames", "4",
                              "--max-delay-ms", "2.5", "--pow2-buckets", "--keepalive-s", "30",
                              "--cfg-options", "model.test_cfg.iters=4", "--device", "cpu"])
    assert (a.port, a.frame_hw, a.max_objects, a.max_frames, a.max_delay_ms, a.pow2_buckets,
            a.keepalive_s, a.cfg_options, a.device) == (
        0, [240, 320], 32, 4, 2.5, True, 30.0, ["model.test_cfg.iters=4"], "cpu")
    with pytest.raises(SystemExit):
        cli.parse_serve_args(["c.py"])  # --checkpoint is required
    lt = cli.parse_loadtest_args(["--clients", "2", "--save-responses", "r.npz"])
    assert (lt.url, lt.clients, lt.requests, lt.objects, lt.frame_hw, lt.num_class,
            lt.save_responses) == ("http://127.0.0.1:8080", 2, 50, 4, [480, 640], 21, "r.npz")
    assert set(cli.COMMANDS) == {"train", "test", "serve", "loadtest", "export", "overfit",
                                 "bf16-parity", "serve-bench", "warmup", "keypoints", "browse",
                                 "visualize", "mmflow-convert"}
    with pytest.raises(SystemExit):
        cli.main(["export"])  # a config and --out are required
    a, b = (cli.loadtest_request((48, 64), 3, 21) for _ in range(2))
    assert all(np.array_equal(a[k], b[k]) for k in a) and a["labels"].max() < 21


def test_kernel_launch_count_is_exact_across_threads(monkeypatch):
    """The batcher and keep-alive threads launch kernels beside the caller:
    16 threads x 500 launches with a short switch interval are all counted
    (CudaKernel.launch counts under a lock; the launch itself is faked,
    which needs no card)."""
    import sys
    from contextlib import nullcontext
    from types import SimpleNamespace

    from scflow_tpu_torch.ops.cuda import build

    monkeypatch.setattr(build.torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(build.torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=0))
    kernel = build.CudaKernel("corr_lookup.cu", "fake_launch", [])
    kernel._fn = lambda *args: 0
    threads = [threading.Thread(target=lambda: [kernel.launch("cuda") for _ in range(500)])
               for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert kernel.launches == 16 * 500
