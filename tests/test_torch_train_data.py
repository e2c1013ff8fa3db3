"""The train workflow's data layer against the JAX package's on the
synthetic BOP set of tests/synthetic_bop.py (4 rendered images, 2 classes,
the visibility annotations varied here) with the train pipeline of
tests/torch_train_helpers.py (the shipped colour transforms included):
SuperviseTrainDataset's census table and every getitem under equal seeds,
with each filter (min_visib_fract, min_visib_px_num, label_mapping,
target_label) and sample_num; the DataLoader's first batch byte for byte,
in thread mode with one worker and in process mode with two workers and
seed 7; a failing worker raising "worker failed" in both modes; and no
worker thread or process left once the iterator is closed."""

import json
import multiprocessing as mp
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from scflow_tpu.config import Config as JConfig
from scflow_tpu.datasets import DataLoader as JDataLoader
from scflow_tpu.datasets import build_dataset as j_build_dataset
from scflow_tpu_torch.config import Config
from scflow_tpu_torch.datasets import DataLoader
from scflow_tpu_torch.registry import build_dataset

from synthetic_bop import build_synthetic_bop
from torch_port_helpers import keep_torch_rng  # noqa: F401
from torch_train_helpers import (Broken, assert_same, keep_global_rngs,  # noqa: F401
                                 seed_all, train_config_text)


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    info = build_synthetic_bop(root / "data", num_images=4, render_images=True)
    info_path = root / "data" / "train_real" / "000001" / "scene_gt_info.json"
    scene_info = json.loads(info_path.read_text())
    for img_id, objs in scene_info.items():  # the second object less visible in odd images
        if int(img_id) % 2:
            objs[1].update(visib_fract=0.3, px_count_visib=50)
    info_path.write_text(json.dumps(scene_info))
    path = root / "cfg.py"
    path.write_text(train_config_text(root / "data", info["diameters"], root / "work"))
    return str(path)


def _datasets(cfg_path, **override):
    """(JAX's, the port's) data.train dataset with `override`, each built
    after seeding both global RNGs alike (PoseJitter and ComputeBbox draw
    their mesh points at construction)."""
    out = []
    for config, build in ((JConfig, j_build_dataset), (Config, build_dataset)):
        cfg = dict(config.fromfile(cfg_path).data["train"])
        cfg.update(override)
        seed_all(0)
        out.append(build(cfg))
    return out


FILTERS = [dict(), dict(min_visib_fract=0.5), dict(min_visib_px_num=100),
           dict(label_mapping={2: 1}), dict(target_label=[1]),
           dict(label_mapping={1: 2, 2: 1}, target_label=[2]), dict(sample_num=-1),
           dict(sample_num=3)]


@pytest.mark.parametrize("override", FILTERS, ids=lambda d: ",".join(d) or "default")
def test_census_and_getitem_match_jax(cfg_path, override):
    jds, pds = _datasets(cfg_path, **override)
    assert pds.total_sample_num == jds.total_sample_num
    assert "valid_sample_num" in pds.total_sample_num
    nones = 0
    for i in range(len(jds)):
        seed_all(10 + i)
        want = jds.getitem(i)
        seed_all(10 + i)
        got = pds.getitem(i)
        if want is None:
            assert got is None
            nones += 1
            continue
        assert_same(got, want, f"{override}[{i}]")
        n = got["annots"]["labels"].shape[0]
        assert n == (1 if "sample_num" not in override else
                     {3: 3, -1: 2}[override["sample_num"]])
    if override in (dict(min_visib_fract=0.5), dict(min_visib_px_num=100)):
        assert nones == 0  # the first object always passes
    seed_all(1)
    want = jds[1]
    seed_all(1)
    assert_same(pds[1], want)  # __getitem__'s redraw of an image with no object


def _first_batch(loader_cls, dataset, seed_global, **kw):
    """The first batch after seeding both global RNGs; returns once every
    thread the loader started has ended (JAX's loader leaves a worker
    thread finishing its sample after close, drawing from the global RNGs
    the next loader starts from)."""
    threads = set(threading.enumerate())
    seed_all(seed_global)
    it = iter(loader_cls(dataset, samples_per_step=2, **kw))
    try:
        return next(it)
    finally:
        it.close()
        for t in set(threading.enumerate()) - threads:
            t.join(timeout=30)


@pytest.mark.parametrize("kw", [dict(worker_mode="thread", num_workers=1, seed=0),
                                dict(worker_mode="process", num_workers=2, seed=7)],
                         ids=["thread_1", "process_2_seed_7"])
def test_first_batch_matches_jax(cfg_path, kw):
    jds, pds = _datasets(cfg_path)
    want = _first_batch(JDataLoader, jds, 3, **kw)
    got = _first_batch(DataLoader, pds, 3, **kw)
    assert got["real_images"].shape == (2, 64, 64, 3) and got["per_img_patch_num"] == [1, 1]
    assert_same(got, want)


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_failing_worker_raises(mode):
    loader = DataLoader(Broken(), samples_per_step=2, num_workers=2 if mode == "thread" else 1,
                        infinite=False, shuffle=False, worker_mode=mode)
    with pytest.raises(RuntimeError, match="worker failed") as info:
        next(iter(loader))
    assert "corrupt sample" in str(info.value.__cause__)


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_closing_the_iterator_stops_every_worker(cfg_path, mode):
    _, pds = _datasets(cfg_path)
    threads = set(threading.enumerate())
    procs = set(mp.active_children())
    it = iter(DataLoader(pds, samples_per_step=1, num_workers=2, prefetch=1,
                         worker_mode=mode))
    next(it)
    ours = [t for t in threading.enumerate() if t not in threads]
    started = [p for p in mp.active_children() if p not in procs]
    assert ours and (mode == "thread" or len(started) == 2)
    it.close()
    deadline = time.time() + 30
    while any(t.is_alive() for t in ours) and time.time() < deadline:
        time.sleep(0.05)
    assert not [t.name for t in ours if t.is_alive()]
    assert not [p for p in started if p.is_alive()]


def test_dataset_path_imports_no_torch(cfg_path):
    """A spawned process worker imports the dataset's modules to unpickle it:
    building and reading the train dataset imports no torch (nor can it
    touch a card)."""
    code = ("import sys; from scflow_tpu_torch.config import Config; "
            "from scflow_tpu_torch.registry import build_dataset; "
            f"ds = build_dataset(dict(Config.fromfile({cfg_path!r}).data['train'])); ds[0]; "
            "assert 'torch' not in sys.modules, 'torch imported'")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(Path(__file__).resolve().parents[1]),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
