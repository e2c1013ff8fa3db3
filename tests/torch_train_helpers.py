"""Shared pieces of the train-workflow parity tests (tests/test_torch_train_*.py):
a train config on the synthetic BOP set of tests/synthetic_bop.py with the
shipped train pipeline's colour transforms (configs/refine_datasets/
ycbv_real.py:60-62) added to tests/test_e2e_cli.py's template, the global
RNG fixture that train_main makes necessary (it seeds Python's `random` and
numpy's global RNG), and a structural equality of samples and batches
across the two packages."""

import random

import numpy as np
import pytest

_COLOUR = '''    dict(type="RandomHSV", h_ratio=0.2, s_ratio=0.5, v_ratio=0.5),
    dict(type="RandomNoise", noise_ratio=0.1),
    dict(type="RandomSmooth", max_kernel_size=5.0),
'''
_CROP = '''    dict(type="Crop", size_range=(1.0, 1.25), crop_bbox_field="ref_bboxes",
         clip_border=False, pad_val=128),
'''


def train_config_text(root, diameters, work_dir, model_type="SCFlowRefiner",
                      decoder_type="SCFlowDecoder") -> str:
    """tests/test_e2e_cli.py's config (64^2, 2 iterations, 2 classes, batch
    2) with RandomHSV, RandomNoise and RandomSmooth after Crop, as the
    shipped train pipeline has them."""
    from test_e2e_cli import CONFIG_TMPL

    text = CONFIG_TMPL.format(root=str(root), diameters=diameters, work_dir=str(work_dir),
                              model_type=model_type, decoder_type=decoder_type)
    assert text.count(_CROP) == 1  # the train pipeline's
    return text.replace(_CROP, _CROP + _COLOUR)


@pytest.fixture(autouse=True)
def keep_global_rngs():
    """Restores Python's `random` and numpy's global RNG after the test:
    the tests seed them (train_main does too), and other modules' tests
    draw from them."""
    py, npy = random.getstate(), np.random.get_state()
    yield
    random.setstate(py)
    np.random.set_state(npy)


def seed_all(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)


def assert_same(got, want, path=""):
    """got (the port's) equals want (JAX's): dicts by key, sequences item by
    item, arrays by dtype and value, masks (BitmapMasks of either package)
    by their arrays and size, anything else by ==."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
    elif hasattr(want, "masks") and hasattr(want, "height"):
        assert (got.height, got.width) == (want.height, want.width), path
        assert_same(np.asarray(got.masks), np.asarray(want.masks), f"{path}.masks")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


class Broken:
    """A dataset whose every sample raises (in a module that spawned loader
    workers import quickly, to unpickle it)."""

    def __len__(self):
        return 4

    def __getitem__(self, idx):
        raise ValueError("corrupt sample")


class Draws:
    """A dataset whose sample idx is (idx, numpy's and Python's next global
    draws): a loader's shard and its workers' seeds show in what it yields
    (in a module that spawned loader workers import quickly, to unpickle
    it)."""

    def __init__(self, n: int = 11):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        return (int(idx), float(np.random.random()), random.random())
