"""Render augmentations: photometric transforms of the rendered images inside
the train step, between the render and the normalization.  The port's copy
of scflow_tpu/models/augment.py.

Reference surface: `BaseRefiner(render_augmentations=[...])` builds a kornia
`AugmentationSequential(..., same_on_batch=False)` and applies it to the
rendered batch (base_refiner.py:52-62, :159-160).  The reference's own path
calls an undefined `build_augmentation`, and no shipped config sets the
key; the JAX package implements the intended behaviour, and so does this
module: the same config key, per-sample random parameters, applied before
normalization to [0, 1] RGB images (N, H, W, 3).

Each augmentation has two parts: `draw(shape, generator, noise_generator)`
takes its per-sample parameters (tensors of length N) from explicit
generators, `apply(images, params)` applies given parameters to the images.
The per-sample scalars (factors, gates, sigmas, hue shifts) come from a
CPU generator, so a card and the CPU draw the same ones; only the noise
field is drawn on the images' device.  The composition keys augmentation
i of step `step` by (augment_seed, step, i), as JAX folds
fold_in(fold_in(PRNGKey(augment_seed), step), i): a run is deterministic and
resumes exactly.  The bits are not jax.random's (ROADMAP §3).
"""

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from scflow_tpu_torch.parallel.dist import batch_rows
from scflow_tpu_torch.registry import Registry

AUGMENTATIONS = Registry("augmentations")

_RGB_WEIGHTS = (0.299, 0.587, 0.114)  # ITU-R BT.601, torchvision grayscale

Params = Dict[str, torch.Tensor]


def _uniform(g: torch.Generator, n: int, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(n, generator=g) * (hi - lo) + lo


def _gate(g: torch.Generator, n: int, p: float) -> torch.Tensor:
    """Per-sample keep/apply gate (kornia same_on_batch=False)."""
    return torch.rand(n, generator=g) < p


def _per_sample(x: torch.Tensor, ndim: int = 4) -> torch.Tensor:
    return x.reshape((-1,) + (1,) * (ndim - 1))


def _apply_p(gate: torch.Tensor, img: torch.Tensor, aug_img: torch.Tensor) -> torch.Tensor:
    return torch.where(_per_sample(gate), aug_img, img)


def _blend(img, other, factor):
    return factor * img + (1.0 - factor) * other


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(_RGB_WEIGHTS, dtype=img.dtype, device=img.device)
    return torch.sum(img * w, dim=-1, keepdim=True)


def _rgb_to_hsv(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.amax(dim=-1)
    minc = img.amin(dim=-1)
    v = maxc
    rng = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, rng / torch.clamp(maxc, min=1e-12), zero)
    safe = torch.where(rng > 0, rng, torch.ones_like(rng))
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(rng > 0, (h / 6.0) % 1.0, zero)
    return h, s, v


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = i.to(torch.int32) % 6

    def select(*vals):  # jnp.select over the sectors 0-5
        out = vals[-1]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


@AUGMENTATIONS.register_module("ColorJiggle")
class ColorJiggle:
    """kornia ColorJiggle / torchvision ColorJitter: per-sample
    multiplicative brightness/contrast/saturation factors in
    [max(0, 1-a), 1+a] and an additive hue shift in [-hue, hue] (fraction
    of the hue cycle, |hue| <= 0.5), in that order, then a clip to [0, 1]."""

    def __init__(self, brightness: float = 0.0, contrast: float = 0.0,
                 saturation: float = 0.0, hue: float = 0.0, p: float = 1.0):
        if not 0.0 <= hue <= 0.5:
            raise ValueError(f"hue is a cycle fraction in [0, 0.5], got {hue}")
        self.brightness, self.contrast, self.saturation = brightness, contrast, saturation
        self.hue, self.p = hue, p

    def draw(self, shape, generator, noise_generator) -> Params:
        n = shape[0]
        params = {}
        for name in ("brightness", "contrast", "saturation"):
            a = getattr(self, name)
            if a:
                params[name] = _uniform(generator, n, max(0.0, 1 - a), 1 + a)
        if self.hue:
            params["hue"] = _uniform(generator, n, -self.hue, self.hue)
        params["gate"] = _gate(generator, n, self.p)
        return params

    def apply(self, img, params):
        out = img
        if self.brightness:
            out = out * _per_sample(params["brightness"])
        if self.contrast:
            mean = torch.mean(_grayscale(out), dim=(1, 2, 3), keepdim=True)
            out = _blend(out, mean, _per_sample(params["contrast"]))
        if self.saturation:
            out = _blend(out, _grayscale(out), _per_sample(params["saturation"]))
        if self.hue:
            h, s, v = _rgb_to_hsv(torch.clamp(out, 0.0, 1.0))
            out = _hsv_to_rgb((h + _per_sample(params["hue"], 3)) % 1.0, s, v)
        out = torch.clamp(out, 0.0, 1.0)
        return _apply_p(params["gate"], img, out)


@AUGMENTATIONS.register_module("RandomGaussianNoise")
class RandomGaussianNoise:
    """img + mean + std * z, z a standard normal field (drawn on the images'
    device), clipped to [0, 1]; per-sample gate p."""

    def __init__(self, mean: float = 0.0, std: float = 0.05, p: float = 0.5):
        self.mean, self.std, self.p = mean, std, p

    def draw(self, shape, generator, noise_generator) -> Params:
        z = torch.randn(tuple(shape), generator=noise_generator,
                        device=noise_generator.device)
        return {"noise": z, "gate": _gate(generator, shape[0], self.p)}

    def apply(self, img, params):
        noise = self.mean + self.std * params["noise"]
        return _apply_p(params["gate"], img, torch.clamp(img + noise, 0.0, 1.0))


@AUGMENTATIONS.register_module("RandomGaussianBlur")
class RandomGaussianBlur:
    """Separable Gaussian blur with a per-sample sigma drawn from `sigma`;
    reflect padding (kornia's default border_type='reflect').  A weighted
    sum of kernel_size shifted slices per axis, as JAX computes it."""

    def __init__(self, kernel_size: int = 5, sigma: Tuple[float, float] = (0.1, 2.0),
                 p: float = 0.5):
        if kernel_size % 2 != 1:
            raise ValueError(f"kernel_size must be odd, got {kernel_size}")
        self.kernel_size, self.sigma, self.p = kernel_size, tuple(sigma), p

    def draw(self, shape, generator, noise_generator) -> Params:
        n = shape[0]
        return {"sigma": _uniform(generator, n, *self.sigma), "gate": _gate(generator, n, self.p)}

    def apply(self, img, params):
        k, half = self.kernel_size, self.kernel_size // 2
        offsets = torch.arange(-half, half + 1, dtype=img.dtype, device=img.device)
        w = torch.exp(-0.5 * (offsets[None, :] / params["sigma"][:, None]) ** 2)
        w = w / torch.sum(w, dim=-1, keepdim=True)  # (N, K)
        padded = F.pad(img.permute(0, 3, 1, 2), (half,) * 4, mode="reflect").permute(0, 2, 3, 1)
        h, wd = img.shape[1:3]
        rows = sum(w[:, i, None, None, None] * padded[:, i:i + h] for i in range(k))
        out = sum(w[:, i, None, None, None] * rows[:, :, i:i + wd] for i in range(k))
        return _apply_p(params["gate"], img, out)


@AUGMENTATIONS.register_module("RandomGrayscale")
class RandomGrayscale:
    def __init__(self, p: float = 0.1):
        self.p = p

    def draw(self, shape, generator, noise_generator) -> Params:
        return {"gate": _gate(generator, shape[0], self.p)}

    def apply(self, img, params):
        return _apply_p(params["gate"], img, _grayscale(img).expand_as(img))


def _seeds(augment_seed: int, step: int, index: int) -> Tuple[int, int]:
    """The two 64-bit seeds (per-sample scalars, noise field) of augmentation
    `index` at `step`."""
    state = np.random.SeedSequence([int(augment_seed), int(step), int(index)])
    return tuple(int(s) for s in state.generate_state(2, np.uint64))


def _like(params: Params, images: torch.Tensor) -> Params:
    """params on the images' device, floating ones in their dtype; CPU
    tensors go to a card through pinned memory, without waiting for the
    work queued before them."""
    out = {}
    for k, v in params.items():
        v = torch.as_tensor(v)
        if v.device != images.device and images.device.type == "cuda":
            v = v.pin_memory().to(images.device, non_blocking=True)
        out[k] = v.to(images.device, images.dtype if v.is_floating_point() else v.dtype)
    return out


class RenderAugmentation:
    """The configured augmentations in order (reference
    AugmentationSequential, same_on_batch=False).  Called as
    augment_fn(key, images) with key = (augment_seed, step), JAX's
    augment_fn(key, images) with its key folded from the step."""

    def __init__(self, augmentations: Sequence):
        self.augmentations = list(augmentations)

    def draw(self, key: Tuple[int, int], images: torch.Tensor) -> List[Params]:
        """Each augmentation's parameters for `images`.  In a data-parallel
        train step (parallel/dist.py::global_batch) they are drawn for the
        global batch, and this rank keeps its rows of them, so every rank
        count sees the augmented renders of one process on the global
        batch."""
        augment_seed, step = key
        start, total = batch_rows(images.shape[0])
        shape = (total,) + tuple(images.shape[1:])
        params = []
        for i, aug in enumerate(self.augmentations):
            s_cpu, s_dev = _seeds(augment_seed, step, i)
            drawn = aug.draw(shape, torch.Generator().manual_seed(s_cpu),
                             torch.Generator(device=images.device).manual_seed(s_dev))
            if total != images.shape[0]:
                drawn = {k: v[start:start + images.shape[0]] for k, v in drawn.items()}
            params.append(drawn)
        return params

    def apply(self, images: torch.Tensor, params: Sequence[Params]) -> torch.Tensor:
        for aug, prm in zip(self.augmentations, params):
            images = aug.apply(images, _like(prm, images))
        return images

    def __call__(self, key: Tuple[int, int], images: torch.Tensor) -> torch.Tensor:
        return self.apply(images, self.draw(key, images))


def build_render_augmentation(cfgs: Optional[Sequence[dict]]) -> Optional[Callable]:
    """The configured augmentations ([{'type': 'ColorJiggle', ...}, ...])
    composed into one augment_fn(key, images), or None for none.  A config
    that is not such a list, or names an unknown type, raises ValueError."""
    if not cfgs:
        return None
    if not isinstance(cfgs, (list, tuple)) or not all(isinstance(c, dict) and "type" in c
                                                      for c in cfgs):
        raise ValueError(f"render augmentations must be a list of dicts with a 'type', "
                         f"got {cfgs!r}")
    augs = []
    for cfg in cfgs:
        cfg = dict(cfg)
        name = cfg.pop("type")
        if name not in AUGMENTATIONS:
            raise ValueError(f"render augmentations: unknown type {name!r}; expected one of "
                             f"{sorted(AUGMENTATIONS._modules)}")
        augs.append(AUGMENTATIONS.get(name)(**cfg))
    return RenderAugmentation(augs)
