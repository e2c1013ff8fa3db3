"""Registries and builders: the port's copy of scflow_tpu/registry.py (the
role of the mmcv registries in the reference, `models/*/builder.py`,
`datasets/builder.py:4-12`).  Refiners, encoders, decoders, heads,
backbones, datasets and pipeline transforms are registered under the JAX
package's names, so its config dicts build the same objects here.

Each registry names the modules that register into it (`homes`) and
imports them at its first lookup, so `build_decoder` or
`BACKBONES.build` work in a process that has imported no model.  The
port's modules take shape arguments that flax infers at init (a decoder's
class count, image size and context width, a pose head's input size, a
dense block's input channels): an entry that needs them lists them in
`requires`, and `build` without one of them raises TypeError naming it.
Pass them as the builder's keyword arguments, beside the config's JAX
keys."""

import importlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple


class Registry:
    def __init__(self, name: str, homes: Sequence[str] = ()):
        self.name = name
        self.homes = tuple(homes)
        self._modules: Dict[str, Any] = {}
        self._requires: Dict[str, Tuple[str, ...]] = {}

    def register_module(self, name: Optional[str] = None, module: Any = None,
                        requires: Sequence[str] = ()):
        if module is not None:
            self._register(name or module.__name__, module, requires)
            return module

        def decorator(cls):
            self._register(name or cls.__name__, cls, requires)
            return cls

        return decorator

    def _register(self, name: str, module: Any, requires: Sequence[str] = ()):
        if name in self._modules and self._modules[name] is not module:
            raise KeyError(f"{name} already registered in {self.name}")
        self._modules[name] = module
        self._requires[name] = tuple(requires)

    def _load(self) -> None:
        for home in self.homes:
            importlib.import_module(home)

    def get(self, name: str) -> Any:
        if name not in self._modules:
            self._load()
        if name not in self._modules:
            raise KeyError(
                f"{name} not found in registry {self.name}; "
                f"available: {sorted(self._modules)}"
            )
        return self._modules[name]

    def __contains__(self, name: str) -> bool:
        if name not in self._modules:
            self._load()
        return name in self._modules

    def names(self) -> Tuple[str, ...]:
        """Every registered name, the homes imported first."""
        self._load()
        return tuple(sorted(self._modules))

    def build(self, cfg: Dict[str, Any], **extra_kwargs) -> Any:
        if not isinstance(cfg, dict) or "type" not in cfg:
            raise TypeError(f"cfg must be a dict with a 'type' key, got {cfg!r}")
        cfg = dict(cfg)
        obj_type = cfg.pop("type")
        cls: Callable = self.get(obj_type) if isinstance(obj_type, str) else obj_type
        cfg.update(extra_kwargs)
        missing = [k for k in self._requires.get(obj_type, ()) if k not in cfg]
        if missing:
            raise TypeError(f"{self.name}: {obj_type} needs the shape argument(s) "
                            f"{', '.join(missing)}, which flax infers at init; pass them to "
                            f"the builder as keyword arguments")
        return cls(**cfg)


_MODELS = "scflow_tpu_torch.models."
REFINERS = Registry("refiners", ("scflow_tpu_torch.refiners.scflow",
                                 "scflow_tpu_torch.refiners.raft"))
ENCODERS = Registry("encoders", (_MODELS + "raft_encoder",))
DECODERS = Registry("decoders", (_MODELS + "raft_decoder", _MODELS + "scflow_decoder"))
HEADS = Registry("heads", (_MODELS + "pose_head",))
BACKBONES = Registry("backbones", (_MODELS + "resnet", _MODELS + "densenet"))
LOSSES = Registry("losses")
DATASETS = Registry("datasets", ("scflow_tpu_torch.datasets",))
PIPELINES = Registry("pipelines", ("scflow_tpu_torch.datasets",))
HOOKS = Registry("hooks")


def build_refiner(cfg, **kw):
    """A refiner from its JAX fields (SCFlowRefiner also takes the port's
    num_class and image_size).  A config file's `model` dict, with its
    encoder and decoder sub-dicts, goes to
    refiners/build.py::build_refiner_from_config instead."""
    return REFINERS.build(cfg, **kw)


def build_encoder(cfg, **kw):
    return ENCODERS.build(cfg, **kw)


def build_decoder(cfg, **kw):
    return DECODERS.build(cfg, **kw)


def build_head(cfg, **kw):
    return HEADS.build(cfg, **kw)


def build_loss(cfg, **kw):
    return LOSSES.build(cfg, **kw)


def build_dataset(cfg, **kw):
    """The dataset of a config's data.test (or .val) dict.  The datasets
    and transforms register themselves when scflow_tpu_torch.datasets is
    imported, which the registry does first."""
    return DATASETS.build(cfg, **kw)
