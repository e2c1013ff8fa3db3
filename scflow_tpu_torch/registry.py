"""Registries and the builder, the port's own copy of the part of
scflow_tpu/registry.py that the data layer uses (the role of the mmcv
registries in the reference, `datasets/builder.py:4-12`): datasets and
pipeline transforms are registered under the JAX package's names, so its
config files build the same objects here."""

from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._modules: Dict[str, Any] = {}

    def register_module(self, name: Optional[str] = None, module: Any = None):
        if module is not None:
            self._register(name or module.__name__, module)
            return module

        def decorator(cls):
            self._register(name or cls.__name__, cls)
            return cls

        return decorator

    def _register(self, name: str, module: Any):
        if name in self._modules and self._modules[name] is not module:
            raise KeyError(f"{name} already registered in {self.name}")
        self._modules[name] = module

    def get(self, name: str) -> Any:
        if name not in self._modules:
            raise KeyError(
                f"{name} not found in registry {self.name}; "
                f"available: {sorted(self._modules)}"
            )
        return self._modules[name]

    def __contains__(self, name: str) -> bool:
        return name in self._modules

    def build(self, cfg: Dict[str, Any], **extra_kwargs) -> Any:
        if not isinstance(cfg, dict) or "type" not in cfg:
            raise TypeError(f"cfg must be a dict with a 'type' key, got {cfg!r}")
        cfg = dict(cfg)
        obj_type = cfg.pop("type")
        cls: Callable = self.get(obj_type) if isinstance(obj_type, str) else obj_type
        cfg.update(extra_kwargs)
        return cls(**cfg)


DATASETS = Registry("datasets")
PIPELINES = Registry("pipelines")


def build_dataset(cfg, **kw):
    """The dataset of a config's data.test (or .val) dict.  The datasets
    and transforms register themselves when scflow_tpu_torch.datasets is
    imported, which this does first."""
    import scflow_tpu_torch.datasets  # noqa: F401

    return DATASETS.build(cfg, **kw)
