"""PyTorch/CUDA port of scflow_tpu's SCFlow inference path for NVIDIA Hopper.

The JAX package `scflow_tpu` is the reference; this package imports none of
it (and no JAX).  Slice 1 covers the slim inference refinement:
render (hand-written CUDA raster kernel) -> encoders -> 8 shape-constrained
GRU iterations (hand-written CUDA corr-lookup kernel) -> final pose.

Entry points take `device=None`, which means CUDA; on a host without a card
they raise unless the caller passes `device="cpu"`.  On CPU tensors every
kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"


def lazy_exports(package: str, exports: dict):
    """(__all__, __getattr__) for a subpackage that exports `exports`
    ({name: its submodule}) and imports each submodule at the first use of
    one of its names (PEP 562), so that importing one submodule does not
    import the rest."""
    import importlib

    def __getattr__(name):
        if name in exports:
            return getattr(importlib.import_module(f"{package}.{exports[name]}"), name)
        raise AttributeError(f"module {package!r} has no attribute {name!r}")

    return list(exports), __getattr__
