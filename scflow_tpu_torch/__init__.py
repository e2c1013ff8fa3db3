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
