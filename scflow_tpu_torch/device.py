"""Device resolution and float32 precision shared by every entry point."""

import contextlib
import threading
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """None means CUDA.  A CUDA device on a host without a card raises: the
    port never carries on quietly on the CPU; pass device="cpu" for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        if dev.index is None:  # name the card, so devices compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


BACKENDS = ("auto", "pallas", "xla")


def resolve_backend(name: str, device: torch.device) -> str:
    """The render backend for tensors on `device`, with the JAX package's
    names so that configs carry across: 'pallas' is the tile-binned kernel
    path (the CUDA kernels for CUDA tensors, their plain versions for CPU
    ones), 'xla' the brute-force tensor path, 'auto' 'pallas' on a card and
    'xla' on the CPU.  Any other name raises."""
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; expected one of {BACKENDS}")
    if name == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "xla"
    return name


_FP32_LOCK = threading.Lock()
_fp32_depth = 0
_fp32_saved = None


@contextlib.contextmanager
def full_fp32():
    """The entry points' precision: float32 convolutions and matmuls in full
    float32, and bfloat16 matmuls reduced in float32 and rounded once, as the
    JAX package's bf16 products (an einsum with preferred_element_type
    float32, then a cast).  PyTorch lets cuDNN use TF32 by default
    (torch.backends.cudnn.allow_tf32 is True), which keeps about three
    decimal digits, and lets cuBLAS reduce bf16 GEMMs in reduced precision
    (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction).
    The three flags are process-wide, so the blocks of every thread count
    as one: the first entry saves and clears them, the last exit restores
    them (a keep-alive tick that leaves before a request's call does not
    turn TF32 back on under it).  The lock guards only the count, never
    the body.  torch.backends.cudnn.flags(allow_tf32=False) is no
    substitute: its other arguments default to enabled=False, which turns
    cuDNN off."""
    global _fp32_depth, _fp32_saved
    matmul = torch.backends.cuda.matmul
    with _FP32_LOCK:
        if _fp32_depth == 0:
            _fp32_saved = (torch.backends.cudnn.allow_tf32, matmul.allow_tf32,
                           matmul.allow_bf16_reduced_precision_reduction)
            torch.backends.cudnn.allow_tf32 = False
            matmul.allow_tf32 = False
            matmul.allow_bf16_reduced_precision_reduction = False
        _fp32_depth += 1
    try:
        yield
    finally:
        with _FP32_LOCK:
            _fp32_depth -= 1
            if _fp32_depth == 0:
                (torch.backends.cudnn.allow_tf32, matmul.allow_tf32,
                 matmul.allow_bf16_reduced_precision_reduction) = _fp32_saved
                _fp32_saved = None
