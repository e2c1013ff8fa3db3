"""Device resolution and float32 precision shared by every entry point."""

import contextlib
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


@contextlib.contextmanager
def full_fp32():
    """Run float32 convolutions and matmuls in full float32, whatever the
    caller's global flags: PyTorch lets cuDNN use TF32 by default
    (torch.backends.cudnn.allow_tf32 is True), which keeps about three
    decimal digits.  Both flags are restored on exit.
    torch.backends.cudnn.flags(allow_tf32=False) is no substitute: its other
    arguments default to enabled=False, which turns cuDNN off."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
