"""Device resolution shared by every entry point."""

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
