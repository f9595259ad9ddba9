"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the GPU. A CUDA device without a visible GPU raises:
    the port never falls back to the CPU unless it is asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def generator(device: torch.device, seed: int) -> torch.Generator:
    """An explicit, seeded random-number generator on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
