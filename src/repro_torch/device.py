"""Device resolution: the card by default, the CPU only on request."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for and absent:
    there is no silent fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev
