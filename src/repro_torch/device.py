"""Device resolution: the card by default, the CPU only on request; the
float32 scope the paper nets compute in; and a scope of cuDNN's
deterministic algorithms."""
from __future__ import annotations

import contextlib

import torch


def resolve(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for and absent:
    there is no silent fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


@contextlib.contextmanager
def strict_fp32():
    """TF32 off for cuBLAS matmuls and cuDNN convolutions inside, the
    caller's settings restored after. PyTorch lets cuDNN convolve float32
    in TF32 by default, which would make the card's CNN another function
    than the CPU's (and the reference's)."""
    mm = torch.backends.cuda.matmul.allow_tf32
    conv = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = conv


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms inside, the caller's setting
    restored after. cuDNN's default weight- and data-gradient algorithms
    may add with atomics, so two identical CNN rounds can differ in the
    last bits; inside this scope they are bitwise repeatable (at about
    1.4x the local step's time on an H100). A CUDA graph captured inside
    keeps the algorithms it captured."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = det
