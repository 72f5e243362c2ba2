"""Counter-keyed 32-bit hashes on the device: the one source of the
port's reproducible draws (the shard store's permutations, the
participation plans, the latency model and the fault lanes).

A draw is a function of its words (a key, a round or client and dispatch
counter, a stream id) in int64 tensor ops, so a past draw can be
recomputed and a replayed CUDA graph draws the round it is in from a
device counter, with no generator state and no host sync.
"""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9
# streams of the draws: each its own hash domain (SHUFFLE: the shard
# store's permutations; ROUND and DISPATCH also key the fault lanes)
BASE, ROUND, DISPATCH, UNIFORM, SHUFFLE = 1, 2, 3, 4, 5


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and c < 2^32, with c in
    two 16-bit halves, so that no int64 product overflows."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche hash (Wellons' lowbias32) of int64 x in
    [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _word(w):
    if isinstance(w, torch.Tensor):
        return w.to(torch.int64) & M32
    return int(w) & M32


def hash32(first: torch.Tensor, *words) -> torch.Tensor:
    """A 32-bit hash of a tuple of words, as an int64 tensor in [0, 2^32),
    broadcast over the tensor words. ``first`` is a tensor (it fixes the
    device); the others are tensors or Python ints, which enter as scalar
    operands (no host-to-device copy, so the draw can be captured)."""
    h = mix32(_word(first) ^ _GOLD)
    for w in words:
        h = mix32(h ^ _word(w))
    return h


def normal(first: torch.Tensor, *words) -> torch.Tensor:
    """Standard normals keyed by the words (float64): Box-Muller on two
    hashes, ``hash32(first, *words, 0)`` and ``(..., 1)``, which share
    their prefix: u1 in (0, 1] and u2 in [0, 1)."""
    h = hash32(first, *words).unsqueeze(-1)
    pair = mix32(h ^ torch.arange(2, device=h.device)).to(torch.float64)
    u1 = (pair[..., 0] + 1) / 2.0 ** 32
    u2 = pair[..., 1] / 2.0 ** 32
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
