"""Deterministic per-client latency model: the port of
``repro.fl.latency``, the one simulated-time source of the participation
plane (``Deadline``) and of the async service.

A client's time is a fixed lognormal base (its persistent speed, drawn
once from ``seed``) times per-draw lognormal noise. The reference keys
every draw by ``fold_in(key, coordinates)``, so that a past draw can be
recomputed from the constant key: round t-1's stragglers at round t,
with nothing buffered. A ``torch.Generator`` has state and cannot go
back, so here a draw is a counter-keyed function on the device: a
32-bit integer hash of (key, round or client and dispatch, stream) in
int64 tensor ops, two such hashes a uniform pair, and Box-Muller a
standard normal. The round counter is read from a device tensor, so a
replayed CUDA graph draws the round it is in, with no host sync.

``hetero = jitter = 0`` gives exactly 1.0 for every client and draw
(``exp(0)`` is exact).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve

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


@dataclass(frozen=True)
class LatencyModel:
    """Lognormal compute + uplink time per client.

    base_s[i] = exp(hetero * z_i), z ~ N(0, 1) keyed by (i, ``seed``),
    drawn once at construction (``base_s`` may be handed in instead, a
    numpy or torch (n,) vector, as tests hand in the reference's). Each
    draw multiplies it by exp(jitter * z') with z' keyed by the draw's
    coordinates (:meth:`round_s`, :meth:`dispatch_s`). ``device=None``
    means the card."""

    n: int
    hetero: float = 0.5        # lognormal sigma of per-client base times
    jitter: float = 0.25       # lognormal sigma of per-draw noise
    seed: int = 0
    device: torch.device | str | None = None
    base_s: torch.Tensor | None = field(default=None, repr=False,
                                        compare=False)

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"LatencyModel needs n >= 1, got {self.n}")
        dev = resolve(self.device)
        object.__setattr__(self, "device", dev)
        if self.base_s is None:
            z = normal(torch.arange(self.n, device=dev), self.seed, BASE)
            base = torch.exp(self.hetero * z.to(torch.float32))
        else:
            base = torch.as_tensor(np.array(self.base_s, np.float32),
                                   device=dev)
            if base.shape != (self.n,):
                raise ValueError(f"base_s has shape {tuple(base.shape)}, "
                                 f"expected ({self.n},)")
        object.__setattr__(self, "base_s", base)

    def _noise(self, z: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.jitter * z.to(torch.float32))

    def round_s(self, key, rnd) -> torch.Tensor:
        """(N,) simulated times of synchronous round ``rnd`` (an int or a
        device tensor), keyed by (key, rnd, client): round t-1's draw is
        recomputable at round t."""
        clients = torch.arange(self.n, device=self.device)
        return self.base_s * self._noise(normal(clients, key, rnd, ROUND))

    def dispatch_s(self, key, client, j) -> torch.Tensor:
        """Simulated time of client ``client``'s ``j``-th dispatch, keyed
        by (key, client, j); tensors broadcast."""
        client = torch.as_tensor(client, device=self.device)
        z = normal(client, key, j, DISPATCH)
        return self.base_s[client.to(torch.int64)] * self._noise(z)

    def sync_round_s(self, key, rounds: int) -> torch.Tensor:
        """(rounds,) virtual wall of each synchronous round: the slowest
        of its N dispatches, ``max_i dispatch_s(key, i, t)``."""
        t = torch.arange(rounds, device=self.device).view(-1, 1)
        clients = torch.arange(self.n, device=self.device).view(1, -1)
        return self.dispatch_s(key, clients, t).amax(dim=1)
