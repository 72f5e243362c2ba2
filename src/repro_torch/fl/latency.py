"""Deterministic per-client latency model: the port of
``repro.fl.latency``, the one simulated-time source of the participation
plane (``Deadline``) and of the async service.

A client's time is a fixed lognormal base (its persistent speed, drawn
once from ``seed``) times per-draw lognormal noise. The reference keys
every draw by ``fold_in(key, coordinates)``, so that a past draw can be
recomputed from the constant key: round t-1's stragglers at round t,
with nothing buffered. A ``torch.Generator`` has state and cannot go
back, so here a draw is a counter-keyed function on the device
(``repro_torch.hashing``): a 32-bit integer hash of (key, round or
client and dispatch, stream) in int64 tensor ops, two such hashes a
uniform pair, and Box-Muller a standard normal. The round counter is
read from a device tensor, so a replayed CUDA graph draws the round it
is in, with no host sync.

``hetero = jitter = 0`` gives exactly 1.0 for every client and draw
(``exp(0)`` is exact).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.hashing import BASE, DISPATCH, ROUND, normal


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
