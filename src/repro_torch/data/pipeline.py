"""Device-resident client data: the port of ``DeviceShardStore``,
``SamplerState`` and ``draw`` from ``repro.data.pipeline``.

Every client shard is uploaded once, padded to a common capacity; the
true per-client lengths bound every permutation, so padding is never
sampled. Epochs follow ``BatchIterator``: batches are drawn without
replacement, the tail that does not fill a batch is dropped, and then the
client reshuffles. Permutations come from a ``torch.Generator`` on the
store's device (it cannot reproduce the reference's threefry draws; the
tests hold it to the same properties instead).

The cursors live on the device and the wrap is decided there, as the
reference decides it in its jitted program: at each local step every
client draws a fresh permutation, which ``torch.where`` puts in place of
the old one only in the rows that wrap. A draw thus launches the same
work whatever the cursors are, has no host sync, and can be captured
into a CUDA graph and replayed.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve


class SamplerState(NamedTuple):
    """order: (N, capacity) int64 current epoch permutation per client
    (positions >= length hold padding, sorted last, never reached within
    an epoch); pos: (N,) int64 cursors. Both on the store's device."""

    order: torch.Tensor
    pos: torch.Tensor


class DeviceShardStore:
    """Client shards resident on the device. The batch size is uniform,
    ``min(batch_size, min(lengths))``, because the engine stacks client
    batches into one (N, H, B, ...) tensor."""

    def __init__(self, shards: list, batch_size: int, *, seed: int = 0,
                 device=None):
        self.device = resolve(device)
        lengths = [len(y) for _, y in shards]
        self.n = len(shards)
        self.capacity = max(lengths)
        self.bs = min(batch_size, min(lengths))
        feat = shards[0][0].shape[1:]
        x = np.zeros((self.n, self.capacity) + feat, dtype=np.float32)
        y = np.zeros((self.n, self.capacity), dtype=np.int64)
        for i, (xi, yi) in enumerate(shards):
            x[i, :len(yi)] = xi
            y[i, :len(yi)] = yi
        self.data = (torch.from_numpy(x).to(self.device),
                     torch.from_numpy(y).to(self.device),
                     torch.tensor(lengths, dtype=torch.int64,
                                  device=self.device))
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def _perm(self) -> torch.Tensor:
        """Fresh permutations of every client's first ``length`` slots;
        padding slots sort last."""
        u = torch.rand((self.n, self.capacity), generator=self.gen,
                       device=self.device)
        real = (torch.arange(self.capacity, device=self.device)
                < self.data[2].unsqueeze(1))
        u = torch.where(real, u, 2.0)
        return torch.argsort(u, dim=1, stable=True)

    def init_state(self) -> SamplerState:
        return SamplerState(order=self._perm(),
                            pos=torch.zeros(self.n, dtype=torch.int64,
                                            device=self.device))

    def draw(self, data, state: SamplerState, H: int):
        """The next H batches per client: (bx (N, H, B, ...), by (N, H, B),
        new_state). Each local step draws one permutation per client (N x
        capacity uniforms and a row sort) and keeps it where the client
        wraps."""
        x, y, lengths = data
        order, pos = state.order, state.pos
        span = torch.arange(self.bs, device=self.device)
        sels = []
        for _ in range(H):
            wrap = pos + self.bs > lengths
            order = torch.where(wrap.unsqueeze(1), self._perm(), order)
            pos = torch.where(wrap, 0, pos)
            sels.append(order.gather(1, pos.unsqueeze(1) + span))
            pos = pos + self.bs
        sel = torch.stack(sels, dim=1)                       # (N, H, B)
        client = torch.arange(self.n, device=self.device).view(-1, 1, 1)
        return x[client, sel], y[client, sel], SamplerState(order, pos)
