"""Device-resident client data: the port of ``DeviceShardStore``,
``SamplerState`` and ``draw`` from ``repro.data.pipeline``.

Every client shard is uploaded once, padded to a common capacity; the
true per-client lengths bound every permutation, so padding is never
sampled. Epochs follow ``BatchIterator``: batches are drawn without
replacement, the tail that does not fill a batch is dropped, and then the
client reshuffles. Permutations come from a ``torch.Generator`` on the
store's device (it cannot reproduce the reference's threefry draws; the
tests hold it to the same properties instead).

Whether a client wraps depends only on its cursor, its length and the
batch size, never on data, so the cursors live on the host and a draw
needs no device-to-host sync.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve


class SamplerState(NamedTuple):
    """order: (N, capacity) int64 current epoch permutation per client on
    the device (positions >= length hold padding, sorted last, never
    reached within an epoch); pos: (N,) int64 host cursors."""

    order: torch.Tensor
    pos: np.ndarray


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
        self.lengths = np.asarray(lengths, np.int64)
        self.data = (torch.from_numpy(x).to(self.device),
                     torch.from_numpy(y).to(self.device),
                     torch.from_numpy(self.lengths).to(self.device))
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def _perm(self, rows: np.ndarray) -> torch.Tensor:
        """Fresh permutations of the first ``length`` slots of ``rows``;
        padding slots sort last."""
        u = torch.rand((len(rows), self.capacity), generator=self.gen,
                       device=self.device)
        lengths = self.data[2][torch.as_tensor(rows, device=self.device)]
        real = (torch.arange(self.capacity, device=self.device)
                < lengths.unsqueeze(1))
        u = torch.where(real, u, 2.0)
        return torch.argsort(u, dim=1, stable=True)

    def init_state(self) -> SamplerState:
        return SamplerState(order=self._perm(np.arange(self.n)),
                            pos=np.zeros(self.n, np.int64))

    def draw(self, data, state: SamplerState, H: int):
        """The next H batches per client: (bx (N, H, B, ...), by (N, H, B),
        new_state)."""
        x, y, _ = data
        order, pos = state.order, state.pos.copy()
        span = torch.arange(self.bs, device=self.device)
        sels = []
        for _ in range(H):
            wrap = pos + self.bs > self.lengths
            if wrap.any():
                rows = np.nonzero(wrap)[0]
                order = order.clone()
                order[torch.as_tensor(rows, device=self.device)] = \
                    self._perm(rows)
                pos[wrap] = 0
            start = torch.as_tensor(pos, device=self.device)
            sels.append(order.gather(1, start.unsqueeze(1) + span))
            pos += self.bs
        sel = torch.stack(sels, dim=1)                       # (N, H, B)
        client = torch.arange(self.n, device=self.device).view(-1, 1, 1)
        return x[client, sel], y[client, sel], SamplerState(order, pos)
