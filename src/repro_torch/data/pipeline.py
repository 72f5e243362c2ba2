"""Device-resident client data: the port of ``DeviceShardStore``,
``SamplerState``, ``draw`` and ``draw_gathered`` from
``repro.data.pipeline``.

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
into a CUDA graph and replayed. :meth:`DeviceShardStore.draw_gathered`
(the compute plane's draw for the active clients only) draws the same
permutations from the generator and keeps the listed rows, so a
client's batches do not depend on whether its round was gathered.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.fl.client import put_rows


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

    def _perm(self, rows: torch.Tensor | None = None) -> torch.Tensor:
        """Fresh permutations of every client's first ``length`` slots;
        padding slots sort last. ``rows`` ((m,) int64) keeps those
        clients' rows of the same draw."""
        u = torch.rand((self.n, self.capacity), generator=self.gen,
                       device=self.device)
        lengths = self.data[2]
        if rows is not None:
            u, lengths = u.index_select(0, rows), lengths.index_select(0, rows)
        real = (torch.arange(self.capacity, device=self.device)
                < lengths.unsqueeze(1))
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
        sel, order, pos = self._select(lengths, state.order, state.pos, H)
        client = torch.arange(self.n, device=self.device).view(-1, 1, 1)
        return x[client, sel], y[client, sel], SamplerState(order, pos)

    def draw_gathered(self, data, state: SamplerState, H: int,
                      idx: torch.Tensor):
        """The next H batches of the clients in ``idx`` only: (m,) ids
        padded with the sentinel N. Returns (bx (m, H, B, ...), by (m, H,
        B), new_state) with only the listed clients' cursors and
        permutations advanced, by the math :meth:`draw` applies to their
        rows (the same permutations: each local step draws all N and
        keeps the listed rows). Padded slots read a clipped duplicate row
        and write nothing back."""
        x, y, lengths = data
        rows = idx.clamp(max=self.n - 1).to(torch.int64)
        sel, order, pos = self._select(
            lengths.index_select(0, rows), state.order.index_select(0, rows),
            state.pos.index_select(0, rows), H, rows)
        client = rows.view(-1, 1, 1)
        return x[client, sel], y[client, sel], put_rows(
            state, idx.to(torch.int64), SamplerState(order, pos))

    def _select(self, lengths, order, pos, H: int, rows=None):
        """H steps of the sampler on the given rows: (sample indices (rows,
        H, B), order, pos). The wrap, reshuffle and cursor math of every
        draw lives here."""
        span = torch.arange(self.bs, device=self.device)
        sels = []
        for _ in range(H):
            wrap = pos + self.bs > lengths
            order = torch.where(wrap.unsqueeze(1), self._perm(rows), order)
            pos = torch.where(wrap, 0, pos)
            sels.append(order.gather(1, pos.unsqueeze(1) + span))
            pos = pos + self.bs
        return torch.stack(sels, dim=1), order, pos
