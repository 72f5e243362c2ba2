"""Client data pipelines: the port of ``BatchIterator`` (the host numpy
reference), ``DeviceShardStore``, ``SamplerState``, ``draw``,
``draw_one`` and ``draw_gathered`` from ``repro.data.pipeline``, and of
its LM stream ``token_stream`` (numpy, bit for bit the reference's).

Every client shard is uploaded once, padded to a common capacity; the
true per-client lengths bound every permutation, so padding is never
sampled. Epochs follow ``BatchIterator``: batches are drawn without
replacement, the tail that does not fill a batch is dropped, and then the
client reshuffles.

A client's e-th permutation is a function of (store seed, client id, e)
alone: the row sort of a 32-bit hash of those words and the position
(``hashing.mix32`` rounds, the seed's folded on the host), padding
keyed past every hash so that it sorts last. ``SamplerState.epoch`` counts each client's
permutations, so a client's batches depend on nothing but its own draws,
whoever else drew: :meth:`DeviceShardStore.draw` (every client),
:meth:`~DeviceShardStore.draw_gathered` (the compute plane's active
clients) and :meth:`~DeviceShardStore.draw_one` (the async service's
landing client) give a client the same batches for the same count. (The
reference keeps a PRNG key per client for the same end; the hash cannot
reproduce its threefry draws, and the tests hold it to the same
properties instead.)

The cursors and counters live on the device and the wrap is decided
there, as the reference decides it in its jitted program. A draw of H
local steps hashes, for every drawn row, the W permutations it could
start within those steps (W = ceil(H / the fewest batches an epoch), a
host int fixed by the shard lengths: 1 at fig3's H 4, 4 at fig5's H 100)
in one batch, and each step ``torch.where`` puts the next of them in
place of the old permutation only in the rows that wrap. A draw thus
launches the same work whatever the cursors are, has no host sync and no
generator state, and can be captured into a CUDA graph and replayed.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.hashing import SHUFFLE, hash32, mix32


class BatchIterator:
    """Infinite shuffled batch iterator over (x, y): the host-paced numpy
    reference of the epoch semantics (a verbatim copy of the reference's;
    the same seed gives the same batches)."""

    def __init__(self, x, y, batch_size: int, *, seed: int = 0):
        self.x, self.y = x, y
        self.bs = min(batch_size, len(y))
        self.rng = np.random.default_rng(seed)
        self._order = self.rng.permutation(len(y))
        self._pos = 0

    def __next__(self):
        if self._pos + self.bs > len(self._order):
            self._order = self.rng.permutation(len(self.y))
            self._pos = 0
        sel = self._order[self._pos:self._pos + self.bs]
        self._pos += self.bs
        return self.x[sel], self.y[sel]

    def __iter__(self):
        return self


class SamplerState(NamedTuple):
    """order: (N, capacity) int64 current epoch permutation per client
    (positions >= length hold padding, sorted last, never reached within
    an epoch); pos: (N,) int64 cursors; epoch: (N,) int64 permutations
    each client has drawn (the hash counter of its current ``order``).
    All on the store's device."""

    order: torch.Tensor
    pos: torch.Tensor
    epoch: torch.Tensor


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
        self._pos = torch.arange(self.capacity, device=self.device)
        # the seed's words of the permutation hash, folded on the host
        self._salt = int(hash32(torch.tensor(seed), SHUFFLE))
        # the fewest whole batches in an epoch of any client
        self._epoch_batches = min(lengths) // self.bs

    def _perm(self, rows: torch.Tensor, lengths: torch.Tensor,
              epoch: torch.Tensor) -> torch.Tensor:
        """The ``epoch``-th permutations of the listed clients ((m,) int64
        ids and lengths; ``epoch`` (m, W) int64 counters): (m, W, capacity)
        int64. Real slots sort by 31 bits of their hash (ties in position
        order), padding after them."""
        h = mix32(mix32(rows.unsqueeze(1) ^ self._salt) ^ epoch)
        key = mix32(h.unsqueeze(2) ^ self._pos) >> 1
        key = torch.where(self._pos < lengths.view(-1, 1, 1), key.to(
            torch.int32), 2 ** 31 - 1)
        return torch.argsort(key, dim=2, stable=True)

    def init_state(self) -> SamplerState:
        rows = torch.arange(self.n, device=self.device)
        epoch = torch.zeros(self.n, dtype=torch.int64, device=self.device)
        return SamplerState(
            order=self._perm(rows, self.data[2], epoch.unsqueeze(1))[:, 0],
            pos=torch.zeros_like(epoch), epoch=epoch)

    def draw(self, data, state: SamplerState, H: int):
        """The next H batches per client: (bx (N, H, B, ...), by (N, H, B),
        new_state)."""
        x, y, lengths = data
        rows = torch.arange(self.n, device=self.device)
        sel, new = self._select(rows, lengths, state, H)
        client = rows.view(-1, 1, 1)
        return x[client, sel], y[client, sel], new

    def draw_one(self, data, state: SamplerState, H: int, i: torch.Tensor):
        """The next H batches of client ``i`` only (a device index, so a
        replayed graph draws for the client it lands). Returns (bx (H, B,
        ...), by (H, B), new_state) with only row ``i`` advanced: the
        row :meth:`draw` would give it at the same count."""
        x, y, lengths = data
        rows = i.reshape(1).to(torch.int64)
        sel, new = self._select(rows, lengths.index_select(0, rows),
                                _take(state, rows), H)
        client = rows.view(-1, 1, 1)
        return (x[client, sel][0], y[client, sel][0],
                _put(state, rows, new))

    def draw_gathered(self, data, state: SamplerState, H: int,
                      idx: torch.Tensor):
        """The next H batches of the clients in ``idx`` only: (m,) ids
        padded with the sentinel N. Returns (bx (m, H, B, ...), by (m, H,
        B), new_state) with only the listed clients' rows advanced, each
        as :meth:`draw` advances it. Padded slots read a clipped duplicate
        row and write nothing back."""
        x, y, lengths = data
        rows = idx.clamp(max=self.n - 1).to(torch.int64)
        sel, new = self._select(rows, lengths.index_select(0, rows),
                                _take(state, rows), H)
        client = rows.view(-1, 1, 1)
        return x[client, sel], y[client, sel], _put(
            state, idx.to(torch.int64), new)

    def _select(self, rows, lengths, state: SamplerState, H: int):
        """H steps of the sampler on the clients ``rows`` (their lengths
        and sampler rows given): (sample indices (rows, H, B), their new
        SamplerState rows). The wrap, reshuffle and cursor math of every
        draw lives here."""
        order, pos, epoch = state
        # a client starts at most W permutations in H steps: after its
        # first wrap it wraps every epoch_batches steps
        W = (H - 1) // self._epoch_batches + 1
        ahead = self._perm(rows, lengths, epoch.unsqueeze(1) + torch.arange(
            1, W + 1, device=self.device))
        span = torch.arange(self.bs, device=self.device)
        wraps = torch.zeros_like(pos)
        sels = []
        for _ in range(H):
            wrap = pos + self.bs > lengths
            nxt = ahead.gather(1, wraps.clamp(max=W - 1).view(-1, 1, 1)
                               .expand(-1, 1, self.capacity))[:, 0]
            order = torch.where(wrap.unsqueeze(1), nxt, order)
            wraps = wraps + wrap.to(torch.int64)
            pos = torch.where(wrap, 0, pos)
            sels.append(order.gather(1, pos.unsqueeze(1) + span))
            pos = pos + self.bs
        return torch.stack(sels, dim=1), SamplerState(order, pos,
                                                      epoch + wraps)


def _take(state: SamplerState, rows: torch.Tensor) -> SamplerState:
    return SamplerState(*(t.index_select(0, rows) for t in state))


def _put(state: SamplerState, idx: torch.Tensor,
         new: SamplerState) -> SamplerState:
    """``state`` with the rows ``idx`` set to ``new``'s; ids equal to N
    (a padded slot's sentinel) land in a spare row that is cut off
    (``fl.client.put_rows`` on the sampler's leaves: the data package
    sits below ``fl``, whose engine imports it)."""
    def put(a, b):
        out = torch.cat([a, a[:1]])
        out.index_copy_(0, idx, b)
        return out[:a.shape[0]]
    return SamplerState(*(put(a, b) for a, b in zip(state, new)))


def token_stream(vocab: int, batch: int, seq: int, *, seed: int = 0,
                 order: int = 2):
    """Synthetic LM data: a random order-``order`` Markov chain over
    ``vocab`` tokens, each context mapped to one next token (a hash),
    with a uniform jump one time in ten. Yields {"tokens", "labels"}
    (batch, seq) int32 numpy arrays, labels the tokens shifted by one.
    numpy's ``default_rng(seed)`` in the reference's order of draws, so
    the batches are the reference's, bit for bit."""
    rng = np.random.default_rng(seed)
    ctx_hash_w = rng.integers(1, vocab, order)

    def sample(n):
        toks = rng.integers(0, vocab, (n, order))
        out = np.empty((n, seq + 1), np.int64)
        out[:, :order] = toks
        for t in range(order, seq + 1):
            h = (out[:, t - order:t] * ctx_hash_w).sum(1) % vocab
            jump = rng.random(n) < 0.1
            nxt = np.where(jump, rng.integers(0, vocab, n),
                           (h * 31 + 7) % vocab)
            out[:, t] = nxt
        return out

    while True:
        chunk = sample(batch)
        yield {"tokens": chunk[:, :-1].astype(np.int32),
               "labels": chunk[:, 1:].astype(np.int32)}
