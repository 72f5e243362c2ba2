"""Deterministic fault injection: the port of ``repro.fl.faults``, the one
seeded failure source of the engine and the async service.

Fault lanes, each a Bernoulli draw per client and round (or per client
and dispatch in the service):

  crash   the client never starts the round: its local state holds, its
          data stream is not consumed, its ages grow with no reset (the
          participation plane's non-participant).
  nan/inf the client trains, but its wire update is NaN or inf; the PS's
          validation gate must quarantine it.
  byz     a Byzantine client: its update scaled by ``byz_scale``, finite
          but out of band, caught by the gate's magnitude bound.
  drop    the wire loses the update after the local phase: the client's
          own state advanced, nothing lands at the PS.
  dark    a fixed set of client ids that crash every round.

The reference keys each draw by ``fold_in(key, lane, coordinates)``.
Here a draw is a counter-keyed 32-bit hash on the device
(``hashing.hash32``) of (the client, ``seed``, key, the stream ROUND
or DISPATCH, the round or dispatch count, the lane's id 101-105): a
replayed CUDA graph and a resumed run draw their own round from the
device round counter, with no generator state. The lanes share the
hash's prefix and are mixed in together, one batch of kernels for all
of them. It cannot reproduce the reference's threefry draws; the tests
hold it to the same semantics. A lane of probability 0 draws nothing,
and the lanes are independent of each other.

``FaultModel(n)`` with every probability 0 and no dark set draws all-False
masks, but the engine and the service take ``faults=None`` and such a
model alike: the round is then the unfaulted one, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.device import resolve
from repro_torch.hashing import DISPATCH, ROUND, hash32, mix32

# the lanes' hash words, as the reference's fold_in lane ids
_LANE = {"crash": 101, "nan": 102, "inf": 103, "byz": 104, "drop": 105}
_KNOWN = ("crash", "nan", "inf", "byz", "drop")


@dataclass(frozen=True)
class FaultModel:
    """Per-client Bernoulli fault draws and a fixed dark set. Each
    probability is i.i.d. per (client, round), or per (client, dispatch)
    in the async service. ``device=None`` means the card."""

    n: int
    p_crash: float = 0.0
    p_nan: float = 0.0
    p_inf: float = 0.0
    p_byz: float = 0.0
    p_drop: float = 0.0
    byz_scale: float = 1e6
    dark: tuple = ()            # client ids crashed every round
    seed: int = 0
    device: torch.device | str | None = None
    dark_mask: torch.Tensor = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"FaultModel needs n >= 1, got {self.n}")
        for nm in ("p_crash", "p_nan", "p_inf", "p_byz", "p_drop"):
            p = getattr(self, nm)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{nm}={p} not a probability")
        bad = [i for i in self.dark if not 0 <= int(i) < self.n]
        if bad:
            raise ValueError(f"dark ids out of range [0, {self.n}): {bad}")
        dev = resolve(self.device)
        object.__setattr__(self, "device", dev)
        mask = torch.zeros(self.n, dtype=torch.bool)
        mask[[int(i) for i in self.dark]] = True
        object.__setattr__(self, "dark_mask", mask.to(dev))
        # the lanes that draw: their hash words and thresholds
        drawn = [lane for lane in _KNOWN if getattr(self, f"p_{lane}") > 0]
        object.__setattr__(self, "_drawn", drawn)
        object.__setattr__(self, "_lane_words", torch.tensor(
            [_LANE[lane] for lane in drawn], dtype=torch.int64, device=dev))
        object.__setattr__(self, "_thresholds", torch.tensor(
            [getattr(self, f"p_{lane}") * 2.0 ** 32 for lane in drawn],
            dtype=torch.float64, device=dev))

    @classmethod
    def parse(cls, spec: str, n: int, seed: int = 0,
              device=None) -> "FaultModel":
        """From a CLI spec such as ``"nan:0.1,crash:0.05,dark:0+3"``:
        comma-separated ``lane:prob`` pairs, ``dark:`` with ``+``-joined
        client ids and ``byz_scale:`` a plain float."""
        kw: dict = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            name, _, val = part.partition(":")
            if name == "dark":
                kw["dark"] = tuple(int(i) for i in val.split("+") if i)
            elif name == "byz_scale":
                kw["byz_scale"] = float(val)
            elif name in _KNOWN:
                kw[f"p_{name}"] = float(val)
            else:
                raise ValueError(
                    f"unknown fault lane {name!r} (of {_KNOWN})")
        return cls(n, seed=seed, device=device, **kw)

    # -- draws ----------------------------------------------------------
    def _lanes(self, first: torch.Tensor, *words) -> list:
        """The five lanes' bools shaped like ``first`` (client ids), each
        True with its probability, keyed by (ids, seed, words, lane); a
        lane of probability 0 draws nothing."""
        out = {}
        if self._drawn:
            h = hash32(first, self.seed, *words)
            lanes = self._lane_words.view(-1, *(1,) * h.ndim)
            u = mix32(h.unsqueeze(0) ^ lanes).to(torch.float64)
            hit = u < self._thresholds.view_as(lanes)
            out = dict(zip(self._drawn, hit.unbind(0)))
        return [out[lane] if lane in out else torch.zeros(
            first.shape, dtype=torch.bool, device=self.device)
            for lane in _KNOWN]

    def round_masks(self, key, rnd):
        """(crashed, nan, inf, byz, drop): five (N,) bool masks for
        synchronous round ``rnd`` (an int or a device scalar) under the
        engine's ``key`` (an int). ``crashed`` includes the dark set."""
        ids = torch.arange(self.n, device=self.device)
        crashed, nan, inf, byz, drop = self._lanes(ids, key, ROUND, rnd)
        return crashed | self.dark_mask, nan, inf, byz, drop

    def dispatch_fate(self, key, client, j):
        """(crashed, nan, inf, byz, drop) bools of client ``client``'s
        ``j``-th async dispatch (device tensors, broadcast), recomputable
        from (key, client, j) alone, like ``LatencyModel.dispatch_s``."""
        client, j = torch.broadcast_tensors(
            torch.as_tensor(client, device=self.device).to(torch.int64),
            torch.as_tensor(j, device=self.device))
        crashed, nan, inf, byz, drop = self._lanes(client, key, DISPATCH, j)
        dark = self.dark_mask.index_select(0, client.reshape(-1)).reshape(
            client.shape)
        return crashed | dark, nan, inf, byz, drop

    def corrupt(self, g_rows: torch.Tensor, nan, inf, byz) -> torch.Tensor:
        """The wire corruptions applied to update rows ``g_rows`` ((N, d),
        (m, d) with gathered masks, or one row): byz scaling, then inf,
        then NaN (so NaN wins); masks broadcast over the trailing axis."""
        def bad(m):
            return m.unsqueeze(-1) if g_rows.ndim > m.ndim else m
        g = torch.where(bad(byz), g_rows * self.byz_scale, g_rows)
        g = torch.where(bad(inf), float("inf"), g)
        return torch.where(bad(nan), float("nan"), g)

    @property
    def any_wire(self) -> bool:
        """True if any lane can corrupt or drop a wire update."""
        return (self.p_nan > 0 or self.p_inf > 0 or self.p_byz > 0
                or self.p_drop > 0)

    @property
    def any(self) -> bool:
        return self.any_wire or self.p_crash > 0 or bool(self.dark)
