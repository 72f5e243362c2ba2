"""Participation plane, who takes part in a round: the port of
``repro.fl.schedule``.

Every round the engine asks its scheduler for a :class:`RoundPlan` (an
(N,) active mask, per-client staleness and aggregation weights, all
device tensors) and applies it to every method alike: clients outside
the round hold their local state and data stream, contribute nothing,
and their cluster ages keep growing (eq. (2) with no reset).

A plan is a function of the :class:`SchedState` on the device (the
scheduler's seed, the round counter, the client AoI), drawn there with
no host sync, so that a replayed CUDA graph plans the round it is in.
Schedulers are deterministic given (seed, rnd): :class:`Deadline`
recomputes round t-1's stragglers at round t.

* :class:`Full`: everyone, every round.
* :class:`UniformM`: m of N uniformly at random a round: the top m of N
  counter-keyed uniforms (``hashing.hash32``), no permutation.
* :class:`AoIBalanced`: the m clients unheard from longest; a stable
  descending sort of the AoI, so ties go to the lower id, as the
  reference's stable ``lax.top_k``.
* :class:`Deadline`: per-client simulated times (``LatencyModel``)
  against a deadline; late clients land next round with a staleness
  discount.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple, Protocol, runtime_checkable

import torch

from repro_torch.device import resolve
from repro_torch.fl.latency import LatencyModel
from repro_torch.hashing import UNIFORM, hash32

SCHEDULES = ("full", "uniform", "aoi", "deadline")


class RoundPlan(NamedTuple):
    """One round's participation decision.

    active:    (N,) bool, clients taking part in this round's upload.
    staleness: (N,) int32, rounds late each active update is (0 = fresh).
    weight:    (N,) float32 aggregation weight, applied only where stale.
    m:         upper bound on ``active.sum()`` (a host int).
    """

    active: torch.Tensor
    staleness: torch.Tensor
    weight: torch.Tensor
    m: int


class SchedState(NamedTuple):
    """Scheduler state on the device: ``seed`` (int64 scalar, constant
    across rounds; the reference's PRNG key), ``rnd`` (int32 round
    counter) and ``aoi`` ((N,) int32 rounds since the PS last heard from
    each client)."""

    seed: torch.Tensor
    rnd: torch.Tensor
    aoi: torch.Tensor

    @classmethod
    def create(cls, n: int, seed: int, device) -> "SchedState":
        return cls(seed=torch.full((), seed, dtype=torch.int64,
                                   device=device),
                   rnd=torch.zeros((), dtype=torch.int32, device=device),
                   aoi=torch.zeros(n, dtype=torch.int32, device=device))


@runtime_checkable
class Scheduler(Protocol):
    """plan(state, age_state) -> RoundPlan, on the device with no host
    sync. ``m_bound`` is the host's ceiling on a round's participants."""

    name: str
    n: int

    @property
    def m_bound(self) -> int: ...

    def plan(self, state: SchedState, age_state: Any = None) -> RoundPlan: ...


def _fresh_plan(active: torch.Tensor, m: int) -> RoundPlan:
    n = active.shape[0]
    return RoundPlan(
        active=active,
        staleness=torch.zeros(n, dtype=torch.int32, device=active.device),
        weight=torch.ones(n, dtype=torch.float32, device=active.device),
        m=m)


def _mask_of(n: int, sel: torch.Tensor) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.bool, device=sel.device).index_fill_(
        0, sel, True)


def _check_m(name: str, n: int, m: int):
    if not 1 <= m <= n:
        raise ValueError(f"{name} needs 1 <= m <= N, got m={m}, N={n}")


@dataclass(frozen=True)
class Full:
    """Synchronous full participation."""

    n: int
    device: torch.device
    name: str = "full"

    @property
    def m_bound(self) -> int:
        return self.n

    def plan(self, state: SchedState, age_state: Any = None) -> RoundPlan:
        return _fresh_plan(torch.ones(self.n, dtype=torch.bool,
                                      device=self.device), self.n)


@dataclass(frozen=True)
class UniformM:
    """m of N clients uniformly at random, drawn anew every round from
    (seed, rnd)."""

    n: int
    m: int
    name: str = "uniform"

    def __post_init__(self):
        _check_m("UniformM", self.n, self.m)

    @property
    def m_bound(self) -> int:
        return self.m

    def plan(self, state: SchedState, age_state: Any = None) -> RoundPlan:
        u = hash32(torch.arange(self.n, device=state.aoi.device), state.seed,
                   state.rnd, UNIFORM)
        sel = torch.sort(u, descending=True, stable=True).indices[:self.m]
        return _fresh_plan(_mask_of(self.n, sel), self.m)


@dataclass(frozen=True)
class AoIBalanced:
    """The m clients with the highest AoI (Javani & Wang's peak-age
    balancing); ties to the lowest id, so under symmetric starts it is
    round-robin and the peak AoI stays at about ceil(N/m)."""

    n: int
    m: int
    name: str = "aoi"

    def __post_init__(self):
        _check_m("AoIBalanced", self.n, self.m)

    @property
    def m_bound(self) -> int:
        return self.m

    def plan(self, state: SchedState, age_state: Any = None) -> RoundPlan:
        sel = torch.sort(state.aoi, descending=True,
                         stable=True).indices[:self.m]
        return _fresh_plan(_mask_of(self.n, sel), self.m)


@dataclass(frozen=True)
class Deadline:
    """Timely-FL deadline rounds (Buyukates & Ulukus).

    Each client's round time comes from the shared :class:`LatencyModel`
    (``latency``, or one built from ``hetero``, ``jitter`` and ``seed``),
    keyed by the state's seed and round. Clients within ``deadline_s``
    upload fresh (weight 1); the others drop out and land next round
    with staleness 1 and weight ``discount``. A client late at t-1 and on
    time at t contributes once, fresh."""

    n: int
    deadline_s: float
    hetero: float = 0.5
    jitter: float = 0.25
    discount: float = 0.5
    seed: int = 0
    device: torch.device | str | None = None
    latency: LatencyModel | None = field(default=None, repr=False,
                                         compare=False)
    name: str = "deadline"

    def __post_init__(self):
        if self.deadline_s <= 0:
            raise ValueError(f"Deadline needs deadline_s > 0, got "
                             f"{self.deadline_s}")
        if self.latency is None:
            object.__setattr__(self, "latency", LatencyModel(
                self.n, hetero=self.hetero, jitter=self.jitter,
                seed=self.seed, device=self.device))

    @property
    def base_s(self) -> torch.Tensor:
        return self.latency.base_s

    @property
    def m_bound(self) -> int:
        return self.n

    def _late(self, key, rnd) -> torch.Tensor:
        return self.latency.round_s(key, rnd) > self.deadline_s

    def plan(self, state: SchedState, age_state: Any = None) -> RoundPlan:
        fresh = ~self._late(state.seed, state.rnd)
        late_prev = (state.rnd > 0) & self._late(state.seed, state.rnd - 1)
        stale = late_prev & ~fresh
        return RoundPlan(
            active=fresh | stale, staleness=stale.to(torch.int32),
            weight=torch.where(stale, self.discount, 1.0).to(torch.float32),
            m=self.n)


def make_scheduler(schedule: str, n: int, *, participation_m: int = 0,
                   deadline_s: float = 0.0, seed: int = 0, device=None):
    """Config-string factory ('full' | 'uniform' | 'aoi' | 'deadline'),
    with the reference's signature plus ``device``.
    ``participation_m`` (uniform, aoi; 0 -> max(N // 4, 1)) and
    ``deadline_s`` (deadline; 0 -> 1.0, about the median simulated round
    time) mirror ``RAgeKConfig``'s fields. ``device=None`` means the
    card."""
    if schedule not in SCHEDULES:
        raise ValueError(
            f"schedule must be one of {SCHEDULES}, got {schedule!r}")
    device = resolve(device)
    if schedule == "full":
        return Full(n, device)
    if schedule == "uniform":
        return UniformM(n, participation_m or max(n // 4, 1))
    if schedule == "aoi":
        return AoIBalanced(n, participation_m or max(n // 4, 1))
    return Deadline(n, deadline_s or 1.0, seed=seed, device=device)
