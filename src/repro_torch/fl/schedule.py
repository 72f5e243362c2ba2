"""Participation plane, who takes part in a round: the port of
``RoundPlan``, ``SchedState`` and ``Full`` from ``repro.fl.schedule``.
Only full participation is ported so far."""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

SCHEDULES = ("full", "uniform", "aoi", "deadline")


class RoundPlan(NamedTuple):
    """One round's participation decision.

    active:    (N,) bool, clients taking part in this round's upload.
    staleness: (N,) int32, rounds late each active update is (0 = fresh).
    weight:    (N,) float32 aggregation weight.
    m:         upper bound on ``active.sum()``.
    """

    active: torch.Tensor
    staleness: torch.Tensor
    weight: torch.Tensor
    m: int


class SchedState(NamedTuple):
    """Scheduler state on the device: the round counter (an int32
    scalar) and the client-level AoI (rounds since the PS last heard from
    each client)."""

    rnd: torch.Tensor
    aoi: torch.Tensor

    @classmethod
    def create(cls, n: int, device) -> "SchedState":
        return cls(rnd=torch.zeros((), dtype=torch.int32, device=device),
                   aoi=torch.zeros(n, dtype=torch.int32, device=device))


@dataclass(frozen=True)
class Full:
    """Synchronous full participation."""

    n: int
    device: torch.device
    name: str = "full"

    @property
    def m_bound(self) -> int:
        return self.n

    def plan(self, state: SchedState) -> RoundPlan:
        return RoundPlan(
            active=torch.ones(self.n, dtype=torch.bool, device=self.device),
            staleness=torch.zeros(self.n, dtype=torch.int32,
                                  device=self.device),
            weight=torch.ones(self.n, dtype=torch.float32,
                              device=self.device),
            m=self.n)


def make_scheduler(schedule: str, n: int, *, device) -> Full:
    if schedule not in SCHEDULES:
        raise ValueError(
            f"schedule must be one of {SCHEDULES}, got {schedule!r}")
    if schedule != "full":
        raise NotImplementedError(
            f"schedule={schedule!r} is not ported yet (ROADMAP queue 1, "
            "item 10: participation and compute planes)")
    return Full(n, device)
