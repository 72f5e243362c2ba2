"""Functional optimizers on tensors: the port of ``adam``, ``sgd`` and
``apply_updates`` from ``repro.optim.optimizers``.

``opt = adam(lr); state = opt.init(params); updates, state =
opt.update(grads, state, params); params = apply_updates(params,
updates)``, with updates already negated. ``torch.optim`` is not used:
the engine stacks one optimizer state per client along a leading axis,
and ``init(params, batch_dims=1)`` gives each client its own step
counter, as ``vmap(adam(lr).init)`` does in the reference. Moments are
float32 and the bias correction ``1 - b**step`` is taken in float32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch


class OptState(NamedTuple):
    step: torch.Tensor       # int32, shape = the params' batch dims
    mu: torch.Tensor         # first moment (or momentum), float32
    nu: torch.Tensor | None  # second moment (adam only)


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable   # (grads, state, params) -> (updates, new_state)


def _step0(params: torch.Tensor, batch_dims: int) -> torch.Tensor:
    return torch.zeros(params.shape[:batch_dims], dtype=torch.int32,
                       device=params.device)


def _per_row(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-batch-row scalar over the row's trailing axes."""
    return t.reshape(t.shape + (1,) * (like.ndim - t.ndim))


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params, batch_dims: int = 0):
        z = torch.zeros_like(params, dtype=torch.float32)
        return OptState(_step0(params, batch_dims), z, z.clone())

    def update(grads, state, params=None):
        step = state.step + 1
        sf = step.to(torch.float32)
        b1t = _per_row(1 - torch.pow(b1, sf), grads)
        b2t = _per_row(1 - torch.pow(b2, sf), grads)
        gf = grads.to(torch.float32)
        m2 = b1 * state.mu + (1 - b1) * gf
        v2 = b2 * state.nu + (1 - b2) * gf * gf
        u = -lr * (m2 / b1t) / (torch.sqrt(v2 / b2t) + eps)
        return u, OptState(step, m2, v2)

    return Optimizer(init, update)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params, batch_dims: int = 0):
        return OptState(_step0(params, batch_dims),
                        torch.zeros_like(params, dtype=torch.float32), None)

    def update(grads, state, params=None):
        m2 = momentum * state.mu + grads.to(torch.float32)
        return -lr * m2, OptState(state.step + 1, m2, None)

    return Optimizer(init, update)


def apply_updates(params: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    return (params.to(torch.float32) + updates).to(params.dtype)
