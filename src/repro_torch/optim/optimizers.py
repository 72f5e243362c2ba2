"""Functional optimizers on tensors: the port of ``adam``, ``sgd``,
``apply_updates``, ``clip_by_global_norm`` and ``cosine_schedule`` from
``repro.optim.optimizers``.

``opt = adam(lr); state = opt.init(params); updates, state =
opt.update(grads, state, params); params = apply_updates(params,
updates)``, with updates already negated. ``params`` is a tensor or a
tree of them (nested dicts, lists, tuples: ``repro_torch.tree``), as the
reference's pytrees; a tree's state has one int32 step and moment trees
of its structure. ``torch.optim`` is not used: the engine stacks one
optimizer state per client along a leading axis of one tensor, and
``init(params, batch_dims=1)`` gives each client its own step counter,
as ``vmap(adam(lr).init)`` does in the reference. Moments are float32,
updates float32 (``apply_updates`` casts back to each parameter's
dtype), and the bias correction ``1 - b**step`` is taken in float32.
``lr`` is a float or a schedule ``lr(step) -> float`` (such as
:func:`cosine_schedule`), read at the new step of each row.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree as _tree


class OptState(NamedTuple):
    step: torch.Tensor       # int32, shape = the params' batch dims
    mu: Any                  # first moment (or momentum), float32
    nu: Any                  # second moment (adam); sgd: None (a tree: 0)


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable   # (grads, state, params) -> (updates, new_state)


def _is_tree(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def _step0(params, batch_dims: int) -> torch.Tensor:
    if _is_tree(params):
        return torch.zeros((), dtype=torch.int32,
                           device=_tree.leaves(params)[0].device)
    return torch.zeros(params.shape[:batch_dims], dtype=torch.int32,
                       device=params.device)


def _zeros_f32(params):
    return _tree.tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _per_row(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-batch-row scalar over the row's trailing axes."""
    return t.reshape(t.shape + (1,) * (like.ndim - t.ndim))


def _lr_at(lr, step: torch.Tensor, like: torch.Tensor):
    return _per_row(torch.as_tensor(lr(step)), like) if callable(lr) else lr


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """``weight_decay`` adds ``-lr * weight_decay * p`` to each update
    (decoupled, in float32), where the reference adds it: with ``params``
    given, else (as the reference) with the gradients in their place."""
    def init(params, batch_dims: int = 0):
        z = _zeros_f32(params)
        return OptState(_step0(params, batch_dims), z,
                        _tree.tree_map(torch.clone, z))

    def update(grads, state, params=None):
        step = state.step + 1
        sf = step.to(torch.float32)

        def upd(g, m, v, p):
            b1t = _per_row(1 - torch.pow(b1, sf), g)
            b2t = _per_row(1 - torch.pow(b2, sf), g)
            gf = g.to(torch.float32)
            m2 = b1 * m + (1 - b1) * gf
            v2 = b2 * v + (1 - b2) * gf * gf
            lr_t = _lr_at(lr, step, gf)
            u = -lr_t * (m2 / b1t) / (torch.sqrt(v2 / b2t) + eps)
            if weight_decay:
                u = u - lr_t * weight_decay * p.to(torch.float32)
            return u, m2, v2

        p = params if params is not None else grads
        u, m2, v2 = _split(_tree.tree_map(upd, grads, state.mu, state.nu,
                                          p), grads, 3)
        return u, OptState(step, m2, v2)

    return Optimizer(init, update)


def _split(out, like, n: int) -> list:
    """``tree_map``'s result, a tree (or tensor) of n-tuples shaped like
    ``like`` -> n trees (or tensors)."""
    node = _tree.flatten(like)[1]
    flat = _tree.leaves(out)
    return [_tree.unflatten(node, flat[j::n]) for j in range(n)]


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    def init(params, batch_dims: int = 0):
        nu = (torch.zeros((), device=_tree.leaves(params)[0].device)
              if _is_tree(params) else None)
        return OptState(_step0(params, batch_dims), _zeros_f32(params), nu)

    def update(grads, state, params=None):
        step = state.step + 1

        def upd(g, m):
            m2 = momentum * m + g.to(torch.float32)
            return -_lr_at(lr, step, m2) * m2, m2

        u, m2 = _split(_tree.tree_map(upd, grads, state.mu), grads, 2)
        return u, OptState(step, m2, state.nu)

    return Optimizer(init, update)


def apply_updates(params, updates):
    """``params + updates`` in float32, cast back to each param's dtype; a
    tensor or a tree."""
    return _tree.tree_map(
        lambda p, u: (p.to(torch.float32) + u).to(p.dtype), params, updates)


def clip_by_global_norm(grads, max_norm: float):
    """Scale a tensor or a tree of nested dicts of tensors so that its
    global L2 norm is at most ``max_norm``. Returns (clipped, norm)."""
    gn = torch.sqrt(sum(l.to(torch.float32).square().sum()
                        for l in _tree.leaves(grads)))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return _tree.tree_map(lambda g: g * scale, grads), gn


def cosine_schedule(peak: float, warmup: int, total: int):
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``: step (int or tensor) -> float32 rate."""
    def f(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = peak * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(s < warmup, warm, cos)
    return f
