"""Error-feedback memory for sparsified SGD [Stich et al. 2018]: the port
of ``repro.optim.error_feedback``.

The residual a client did not send is kept and added to its next
gradient, so any compression operator becomes unbiased in the limit
(the reference's ablation runs rAge-k with it). Each function takes a
tensor or a tree of nested dicts of tensors.
"""
from __future__ import annotations


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def ef_init(params):
    """Zero memory shaped like ``params``."""
    return _map(lambda x: x * 0.0, params)


def ef_compensate(memory, grads):
    """grad' = grad + memory."""
    return _map(lambda m, g: g + m, memory, grads)


def ef_update(memory, compensated, sent):
    """memory' = compensated - what was actually sent."""
    return _map(lambda c, s: c - s, compensated, sent)
