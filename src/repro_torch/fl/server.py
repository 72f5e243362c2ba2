"""Server-side machinery (Algorithm 1, lines 8-12): the port of
``aggregate_sparse``, ``aggregate_sparse_fused`` and ``GlobalServer``
from ``repro.fl.server``. Both aggregations go through
``ops.sparse_aggregate``: the CUDA kernel on the card, its plain version
on the CPU. Sentinel entries (index >= d, e.g. padded member slots of
the segmented layout) drop.
"""
from __future__ import annotations

import torch

from repro_torch.fl import client as C
from repro_torch.kernels import ops
from repro_torch.optim.optimizers import adam, apply_updates, sgd


def aggregate_sparse(idx: torch.Tensor, vals: torch.Tensor, d: int):
    """idx/vals: (N, k) per-client sparse contributions -> dense sum (d,).
    The PS aggregation is a straight sum (paper: g~t = sum_i g~_i^t)."""
    age = torch.zeros(d, dtype=torch.int32, device=idx.device)
    return ops.sparse_aggregate(idx, vals, age)[0]


def aggregate_sparse_fused(idx: torch.Tensor, vals: torch.Tensor,
                           age: torch.Tensor,
                           mask: torch.Tensor | None = None):
    """Fused scatter-add + hit-based eq. (2) age update. idx/vals: any
    shape ((N, k), (NK,), or the segmented (C, S, k)); age: (d,) int32.
    Returns (dense (d,) float32, new_age) with new_age = 0 where any
    upload hit, age + 1 elsewhere. ``mask`` is a per-row active mask over
    idx's leading axis: masked rows contribute nothing."""
    d = age.shape[0]
    if mask is not None:
        m = mask.reshape((idx.shape[0],) + (1,) * (idx.ndim - 1))
        idx = torch.where(m, idx, torch.full_like(idx, d))
        vals = torch.where(m, vals, torch.zeros_like(vals))
    return ops.sparse_aggregate(idx, vals, age)


class GlobalServer:
    """Global model + optimizer at the PS: ``params`` is a tree (nested
    dicts) of tensors, flattened in sorted-key order and stepped as one
    flat vector on the params' own device by the port's flat ``adam``
    (or ``sgd``)."""

    def __init__(self, params, *, opt: str = "adam", lr: float = 1e-4):
        self._unflatten = C.unflattener(params)
        self._flat = C.flatten_tree(params)
        self.opt = adam(lr) if opt == "adam" else sgd(lr)
        self.opt_state = self.opt.init(self._flat)
        self.params = self._unflatten(self._flat)

    def apply_gradient(self, grad_tree):
        """One optimizer step on the gradient tree; returns the new params
        tree (views of one flat tensor)."""
        g = C.flatten_tree(grad_tree).to(self._flat.device)
        updates, self.opt_state = self.opt.update(g, self.opt_state,
                                                  self._flat)
        self._flat = apply_updates(self._flat, updates)
        self.params = self._unflatten(self._flat)
        return self.params
