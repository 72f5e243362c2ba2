"""Server-side aggregation (Algorithm 1, lines 8-12): the port of
``aggregate_sparse`` and ``aggregate_sparse_fused`` from
``repro.fl.server``. Both go through ``ops.sparse_aggregate``: the CUDA
kernel on the card, its plain version on the CPU. Sentinel entries
(index >= d, e.g. padded member slots of the segmented layout) drop.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


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
