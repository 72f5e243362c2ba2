"""Fused sparse scatter-add aggregation + hit-based age update: the port
of ``repro.kernels.sparse_aggregate``.

dense[j] = sum of vals[q] over uploads q with idx[q] == j (duplicates
accumulate, indices outside [0, d) drop); new_age = 0 where any upload
hit, else age + 1.

:func:`sparse_aggregate` launches the CUDA kernel
(``csrc/sparse_aggregate.cu``), which sums in upload order with no float
atomics; :func:`sparse_aggregate_plain` is its plain PyTorch version
(``index_add_`` plus a hit mask).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def sparse_aggregate_plain(idx: torch.Tensor, vals: torch.Tensor,
                           age: torch.Tensor):
    """idx/vals: (NK,) int / float, age: (d,) int32 -> (dense (d,) float32,
    new_age (d,) int32). Dropped uploads go to a spare slot d."""
    d = age.shape[0]
    idx = idx.reshape(-1).to(torch.int64)
    ok = (idx >= 0) & (idx < d)
    slot = torch.where(ok, idx, d)
    vals = torch.where(ok, vals.reshape(-1).to(torch.float32), 0.0)
    dense = torch.zeros(d + 1, dtype=torch.float32, device=age.device)
    dense.index_add_(0, slot, vals)
    hit = torch.zeros(d + 1, dtype=torch.bool, device=age.device)
    hit.index_fill_(0, slot, True)
    new_age = torch.where(hit[:d], 0, age + 1).to(age.dtype)
    return dense[:d], new_age


def sparse_aggregate(idx: torch.Tensor, vals: torch.Tensor,
                     age: torch.Tensor):
    """CUDA kernel: same contract as :func:`sparse_aggregate_plain`, on the
    card."""
    d = age.shape[0]
    if idx.numel() != vals.numel() or age.ndim != 1:
        raise ValueError(f"sparse_aggregate: idx {tuple(idx.shape)} and vals "
                         f"{tuple(vals.shape)} must have the same size and "
                         f"age {tuple(age.shape)} one axis")
    idx = idx.reshape(-1).to(torch.int32).contiguous()
    vals = vals.reshape(-1).to(torch.float32).contiguous()
    age = age.to(torch.int32).contiguous()
    build.require_cuda("sparse_aggregate", idx, vals, age)
    dense = torch.empty(d, dtype=torch.float32, device=age.device)
    new_age = torch.empty(d, dtype=torch.int32, device=age.device)
    build.call("sparse_aggregate", idx.data_ptr(), vals.data_ptr(),
               age.data_ptr(), dense.data_ptr(), new_age.data_ptr(),
               idx.shape[0], d)
    return dense, new_age
