"""Public wrappers around the port's kernels, with the contracts of
``repro.kernels.ops``.

Each wrapper launches its CUDA kernel for tensors on the card and runs the
kernel's plain PyTorch version for tensors on the CPU; any other device
raises. There is no fall back: a CUDA tensor goes through the kernel or
the call raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import maghist as MH
from repro_torch.kernels import segmented_topk as ST
from repro_torch.kernels import sparse_aggregate as SA


def _on_card(name: str, t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: tensors on {t.device} are not supported")


def sparse_aggregate(idx: torch.Tensor, vals: torch.Tensor,
                     age: torch.Tensor):
    """(NK,) uploads + (d,) ages -> (dense (d,) float32, new_age (d,));
    any idx shape flattens; indices outside [0, d) drop."""
    if _on_card("sparse_aggregate", age):
        return SA.sparse_aggregate(idx, vals, age)
    return SA.sparse_aggregate_plain(idx, vals, age)


def segmented_age_topk(cand: torch.Tensor, cand_age: torch.Tensor,
                       valid: torch.Tensor, k: int, *,
                       disjoint: bool = True) -> torch.Tensor:
    """cand/cand_age (C, S, r) candidate indices / non-negative ages, valid
    (C, S) member mask -> (C, S, k) int32 picks. Needs k <= r."""
    r = cand.shape[-1]
    if k > r:
        raise ValueError(f"need k <= r candidates (got k={k}, r={r})")
    if _on_card("segmented_age_topk", cand):
        return ST.segmented_age_topk(cand, cand_age, valid, k,
                                     disjoint=disjoint)
    return ST.segmented_age_topk_plain(cand, cand_age, valid, k,
                                       disjoint=disjoint)


def maghist_batch(G: torch.Tensor) -> torch.Tensor:
    """(N, d) -> (N, NBINS) int32 row histograms of |G| by exponent."""
    if _on_card("maghist_batch", G):
        return MH.maghist_batch(G)
    return MH.hist_rows(G)


def _masked_topr(mag: torch.Tensor, tau: torch.Tensor, r: int):
    """Non-candidates (|g| < tau, and NaN) drop to -1; the survivors get a
    stable descending sort, ties to the lower index as ``lax.top_k`` does
    (``torch.topk`` promises no order on ties). Returns (vals, idx) of the
    first r."""
    masked = torch.where(mag >= tau.unsqueeze(1), mag,
                         torch.full_like(mag, -1.0))
    vals, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    return vals[:, :r], idx[:, :r]


def threshold_topk_batch(G: torch.Tensor, r: int) -> torch.Tensor:
    """Two-pass top-r candidate report: (N, d) -> (N, r) int32 indices,
    equal to a stable top-r of |G| for NaN-free G (NaN is never a
    candidate). The exponent histogram gives a threshold tau that keeps
    the exact top-r set among the candidates {|g| >= tau}."""
    mag = G.to(torch.float32).abs()
    tau = MH.threshold_from_hist_batch(maghist_batch(G), r)
    return _masked_topr(mag, tau, r)[1].to(torch.int32)
