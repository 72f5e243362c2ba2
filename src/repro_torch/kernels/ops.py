"""Public wrappers around the port's kernels, with the contracts of
``repro.kernels.ops``.

Each wrapper launches its CUDA kernel for tensors on the card and runs the
kernel's plain PyTorch version for tensors on the CPU; any other device
raises. There is no fall back: a CUDA tensor goes through the kernel or
the call raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import maghist as MH
from repro_torch.kernels import report as RP
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


def maghist(g: torch.Tensor) -> torch.Tensor:
    """(d,) or (N, d) -> (..., ceil(d / 4096), NBINS) int32 per-block
    histograms of |g| by exponent (d zero-padded)."""
    if _on_card("maghist", g):
        return MH.maghist(g)
    return MH.hist_blocks(g)


def threshold_topk(g: torch.Tensor, r: int):
    """Two-pass top-r of one vector (d,), or of each row of (N, d): a
    magnitude histogram gives tau, then the stable top-r of the candidates
    {|g| >= tau}. Returns (vals, idx int32) shaped like
    ``lax.top_k(|g|, r)``; vals are the masked magnitudes (non-candidates
    read -1). The result is the stable top-r of where(isnan, -1, |g|):
    NaN is never a candidate, and any tau at or below the r-th largest
    magnitude gives it. On the card that is the candidate report's two
    launches (``kernels/report.py``, with its vals output); on the CPU its
    plain version (``report.threshold_topk_plain``: the per-block
    histograms and a stable sort of the masked rows)."""
    rows = g.reshape(-1, g.shape[-1])
    if _on_card("threshold_topk", rows):
        vals, idx = RP.threshold_topk_batch(rows, r, vals=True)
    else:
        vals, idx = RP.threshold_topk_plain(rows, r)
    shape = (*g.shape[:-1], r)
    return vals.reshape(shape), idx.to(torch.int32).reshape(shape)


def threshold_topk_batch(G: torch.Tensor, r: int) -> torch.Tensor:
    """Two-pass top-r candidate report: (N, d) -> (N, r) int32 indices,
    equal to a stable top-r of |G| for NaN-free G (NaN is never a
    candidate). The exponent histogram gives a threshold tau that keeps
    the exact top-r set among the candidates {|g| >= tau}; on the card two
    launches compute the histogram, tau and the ranked survivors
    (``kernels/report.py``)."""
    if _on_card("threshold_topk_batch", G):
        return RP.threshold_topk_batch(G, r)
    return RP.threshold_topk_batch_plain(G, r)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len) -> torch.Tensor:
    """q (B, H, D) one query token per head, k/v (B, S, G, D) the cache,
    cache_len a host int -> (B, H, D) in q's dtype: attention over the
    first min(cache_len, S) positions (zeros when there are none)."""
    if _on_card("decode_attention", q):
        return DA.decode_attention(q, k, v, cache_len)
    return DA.decode_attention_plain(q, k, v, cache_len)
