"""rAge-k selection in the segmented per-cluster formulation: the port of
``client_candidates``, ``segment_pack`` and ``segmented_rage_select``
from ``repro.core.strategies``. The plain ``segmented_age_topk`` sits
beside its kernel, as ``kernels.segmented_topk.segmented_age_topk_plain``.

Clients are grouped by cluster into a (C, S) members matrix (client
order kept within each cluster: the tie-break and disjointness contract),
the in-cluster recursion runs over member positions only, and clusters
run in parallel (one CUDA block each on the card).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops

CANDIDATE_IMPLS = ("sort", "threshold")


class SegmentedSelection(NamedTuple):
    """Selection output in segment layout, ready for fused aggregation.

    members: (C, S) int32 client id at (cluster, position); padded slots
             hold the sentinel N.
    idx:     (C, S, k) int32 requested indices; padded slots hold the
             sentinel d, which aggregation drops.
    """

    members: torch.Tensor
    idx: torch.Tensor


def client_candidates(G: torch.Tensor, r: int,
                      impl: str = "sort") -> torch.Tensor:
    """Per-client top-r magnitude candidate report, |g|-descending with
    ties to the lower index: (N, d) -> (N, r) int32. 'threshold' is the
    histogram two-pass plane (``ops.threshold_topk_batch``), 'sort' the
    full stable sort; both give the same indices for NaN-free G."""
    if impl == "threshold":
        return ops.threshold_topk_batch(G, r)
    if impl != "sort":
        raise ValueError(f"candidates must be one of {CANDIDATE_IMPLS}, "
                         f"got {impl!r}")
    idx = torch.sort(G.to(torch.float32).abs(), dim=1, descending=True,
                     stable=True).indices
    return idx[:, :r].to(torch.int32)


def segment_pack(cluster_of: torch.Tensor, num_segments: int,
                 max_seg: int) -> torch.Tensor:
    """(N,) cluster ids -> (C, S) int32 members matrix, client order kept
    within each cluster; empty slots hold N. Entries beyond num_segments
    or max_seg are dropped, as the reference's ``mode='drop'``."""
    n = cluster_of.shape[0]
    dev = cluster_of.device
    cl = cluster_of.to(torch.int64)
    sorted_cl, order = torch.sort(cl, stable=True)
    ar = torch.arange(n, device=dev)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = sorted_cl[1:] != sorted_cl[:-1]
    seg_start = torch.cummax(torch.where(is_start, ar, 0), dim=0).values
    pos = ar - seg_start
    keep = (sorted_cl < num_segments) & (pos < max_seg)
    # dropped entries land in a spare row/column that is cut off
    rows = torch.where(keep, sorted_cl, num_segments)
    cols = torch.where(keep, pos, 0)
    members = torch.full((num_segments + 1, max_seg), n, dtype=torch.int32,
                         device=dev)
    members[rows, cols] = order.to(torch.int32)
    return members[:num_segments]


def segmented_rage_select(G: torch.Tensor | None, cluster_age: torch.Tensor,
                          cluster_of: torch.Tensor, *, r: int, k: int,
                          num_segments: int | None = None,
                          max_seg: int | None = None, disjoint: bool = True,
                          cands: torch.Tensor | None = None,
                          candidates: str = "sort", d: int | None = None):
    """Paper Algorithm 1 steps 2-3 + eq. (2), segmented, for a full round
    (every client takes part).

    G: (N, d) client gradients, or None with a precomputed ``cands``
    report and the gradient dim ``d``; cluster_age: (>= num_segments, d)
    int32 rows keyed by cluster id; cluster_of: (N,) labels. The masked
    top-k goes through ``ops.segmented_age_topk`` (the kernel on the
    card). Returns (idx (N, k) int32, new_cluster_age,
    SegmentedSelection); rows >= num_segments are untouched.
    """
    if G is None:
        if cands is None or d is None:
            raise ValueError("segmented_rage_select: G=None needs a "
                             "precomputed cands report AND the gradient "
                             "dim d")
        n = cluster_of.shape[0]
    else:
        n, d = G.shape
    if num_segments is None:
        num_segments = min(n, int(cluster_age.shape[0]))
    if max_seg is None:
        max_seg = n
    dev = cluster_of.device
    members = segment_pack(cluster_of, num_segments, max_seg)
    valid = members < n
    mclip = members.clamp(max=n - 1).to(torch.int64)
    if cands is None:
        cands = client_candidates(G, r, candidates)
    seg_cand = cands.to(torch.int64)[mclip]                    # (C, S, r)
    C, S = members.shape
    ca = cluster_age[:num_segments].to(torch.int32)           # (C, d)
    seg_age = ca.gather(1, seg_cand.reshape(C, S * r)).reshape(C, S, r)
    seg_idx = ops.segmented_age_topk(seg_cand, seg_age, valid, k,
                                     disjoint=disjoint)
    # back to client layout: every client sits in exactly one slot
    idx = torch.zeros((n + 1, k), dtype=torch.int32, device=dev)
    idx[members.reshape(-1).to(torch.int64)] = seg_idx.reshape(-1, k)
    idx = idx[:n]

    # eq. (2) per segment in closed form: a requested coordinate ends at
    # (members after its last requester), sz - 1 - last_pos; the others
    # gain every member's +1. last_pos is a scatter-max of positions;
    # padded slots scatter into a spare slot that is cut off.
    sz = valid.sum(dim=1).to(torch.int32)
    pos = torch.arange(max_seg, device=dev).view(1, S, 1).expand(C, S, k)
    flat = torch.where(
        valid.unsqueeze(-1),
        torch.arange(C, device=dev).view(C, 1, 1) * d + seg_idx.to(torch.int64),
        C * d)
    last = torch.full((C * d + 1,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, flat.reshape(-1), pos.reshape(-1), "amax")
    last = last[:C * d].view(C, d)
    new_rows = torch.where(last >= 0, sz.unsqueeze(1) - 1 - last,
                           ca + sz.unsqueeze(1)).to(torch.int32)
    new_cluster_age = cluster_age.clone()
    new_cluster_age[:num_segments] = new_rows
    seg_idx = torch.where(valid.unsqueeze(-1), seg_idx,
                          torch.full_like(seg_idx, d))
    return idx, new_cluster_age, SegmentedSelection(members, seg_idx)
