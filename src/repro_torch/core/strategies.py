"""Index-selection strategies: the port of ``repro.core.strategies``.

Each method is a class with ``select(g, state) -> (idx, vals, state)``
for one (d,) vector and ``select_batch(G, state)`` for the (N, d) client
batch, written over the last axis so the batch is one call, not a loop.
``state`` is the (d,) or (N, d) int32 age rows for rAge-k, the (age,
cost) pair for CAFe, a ``torch.Generator`` for the stochastic baselines
(the reference's PRNG key; the draws differ, the semantics do not) and
``()`` for the deterministic ones; ``init_state(d, gen, device)`` and
``init_batch_state(d, n, gen, device)`` make a fresh one, and every class
satisfies the runtime-checkable :class:`Strategy` protocol. Every ranking
is a stable descending sort, as the stable ``lax.top_k``: ties go to the
lower position.

rAge-k's cluster-coordinated selection is segmented: clients are grouped
by cluster into a (C, S) members matrix (client order kept within each
cluster: the tie-break and disjointness contract), the in-cluster
recursion runs over member positions only, and clusters run in parallel
(one CUDA block each on the card). The plain ``segmented_age_topk`` sits
beside its kernel, as ``kernels.segmented_topk.segmented_age_topk_plain``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Protocol, runtime_checkable

import torch

from repro_torch.kernels import ops

CANDIDATE_IMPLS = ("sort", "threshold")
STRATEGIES = ("rage_k", "rtop_k", "top_k", "random_k", "dense", "cafe")


def _stable_topk(x: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k largest along the last axis, ties to the lower
    position (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def topr_candidates(g: torch.Tensor, r: int,
                    impl: str = "sort") -> torch.Tensor:
    """Top-r magnitude candidate report of one vector (d,) or of each row
    of (N, d): |g|-descending int32 indices, ties to the lower index.
    'threshold' is the two-pass histogram plane (``ops.threshold_topk``:
    one ``maghist`` launch for all rows on the card), 'sort' the full
    stable sort; both give the same indices for NaN-free g."""
    if impl == "threshold":
        return ops.threshold_topk(g, r)[1]
    if impl != "sort":
        raise ValueError(f"candidates must be one of {CANDIDATE_IMPLS}, "
                         f"got {impl!r}")
    return _stable_topk(g.to(torch.float32).abs(), r).to(torch.int32)


def age_select(cand: torch.Tensor, cand_age: torch.Tensor, k: int):
    """Paper Algorithm 2 inner step: the k highest-age candidates. cand:
    (..., r) indices ordered by decreasing |g|; cand_age: their ages
    (excluded candidates pre-masked to -1). Age ties go to the larger
    magnitude. Returns (positions into cand, indices)."""
    sel = _stable_topk(cand_age, k)
    return sel, cand.gather(-1, sel)


def _draw(gen, lead: tuple, n: int, k: int, device) -> torch.Tensor:
    """k distinct positions of range(n), uniform, per leading row, from
    ``gen`` (int64): the k largest of n uniforms. (``torch.multinomial``
    without replacement checks its weights on the host, a sync that a
    CUDA graph cannot hold.)"""
    u = torch.rand((*lead, n), generator=_require_gen(gen, "the draw"),
                   device=device)
    return torch.topk(u, k, dim=-1).indices


def _require_gen(gen, name: str):
    """``gen`` if it is a ``torch.Generator``; else raises (the
    reference's rule for a missing PRNG key)."""
    if not isinstance(gen, torch.Generator):
        raise ValueError(f"{name} is stochastic: it needs an explicit "
                         f"torch.Generator (a shared default would make "
                         f"every client draw the same), got {gen!r}")
    return gen


def _zeros(shape, device):
    return torch.zeros(shape, dtype=torch.int32, device=device)


@runtime_checkable
class Strategy(Protocol):
    """select(g, state) -> (idx, vals, state) for one (d,) vector, and
    select_batch(G, state) for the (N, d) batch. ``init_state(d, gen,
    device)`` gives a fresh state for one vector and
    ``init_batch_state(d, n, gen, device)`` for the batch."""

    name: str
    k: int

    def init_state(self, d: int, gen=None, device=None) -> Any: ...

    def select(self, g: torch.Tensor, state: Any): ...

    def select_batch(self, G: torch.Tensor, state: Any): ...


class _Stateless:
    """The state of a deterministic method: ``()``."""

    def init_state(self, d: int, gen=None, device=None):
        return ()

    def init_batch_state(self, d: int, n: int, gen=None, device=None):
        return ()


def _reset_picked(age: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Eq. (2): every age advances by one, the picked ones reset to 0."""
    return (age + 1).scatter(-1, idx, 0)


@dataclass(frozen=True)
class Dense(_Stateless):
    """No compression: every client uploads the full gradient."""

    name: str = "dense"
    k: int = 0

    def select(self, g, state):
        idx = torch.arange(g.shape[-1], dtype=torch.int32, device=g.device)
        return idx.expand(g.shape), g, state

    select_batch = select


@dataclass(frozen=True)
class TopK(_Stateless):
    """Classic top-k magnitude sparsification [Lin et al. 2018]."""

    k: int
    name: str = "top_k"

    def select(self, g, state):
        idx = _stable_topk(g.to(torch.float32).abs(), self.k)
        return idx.to(torch.int32), g.gather(-1, idx), state

    select_batch = select


@dataclass(frozen=True)
class RandomK:
    """Uniform random-k (exploration-only baseline). State: a
    ``torch.Generator``, one for the whole batch."""

    k: int
    name: str = "random_k"

    def init_state(self, d: int, gen=None, device=None):
        return _require_gen(gen, "RandomK")

    def init_batch_state(self, d: int, n: int, gen=None, device=None):
        return _require_gen(gen, "RandomK")

    def select(self, g, gen):
        idx = _draw(gen, g.shape[:-1], g.shape[-1], self.k, g.device)
        return idx.to(torch.int32), g.gather(-1, idx), gen

    select_batch = select

    def select_rows(self, G, gen, rows: torch.Tensor, n: int):
        """:meth:`select_batch` for the rows ``rows`` ((m,) int64) of an
        n-client batch, G (m, d): the draw is made for all n clients and
        the rows kept, so a client's pick depends only on its id."""
        idx = _draw(gen, (n,), G.shape[-1], self.k,
                    G.device).index_select(0, rows)
        return idx.to(torch.int32), G.gather(-1, idx), gen


@dataclass(frozen=True)
class RTopK:
    """rTop-k [Barnes et al. 2020]: random k of the top-r magnitudes.
    State: a ``torch.Generator``, one for the whole batch."""

    r: int
    k: int
    name: str = "rtop_k"
    candidates: str = "sort"

    def init_state(self, d: int, gen=None, device=None):
        return _require_gen(gen, "RTopK")

    def init_batch_state(self, d: int, n: int, gen=None, device=None):
        return _require_gen(gen, "RTopK")

    def select(self, g, gen):
        cand = topr_candidates(g, self.r, self.candidates)
        pick = _draw(gen, g.shape[:-1], self.r, self.k, g.device)
        idx = cand.gather(-1, pick)
        return idx, g.gather(-1, idx.to(torch.int64)), gen

    select_batch = select

    def select_rows(self, G, gen, rows: torch.Tensor, n: int):
        """:meth:`select_batch` for the rows ``rows`` ((m,) int64) of an
        n-client batch, G (m, d): the picks are drawn for all n clients
        and the rows kept, so a client's draw depends only on its id."""
        cand = topr_candidates(G, self.r, self.candidates)
        pick = _draw(gen, (n,), self.r, self.k, G.device).index_select(0, rows)
        idx = cand.gather(-1, pick)
        return idx, G.gather(-1, idx.to(torch.int64)), gen


@dataclass(frozen=True)
class RAgeK:
    """Paper Algorithm 2: k highest-AGE indices of the top-r magnitude
    candidates; eq. (2) resets requested ages, ages the rest. State: the
    (d,) int32 age vector, or (N, d) rows in the batch."""

    r: int
    k: int
    name: str = "rage_k"
    candidates: str = "sort"

    def init_state(self, d: int, gen=None, device=None):
        return _zeros((d,), device)

    def init_batch_state(self, d: int, n: int, gen=None, device=None):
        return _zeros((n, d), device)

    def select(self, g, age, exclude=None):
        cand = topr_candidates(g, self.r, self.candidates).to(torch.int64)
        cand_age = age.gather(-1, cand).to(torch.int32)
        if exclude is not None:
            cand_age = torch.where(exclude.gather(-1, cand), -1, cand_age)
        _, idx = age_select(cand, cand_age, self.k)
        return idx.to(torch.int32), g.gather(-1, idx), _reset_picked(age, idx)

    def select_batch(self, G, state):
        """Uncoordinated batch: one independent age row per client.
        Cluster-coordinated selection (shared age, disjoint requests) is
        :meth:`select_segmented`."""
        return self.select(G, state)

    def select_segmented(self, G, cluster_age, cluster_of, *,
                         num_segments: int | None = None,
                         max_seg: int | None = None, disjoint: bool = True,
                         cands=None, d: int | None = None, active=None):
        """Cluster-coordinated batched selection; see
        :func:`segmented_rage_select`."""
        return segmented_rage_select(
            G, cluster_age, cluster_of, r=self.r, k=self.k,
            num_segments=num_segments, max_seg=max_seg, disjoint=disjoint,
            cands=cands, candidates=self.candidates, d=d, active=active)


@dataclass(frozen=True)
class CAFeAgeK:
    """CAFe-style cost-and-age aware variant: pick the k candidates
    maximizing ``age - lam * cost`` among the top-r magnitudes, where
    ``cost`` counts the uploads an index already made. ``lam = 0`` is
    per-client rAge-k. State: ((d,) int32 age, (d,) int32 cost), or
    (N, d) rows of each in the batch."""

    r: int
    k: int
    lam: float = 0.1
    name: str = "cafe"
    candidates: str = "sort"

    def init_state(self, d: int, gen=None, device=None):
        return _zeros((d,), device), _zeros((d,), device)

    def init_batch_state(self, d: int, n: int, gen=None, device=None):
        return _zeros((n, d), device), _zeros((n, d), device)

    def select(self, g, state):
        age, cost = state
        cand = topr_candidates(g, self.r, self.candidates).to(torch.int64)
        # The reference's jitted program contracts age - lam * cost into
        # one fused multiply-add, so the score is rounded to float32 once
        # (a two-op form rounds lam * cost first, and can turn a 1-ulp gap
        # into a tie). float64 holds the float32 product and difference
        # exactly here, so one rounding to float32 gives the same bits.
        lam = float(torch.tensor(self.lam, dtype=torch.float32))
        a = age.gather(-1, cand).to(torch.float32).to(torch.float64)
        c = cost.gather(-1, cand).to(torch.float32).to(torch.float64)
        score = (a - lam * c).to(torch.float32)
        idx = cand.gather(-1, _stable_topk(score, self.k))
        new_cost = cost.scatter_add(-1, idx,
                                    torch.ones_like(idx, dtype=cost.dtype))
        return (idx.to(torch.int32), g.gather(-1, idx),
                (_reset_picked(age, idx), new_cost))

    select_batch = select


def make_strategy(method: str, *, r: int = 0, k: int = 0, lam: float = 0.1,
                  candidates: str = "sort"):
    """Config-string factory over :data:`STRATEGIES`; ``lam`` is the CAFe
    cost weight and ``candidates`` the top-r candidate plane ('sort' |
    'threshold') of the r-candidate methods."""
    if candidates not in CANDIDATE_IMPLS:
        raise ValueError(f"candidates must be one of {CANDIDATE_IMPLS}, "
                         f"got {candidates!r}")
    if method == "rage_k":
        return RAgeK(r=r, k=k, candidates=candidates)
    if method == "rtop_k":
        return RTopK(r=r, k=k, candidates=candidates)
    if method == "top_k":
        return TopK(k=k)
    if method == "random_k":
        return RandomK(k=k)
    if method == "dense":
        return Dense()
    if method == "cafe":
        return CAFeAgeK(r=r, k=k, lam=lam, candidates=candidates)
    raise ValueError(f"unknown method {method!r}")


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
    histogram two-pass plane over whole rows (``ops.threshold_topk_batch``,
    the ``maghist_batch`` and ``threshold_topk_batch`` kernels on the
    card), 'sort' the full stable
    sort; both give the same indices for NaN-free G."""
    if impl == "threshold":
        return ops.threshold_topk_batch(G, r)
    return topr_candidates(G, r, impl)


def segment_pack(cluster_of: torch.Tensor, num_segments: int,
                 max_seg: int, active: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """(N,) cluster ids -> (C, S) int32 members matrix, client order kept
    within each cluster; empty slots hold N. Entries beyond num_segments
    or max_seg are dropped, as the reference's ``mode='drop'``.
    ``active`` ((N,) bool, the participation plane's mask) packs only the
    active clients: the others take the label num_segments and drop, so
    a cluster with no active member is a row of empty slots."""
    n = cluster_of.shape[0]
    dev = cluster_of.device
    cl = cluster_of.to(torch.int64)
    if active is not None:
        cl = torch.where(active, cl, num_segments)
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
                          candidates: str = "sort", d: int | None = None,
                          active: torch.Tensor | None = None):
    """Paper Algorithm 1 steps 2-3 + eq. (2), segmented.

    G: (N, d) client gradients, or None with a precomputed ``cands``
    report and the gradient dim ``d``; cluster_age: (>= num_segments, d)
    int32 rows keyed by cluster id; cluster_of: (N,) labels. The masked
    top-k goes through ``ops.segmented_age_topk`` (the kernel on the
    card). Returns (idx (N, k) int32, new_cluster_age,
    SegmentedSelection); rows >= num_segments are untouched.

    ``active`` ((N,) bool; None: every client) is the participation
    plane's mask: only active clients are packed, select and reset ages;
    the others request nothing (sentinel-d idx rows, and their ``cands``
    rows are never read) but still apply eq. (2)'s +1, first (they reset
    nothing, so their +1s commute), so a cluster with no active member
    keeps aging. max_seg may then be the largest active cluster.
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
    members = segment_pack(cluster_of, num_segments, max_seg, active)
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
    if active is not None:
        idx = torch.where(active.unsqueeze(1), idx, d)

    # eq. (2) per segment in closed form: a requested coordinate ends at
    # (active members after its last requester), sz - 1 - last_pos; the
    # others gain every member's +1, active or not (tot; sz when every
    # client takes part). last_pos is a scatter-max of positions; padded
    # slots scatter into a spare slot that is cut off.
    sz = valid.sum(dim=1).to(torch.int32)
    if active is None:
        tot = sz
    else:
        cl = cluster_of.to(torch.int64)
        tot = torch.zeros(num_segments + 1, dtype=torch.int32,
                          device=dev).index_add_(
            0, torch.where(cl < num_segments, cl, num_segments),
            torch.ones_like(cluster_of, dtype=torch.int32))[:num_segments]
    pos = torch.arange(max_seg, device=dev).view(1, S, 1).expand(C, S, k)
    flat = torch.where(
        valid.unsqueeze(-1),
        torch.arange(C, device=dev).view(C, 1, 1) * d + seg_idx.to(torch.int64),
        C * d)
    last = torch.full((C * d + 1,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, flat.reshape(-1), pos.reshape(-1), "amax")
    last = last[:C * d].view(C, d)
    new_rows = torch.where(last >= 0, sz.unsqueeze(1) - 1 - last,
                           ca + tot.unsqueeze(1)).to(torch.int32)
    new_cluster_age = cluster_age.clone()
    new_cluster_age[:num_segments] = new_rows
    seg_idx = torch.where(valid.unsqueeze(-1), seg_idx,
                          torch.full_like(seg_idx, d))
    return idx, new_cluster_age, SegmentedSelection(members, seg_idx)
