"""Sparsification operators (paper Algorithm 2 and the baselines): the
port of ``repro.core.sparsify``.

Every operator takes a flat (d,) gradient and returns the sparsified
gradient densified (the picked values at their indices, zeros elsewhere)
with the picked indices; ``rage_k`` also threads the age vector through
(eq. 2). The selection itself is :mod:`repro_torch.core.strategies`'s;
this module is the functional surface over those classes. A stochastic
method draws from an explicit ``torch.Generator`` (the reference's PRNG
key) and raises without one.

Age ties go to the larger magnitude: the candidates are ordered by
decreasing |g| and the age ranking is stable.
"""
from __future__ import annotations

import torch

from repro_torch import tree as _tree
from repro_torch.core import strategies as _S


def _densify(g: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor):
    return torch.zeros_like(g).scatter(-1, idx.to(torch.int64), vals)


def top_k(g: torch.Tensor, k: int):
    """Classic top-k magnitude sparsification [Lin et al. 2018]."""
    idx, vals, _ = _S.TopK(k=k).select(g, ())
    return _densify(g, idx, vals), idx


def rtop_k(g: torch.Tensor, gen: torch.Generator, r: int, k: int):
    """rTop-k [Barnes et al. 2020]: random k of the top-r magnitudes."""
    idx, vals, _ = _S.RTopK(r=r, k=k).select(g, gen)
    return _densify(g, idx, vals), idx


def random_k(g: torch.Tensor, gen: torch.Generator, k: int):
    """Uniform random-k (exploration-only baseline)."""
    idx, vals, _ = _S.RandomK(k=k).select(g, gen)
    return _densify(g, idx, vals), idx


def rage_k(g: torch.Tensor, age: torch.Tensor, r: int, k: int,
           exclude: torch.Tensor | None = None):
    """Paper Algorithm 2.

    g: (d,) gradient; age: (d,) int32 cluster age vector. exclude:
    optional (d,) bool, the indices already requested from other clients
    of the same cluster this round (disjointness, §II).

    Returns (g_sparse, idx (k,), new_age): eq. (2) resets the requested
    ages to 0 and adds 1 to all others.
    """
    idx, vals, new_age = _S.RAgeK(r=r, k=k).select(g, age, exclude)
    return _densify(g, idx, vals), idx, new_age


def apply_method(method: str, g: torch.Tensor, *, age=None, gen=None,
                 r: int = 0, k: int = 0, exclude=None, lam: float = 0.1,
                 candidates: str = "sort"):
    """One dispatcher over :func:`strategies.make_strategy`: returns
    (g_sparse, idx, new_state or None). For ``method='cafe'`` pass the
    ``(age, cost)`` pair as ``age``; ``lam`` is the CAFe cost weight and
    ``candidates`` the top-r candidate plane ('sort' or 'threshold', the
    same indices; 'threshold' on the card is the report kernel's two
    launches). ``dense`` returns ``g`` itself."""
    strat = _S.make_strategy(method, r=r, k=k, lam=lam,
                             candidates=candidates)
    if method == "rage_k":
        idx, vals, new_age = strat.select(g, age, exclude)
        return _densify(g, idx, vals), idx, new_age
    if method == "cafe":
        idx, vals, new_state = strat.select(g, age)
        return _densify(g, idx, vals), idx, new_state
    if method == "dense":
        idx, _, _ = strat.select(g, ())
        return g, idx, None
    state = gen if method in ("rtop_k", "random_k") else ()
    idx, vals, _ = strat.select(g, state)
    return _densify(g, idx, vals), idx, None


# ---------------------------------------------------------------------------
# the bucketed generalization: one (r, k) budget per parameter leaf
# ---------------------------------------------------------------------------

def bucket_budgets(sizes: list[int], r: int, k: int) -> list[tuple[int, int]]:
    """Split global (r, k) across buckets proportionally to bucket size.

    Guarantees r_b >= k_b >= 1 and r_b <= d_b.
    """
    total = sum(sizes)
    out = []
    for d_b in sizes:
        r_b = max(1, min(d_b, round(r * d_b / total)))
        k_b = max(1, min(r_b, round(k * d_b / total)))
        out.append((r_b, k_b))
    return out


def flatten_buckets(tree):
    """Tree (nested dicts, lists, tuples of arrays or tensors) -> list of
    flat per-leaf vectors, and the spec that :func:`unflatten_buckets`
    rebuilds the tree from."""
    leaves, node = _tree.flatten(tree)
    return [l.reshape(-1) for l in leaves], (node, [tuple(l.shape)
                                                    for l in leaves])


def unflatten_buckets(flat: list, spec):
    node, shapes = spec
    return _tree.unflatten(node, [f.reshape(s) for f, s in zip(flat, shapes)])
