"""Client-side machinery (Algorithm 1, lines 3-5): the port of
``repro.fl.client``.

All N clients advance H local Adam steps at once. Their parameters are
one flat (N, d) tensor; each step views it as the model's leaves
(stacked over clients), so the batch over clients is written out as
batched matmuls (and, for the CNN, grouped convolutions), and one
backward of the summed per-client losses gives every client's own
gradient row. Model state that is not a parameter (the CNN's BatchNorm
running statistics, a tree of (N, C) leaves; ``{}`` for the MLP)
threads through the steps beside the parameters. The last step's flat
gradient, plus the error-feedback residual where there is one, feeds
the fused top-r candidate report. The client axis may hold any m <= N
rows: the compute plane's gathered round trains only the active
clients' rows (per-client math is row-independent), which
:func:`take_rows` gathers and :func:`put_rows` scatters back.

Flat order is ``jax.tree_util``'s: leaves in sorted-key order at every
level (``fc1.b, fc1.w, fc2.b, fc2.w`` for the MLP), so a flat index
names the same parameter in both packages.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.strategies import client_candidates
from repro_torch.optim.error_feedback import ef_compensate
from repro_torch.optim.optimizers import adam, apply_updates


def softmax_xent(logits, labels):
    """Mean cross-entropy over the batch axis (the one before classes);
    leading client axes stay."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.unsqueeze(-1)).squeeze(-1).mean(-1)


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order (``jax.tree_util.tree_leaves`` on dicts)."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    return [tree]


def flatten_tree(tree, batch_dims: int = 0):
    """Leaves -> one flat tensor; ``batch_dims`` leading axes are kept."""
    leaves = tree_leaves(tree)
    lead = leaves[0].shape[:batch_dims]
    return torch.cat([l.reshape(*lead, -1) for l in leaves], dim=-1)


def unflattener(template) -> Callable:
    """flat (..., d) -> a tree shaped like ``template`` whose leaves are
    views of ``flat`` (leading axes of ``flat`` are kept on every leaf)."""
    def spec(t):
        if isinstance(t, dict):
            return {k: spec(t[k]) for k in sorted(t)}
        return tuple(t.shape)

    shapes = spec(template)

    def unflatten(flat):
        o = 0

        def build(s):
            nonlocal o
            if isinstance(s, dict):
                return {k: build(v) for k, v in s.items()}
            sz = 1
            for n in s:
                sz *= n
            leaf = flat[..., o:o + sz].reshape(*flat.shape[:-1], *s)
            o += sz
            return leaf
        return build(shapes)
    return unflatten


def make_local_phase(apply_loss: Callable, unflatten: Callable, lr: float, *,
                     report_r: int | None = None,
                     report_impl: str = "sort") -> Callable:
    """apply_loss(tree, state, x, y) -> ((N,) per-client losses, new state)
    for leaves and state stacked over clients.

    Returns phase(params_s (N, d), opt_s, state_s, bx (N, H, B, ...),
    by (N, H, B)[, ef (N, d)]) -> (params_s, opt_s, state_s, G (N, d),
    report (N, r) | None, losses (N,)): H Adam steps per client, the
    model state after them, the flat last-step gradients plus ``ef`` (the
    error-feedback residual, added before the report, as the reference
    does), the fused top-r candidate report (``client_candidates(G,
    report_r, report_impl)``) and the mean loss per client over the H
    steps."""
    opt = adam(lr)

    def phase(params_s, opt_s, state_s, bx, by, ef=None):
        losses = []
        g = None
        for h in range(bx.shape[1]):
            p = params_s.detach().requires_grad_(True)
            loss, state_s = apply_loss(unflatten(p), state_s, bx[:, h],
                                       by[:, h])
            (g,) = torch.autograd.grad(loss.sum(), p)
            updates, opt_s = opt.update(g, opt_s, p)
            params_s = apply_updates(p.detach(), updates)
            losses.append(loss.detach())
        if ef is not None:
            g = ef_compensate(ef, g)
        report = (client_candidates(g, report_r, report_impl)
                  if report_r is not None else None)
        return (params_s, opt_s, state_s, g, report,
                torch.stack(losses, dim=1).mean(dim=1))

    return phase


def make_client_phase(apply_loss: Callable, unflatten: Callable, lr: float,
                      *, report_r: int | None = None,
                      report_impl: str = "sort") -> Callable:
    """One client's local phase (the async service's landing): the batched
    phase of :func:`make_local_phase` on a one-row client axis. Returns
    phase(params (1, d), opt (rows (1, ...)), state, bx (H, B, ...), by
    (H, B)) -> (params (1, d), opt, state, g (1, d), report (1, r) | None,
    loss (1,)), each client's arithmetic as a row of the batched phase."""
    batched = make_local_phase(apply_loss, unflatten, lr, report_r=report_r,
                               report_impl=report_impl)

    def phase(params, opt, state, bx, by):
        return batched(params, opt, state, bx.unsqueeze(0), by.unsqueeze(0))

    return phase


def stack_clients(trees: list):
    """Trees of equal structure -> one tree whose leaves are stacked over
    a new leading client axis."""
    if isinstance(trees[0], dict):
        return {k: stack_clients([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def client_tree(tree, i: int):
    """Client i's row of every leaf of a tree stacked over clients."""
    return tree_map(lambda t: t[i], tree)


def map_rows(fn: Callable, *trees):
    """``fn`` over the matching leaves of trees of equal structure (nested
    dicts, tuples and NamedTuples; None leaves stay None)."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: map_rows(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple):
        out = [map_rows(fn, *xs) for xs in zip(*trees)]
        return type(t)(*out) if hasattr(t, "_fields") else tuple(out)
    return fn(*trees)


def take_rows(tree, rows: torch.Tensor):
    """The rows ``rows`` ((m,) int64 client ids) of every leaf."""
    return map_rows(lambda a: a.index_select(0, rows), tree)


def put_rows(old, idx: torch.Tensor, new):
    """``old`` with the rows ``idx`` ((m,) int64) of every leaf set to the
    leaves of ``new``; ids equal to N (the sentinel of a padded slot)
    write nothing: they land in a spare row that is cut off (the
    reference's ``.at[idx].set(..., mode="drop")``)."""
    def put(a, b):
        out = torch.cat([a, a[:1]])
        out.index_copy_(0, idx, b.to(a.dtype))
        return out[:a.shape[0]]
    return map_rows(put, old, new)


def where_rows(mask: torch.Tensor, new, old):
    """Per client: ``new``'s row where ``mask`` ((N,) bool), else
    ``old``'s; an all-True mask gives ``new`` bitwise."""
    def pick(a, b):
        return torch.where(mask.view(-1, *(1,) * (a.ndim - 1)), a, b)
    return map_rows(pick, new, old)


def broadcast_global(global_params: torch.Tensor, n: int) -> torch.Tensor:
    return global_params.unsqueeze(0).expand(n, *global_params.shape)
