"""Client-side machinery (Algorithm 1, lines 3-5): the port of
``repro.fl.client``.

All N clients advance H local Adam steps at once. Their parameters are
one flat (N, d) tensor; each step views it as the model's leaves
(stacked over clients), so the batch over clients is written out as
batched matmuls, and one backward of the summed per-client losses gives
every client's own gradient row. The last step's flat gradient feeds the
fused top-r candidate report.

Flat order is ``jax.tree_util``'s: leaves in sorted-key order at every
level (``fc1.b, fc1.w, fc2.b, fc2.w`` for the MLP), so a flat index
names the same parameter in both packages.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.strategies import client_candidates
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
    """apply_loss(tree, x, y) -> (N,) per-client losses for leaves stacked
    over clients.

    Returns phase(params_s (N, d), opt_s, bx (N, H, B, ...), by (N, H, B))
    -> (params_s, opt_s, G (N, d), report (N, r) | None, losses (N,)):
    H Adam steps per client, the flat last-step gradients, the fused top-r
    candidate report (``client_candidates(G, report_r, report_impl)``) and
    the mean loss per client over the H steps."""
    opt = adam(lr)

    def phase(params_s, opt_s, bx, by):
        losses = []
        g = None
        for h in range(bx.shape[1]):
            p = params_s.detach().requires_grad_(True)
            loss = apply_loss(unflatten(p), bx[:, h], by[:, h])
            (g,) = torch.autograd.grad(loss.sum(), p)
            updates, opt_s = opt.update(g, opt_s, p)
            params_s = apply_updates(p.detach(), updates)
            losses.append(loss.detach())
        report = (client_candidates(g, report_r, report_impl)
                  if report_r is not None else None)
        return (params_s, opt_s, g, report,
                torch.stack(losses, dim=1).mean(dim=1))

    return phase


def broadcast_global(global_params: torch.Tensor, n: int) -> torch.Tensor:
    return global_params.unsqueeze(0).expand(n, *global_params.shape)
