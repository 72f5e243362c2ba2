"""Trees of tensors: nested dicts, lists and tuples whose leaves are
tensors (or any other object), walked in ``jax.tree_util`` order: dict
keys sorted, lists and tuples in order. The port's parameter, gradient,
optimizer-moment and age trees all go through these, so that leaf i of
one is leaf i of another, as in the reference; and
:func:`value_and_grad` differentiates a scalar function of a tree, as
``jax.value_and_grad`` does.
"""
from __future__ import annotations

import torch


def _flatten(tree, leaves: list):
    if isinstance(tree, dict):
        keys = sorted(tree)
        return (dict, keys, [_flatten(tree[key], leaves) for key in keys])
    if isinstance(tree, (list, tuple)) and not getattr(tree, "is_tree_leaf",
                                                       False):
        return (type(tree), None, [_flatten(t, leaves) for t in tree])
    leaves.append(tree)
    return None


def _unflatten(node, leaves):
    if node is None:
        return next(leaves)
    kind, keys, children = node
    built = [_unflatten(c, leaves) for c in children]
    if kind is dict:
        return dict(zip(keys, built))
    return kind(*built) if hasattr(kind, "_fields") else kind(built)


def flatten(tree) -> tuple[list, object]:
    """(leaves in ``jax.tree_util`` order, the structure to rebuild from)."""
    leaves: list = []
    node = _flatten(tree, leaves)
    return leaves, node


def unflatten(node, leaves) -> object:
    """The tree of structure ``node`` holding ``leaves`` in order."""
    return _unflatten(node, iter(leaves))


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and the trees of the same
    structure in ``rest``; the result has ``tree``'s structure."""
    flat, node = flatten(tree)
    others = [leaves(t) for t in rest]
    return unflatten(node, [fn(*args) for args in zip(flat, *others)])


def value_and_grad(fn, tree, *args, has_aux: bool = False):
    """(fn(tree, *args), its gradient as a tree shaped like ``tree``), by
    autograd on detached copies of the leaves (the caller's tensors are
    not touched). With ``has_aux`` fn returns (value, aux) and the first
    result is that pair. A leaf the value does not depend on gets a zero
    gradient. The value, and the tensors of aux, come back detached."""
    flat, node = flatten(tree)
    leaves_ = [l.detach().requires_grad_(True) for l in flat]
    out = fn(unflatten(node, leaves_), *args)
    value = out[0] if has_aux else out
    grads = torch.autograd.grad(value, leaves_, allow_unused=True,
                                materialize_grads=True)
    value = value.detach()
    if has_aux:
        value = (value, tree_map(
            lambda a: a.detach() if torch.is_tensor(a) else a, out[1]))
    return value, unflatten(node, grads)
