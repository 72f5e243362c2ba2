"""Hand parameters over from the JAX reference: a tree of nested dicts of
array-likes (the fig3 ``g_params``, an LM's parameters or its KV cache)
becomes the port's tree on a given device, with the same nesting, the
same leaf shapes (stacked layer leaves keep their leading axis) and the
same dtypes, so both packages start from the same weights."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve


def _leaf(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (JAX hands ml_dtypes arrays):
        # carry the 16-bit patterns, exact for every value, NaN included
        bits = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def params_from_jax(tree, device=None):
    """Nested dicts of array-likes -> the same nesting of tensors of the
    same dtypes on ``device`` (None means the card)."""
    dev = resolve(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return _leaf(tree, dev)
