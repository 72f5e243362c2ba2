"""Hand parameters over from the JAX reference: its ``g_params`` tree,
converted to nested dicts of numpy arrays by the caller, becomes the
port's parameter tree on a given device (same leaves, same layout), so
both packages can start from the same weights."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve


def params_from_jax(tree, device=None):
    """Nested dicts of array-likes -> the same nesting of float32 tensors
    on ``device`` (None means the card)."""
    dev = resolve(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(dev)
