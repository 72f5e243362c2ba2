"""Hand parameters over from the JAX reference: a tree of nested dicts of
array-likes (the fig3 ``g_params``, an LM's parameters or its KV cache)
becomes the port's tree on a given device, with the same nesting, the
same leaf shapes (stacked layer leaves keep their leading axis) and the
same dtypes, so both packages start from the same weights; the
reference's ``DeviceAgeState`` (either age layout) becomes the port's;
its pytree optimizer state ``OptState(step, mu, nu)`` the port's; and a
sparse sync's age tree (int32 leaves shaped like the parameters, the
(2, ...) stacked [age; cost] leaves for CAFe) the port's."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.optim.optimizers import OptState
from repro_torch.tree import leaves


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


def age_state_from_jax(age, device=None):
    """A reference ``DeviceAgeState`` of either layout (array-like leaves,
    None where the layout has no such field) -> the port's, field by
    field, on ``device`` (None means the card)."""
    from repro_torch.fl.engine import DeviceAgeState
    dev = resolve(device)
    return DeviceAgeState(*[None if a is None else _leaf(a, dev)
                            for a in age])


def opt_state_from_jax(state, device=None):
    """A reference ``OptState(step, mu, nu)`` of a parameter tree -> the
    port's ``optim.OptState`` on ``device`` (None means the card): step a
    0-d int32 tensor, the moment trees leaf for leaf. SGD's ``nu`` (a 0-d
    zero) is carried as it is."""
    dev = resolve(device)
    step, mu, nu = state
    return OptState(_leaf(step, dev), params_from_jax(mu, dev),
                    params_from_jax(nu, dev))


def ages_from_jax(ages, device=None):
    """A reference sync age tree (``dist.sparse_sync.init_age_state`` and
    the steps after it) -> the port's, int32 leaves of the same shapes
    on ``device`` (None means the card)."""
    out = params_from_jax(ages, device)
    bad = [a.dtype for a in leaves(out) if a.dtype != torch.int32]
    if bad:
        raise ValueError(f"ages_from_jax: age leaves must be int32, got "
                         f"{bad}")
    return out
