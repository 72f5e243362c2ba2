"""The paper's Network-1 (MNIST MLP, 39,760 params) in PyTorch: the port
of ``repro.models.paper_nets.mlp_init`` / ``mlp_apply``.

Parameters are a nested dict of tensors in the JAX layout (``x @ w`` with
``w`` of shape (784, 50)), so flattening in sorted-key order gives the
reference's flat index space. ``mlp_apply`` also takes parameters
stacked over clients (a leading axis on every leaf); the batch over
clients is then one ``torch.matmul`` per layer.
"""
from __future__ import annotations

import torch


def mlp_init(generator: torch.Generator, device=None) -> dict:
    """FC(784,50) + ReLU + FC(50,10), weights N(0, 1/fan_in), zero biases.
    Drawn on ``generator``'s device, then moved to ``device``, so one seed
    gives the same weights on every device."""
    def normal(shape, fan_in):
        return (torch.randn(shape, generator=generator) * fan_in ** -0.5
                ).to(device)
    return {
        "fc1": {"w": normal((784, 50), 784),
                "b": torch.zeros(50, device=device)},
        "fc2": {"w": normal((50, 10), 50),
                "b": torch.zeros(10, device=device)},
    }


def mlp_apply(params, x):
    """x: (..., B, 28, 28, 1) or (..., B, 784) -> logits (..., B, 10).
    Leaves with a leading client axis take x with the same leading axis."""
    w1, b1 = params["fc1"]["w"], params["fc1"]["b"]
    w2, b2 = params["fc2"]["w"], params["fc2"]["b"]
    lead = w1.ndim - 1                       # client axes + the batch axis
    x = x.reshape(*x.shape[:lead], -1)
    h = torch.relu(x @ w1 + b1.unsqueeze(-2))
    return h @ w2 + b2.unsqueeze(-2)


def param_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    return int(tree.numel())
