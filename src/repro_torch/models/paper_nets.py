"""The paper's two networks in PyTorch: Network-1 (MNIST MLP, 39,760
params) and Network-2 (CIFAR10 CNN, 2,515,338 params), the port of
``repro.models.paper_nets``.

Parameters are a nested dict of tensors in the JAX layout (``x @ w`` with
``w`` of shape (784, 50); conv weights HWIO), so flattening in sorted-key
order gives the reference's flat index space. Both apply functions also
take parameters stacked over clients (a leading axis on every leaf); the
batch over clients is then one launch per layer: a batched
``torch.matmul`` for the dense layers and, for the CNN, one grouped
convolution with the clients folded into the channels (``groups=N``),
whose per-channel BatchNorm statistics are then per client.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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


# Network-2: (c_in, c_out, stride); 32 ->(pool)16 ->8 ->4 ->2 => flatten 2048
CONVS = [(3, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2)]
FCS = [(2048, 128), (128, 256), (256, 512), (512, 1024), (1024, 10)]
BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def cnn_init(generator: torch.Generator, device=None) -> tuple[dict, dict]:
    """(params, bn_state): conv weights HWIO N(0, 2/fan_in), FC weights
    N(0, 2/fan_in), zero biases, BatchNorm scale 1 and bias 0; running
    mean 0 and var 1. Drawn on ``generator``'s device, then moved to
    ``device``."""
    def normal(shape, fan_in):
        return (torch.randn(shape, generator=generator)
                * math.sqrt(2 / fan_in)).to(device)

    def const(co, v):
        return torch.full((co,), float(v), device=device)

    params: dict = {}
    state: dict = {}
    for i, (ci, co, _) in enumerate(CONVS):
        params[f"conv{i}"] = {"w": normal((3, 3, ci, co), ci * 9),
                              "b": const(co, 0), "bn_scale": const(co, 1),
                              "bn_bias": const(co, 0)}
        state[f"conv{i}"] = {"mean": const(co, 0), "var": const(co, 1)}
    for j, (fi, fo) in enumerate(FCS):
        params[f"fc{j}"] = {"w": normal((fi, fo), fi), "b": const(fo, 0)}
    return params, state


def same_pad(size: int, stride: int, k: int = 3) -> tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (before, after). At stride
    2 on an even size it is (0, 1), which ``F.conv2d``'s symmetric
    ``padding`` cannot express."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_same(h, w, b, stride: int, groups: int = 1):
    """``lax.conv_general_dilated(..., padding="SAME")`` on NCHW ``h`` and
    OIHW ``w``: symmetric SAME padding goes to the convolution, an
    asymmetric one is applied first."""
    (pt, pb), (pl, pr) = (same_pad(h.shape[2], stride, w.shape[2]),
                          same_pad(h.shape[3], stride, w.shape[3]))
    if (pt, pl) != (pb, pr):
        h = F.pad(h, (pl, pr, pt, pb))
        pt = pl = 0
    return F.conv2d(h, w, b, stride=stride, padding=(pt, pl), groups=groups)


def _bn(h, p, s, train: bool):
    """BatchNorm over (B, H, W) of h (B, N*C, H, W), as the reference's
    ``_bn``: batch mean and population variance (ddof 0) in training,
    whose running update is ``0.9 old + 0.1 batch`` (detached); the
    running statistics in eval. Returns (y, new state of (N, C) leaves)."""
    def ch(t):
        return t.reshape(1, -1, 1, 1)
    if train:
        mu = h.mean((0, 2, 3))
        var = (h - ch(mu)).square().mean((0, 2, 3))
        shape = s["mean"].shape
        new_s = {"mean": BN_MOMENTUM * s["mean"]
                 + (1 - BN_MOMENTUM) * mu.detach().reshape(shape),
                 "var": BN_MOMENTUM * s["var"]
                 + (1 - BN_MOMENTUM) * var.detach().reshape(shape)}
    else:
        mu, var = s["mean"].reshape(-1), s["var"].reshape(-1)
        new_s = s
    y = (h - ch(mu)) * ch(torch.rsqrt(var + BN_EPS))
    return y * ch(p["bn_scale"]) + ch(p["bn_bias"]), new_s


def _lead(tree, fn):
    return {k: _lead(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def cnn_apply(params, state, x, train: bool = True):
    """x (B, 32, 32, 3) NHWC -> (logits (B, 10), new_state). Leaves and
    BatchNorm state stacked over N clients take x (N, B, 32, 32, 3) and
    give logits (N, B, 10) and a state of (N, C) leaves, every layer one
    launch for all clients."""
    stacked = params["conv0"]["w"].ndim == 5
    if not stacked:
        logits, new_state = cnn_apply(
            _lead(params, lambda t: t.unsqueeze(0)),
            _lead(state, lambda t: t.unsqueeze(0)), x.unsqueeze(0), train)
        return logits[0], _lead(new_state, lambda t: t[0])
    n, B = x.shape[:2]
    # (N, B, H, W, C) -> (B, N*C, H, W): client i owns channel group i
    h = x.permute(1, 0, 4, 2, 3).reshape(B, n * x.shape[-1], *x.shape[2:4])
    new_state = {}
    for i, (ci, co, stride) in enumerate(CONVS):
        p = params[f"conv{i}"]
        # HWIO (N, 3, 3, ci, co) -> OIHW (N*co, ci, 3, 3)
        w = p["w"].permute(0, 4, 3, 1, 2).reshape(n * co, ci, 3, 3)
        h = conv2d_same(h, w, p["b"].reshape(-1), stride, groups=n)
        h, new_state[f"conv{i}"] = _bn(h, p, state[f"conv{i}"], train)
        h = torch.relu(h)
        if i == 0:
            h = F.max_pool2d(h, 2, 2)
    # (B, N*C, H, W) -> (N, B, H*W*C): the reference flattens NHWC
    h = h.reshape(B, n, -1, *h.shape[2:]).permute(1, 0, 3, 4, 2)
    h = h.reshape(n, B, -1)
    for j in range(len(FCS)):
        p = params[f"fc{j}"]
        h = h @ p["w"] + p["b"].unsqueeze(-2)
        if j < len(FCS) - 1:
            h = torch.relu(h)
    return h, new_state


def param_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    return int(tree.numel())
