"""Procedural MNIST and CIFAR10 stand-ins: the port's numpy copy of
``repro.data.synthetic`` (``make_image_dataset``, ``mnist_like``,
``cifar10_like``), draw for draw the same arrays from the same seed.

Each class c has a fixed random prototype image; a sample is
``prototype[c] * (1 - noise) + noise * N(0,1)`` plus a small random
translation.
"""
from __future__ import annotations

import numpy as np


def make_image_dataset(n: int, shape: tuple, n_classes: int, *, seed: int,
                       noise: float = 0.35, shift: int = 2,
                       proto_seed: int | None = None):
    """Returns (x (n, *shape) float32, y (n,) int64). ``proto_seed`` fixes
    the class prototypes independently of the sample seed, so train and
    test splits share the same classes."""
    rng = np.random.default_rng(seed)
    proto_rng = np.random.default_rng(seed if proto_seed is None else proto_seed)
    protos = proto_rng.normal(0, 1, (n_classes,) + shape).astype(np.float32)
    for axis in (0, 1):
        protos = 0.5 * protos + 0.25 * (np.roll(protos, 1, axis=1 + axis)
                                        + np.roll(protos, -1, axis=1 + axis))
    # only a central "stroke" region of each prototype carries signal
    hh, ww = shape[0], shape[1]
    yy, xx = np.meshgrid(np.arange(hh), np.arange(ww), indexing="ij")
    cy = proto_rng.uniform(hh * 0.3, hh * 0.7, n_classes)
    cx = proto_rng.uniform(ww * 0.3, ww * 0.7, n_classes)
    r2 = (hh * 0.30) ** 2
    mask = np.stack([((yy - cy[c]) ** 2 + (xx - cx[c]) ** 2 < r2)
                     for c in range(n_classes)]).astype(np.float32)
    protos = protos * mask[..., None] * 2.0
    y = rng.integers(0, n_classes, n)
    eps = rng.normal(0, 1, (n,) + shape).astype(np.float32)
    x = protos[y] * (1 - noise) + noise * eps
    if shift:
        dx = rng.integers(-shift, shift + 1, n)
        dy = rng.integers(-shift, shift + 1, n)
        for i in range(n):
            x[i] = np.roll(np.roll(x[i], dx[i], axis=0), dy[i], axis=1)
    return x, y.astype(np.int64)


def mnist_like(n_train: int = 60_000, n_test: int = 10_000, seed: int = 0):
    """28x28x1, 10 classes: the paper's MNIST stand-in."""
    xtr, ytr = make_image_dataset(n_train, (28, 28, 1), 10, seed=seed,
                                  proto_seed=seed)
    xte, yte = make_image_dataset(n_test, (28, 28, 1), 10, seed=seed + 1,
                                  proto_seed=seed)
    return (xtr, ytr), (xte, yte)


def cifar10_like(n_train: int = 50_000, n_test: int = 10_000, seed: int = 0):
    """32x32x3, 10 classes: the paper's CIFAR10 stand-in."""
    xtr, ytr = make_image_dataset(n_train, (32, 32, 3), 10, seed=seed,
                                  proto_seed=seed)
    xte, yte = make_image_dataset(n_test, (32, 32, 3), 10, seed=seed + 1,
                                  proto_seed=seed)
    return (xtr, ytr), (xte, yte)
