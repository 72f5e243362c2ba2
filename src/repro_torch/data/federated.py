"""Non-i.i.d. federated splits: the port's numpy copy of
``repro.data.federated`` for the paper's MNIST layout (10 clients, each
holding two labels; clients 2i and 2i+1 share the same label pair)."""
from __future__ import annotations

import numpy as np


def label_partition(x, y, client_labels: list[list[int]], *, seed: int = 0):
    """Split (x, y) into one shard per client by label lists; samples of a
    label shared by several clients are split evenly among them."""
    rng = np.random.default_rng(seed)
    n_clients = len(client_labels)
    owners: dict[int, list[int]] = {}
    for c, labels in enumerate(client_labels):
        for l in labels:
            owners.setdefault(l, []).append(c)
    shards: list[list[int]] = [[] for _ in range(n_clients)]
    for l, cs in owners.items():
        idx = np.where(y == l)[0]
        rng.shuffle(idx)
        for j, part in enumerate(np.array_split(idx, len(cs))):
            shards[cs[j]].extend(part.tolist())
    out = []
    for c in range(n_clients):
        sel = np.array(sorted(shards[c]))
        out.append((x[sel], y[sel]))
    return out


PAPER_MNIST_LABELS = [[0, 1], [0, 1], [2, 3], [2, 3], [4, 5], [4, 5],
                      [6, 7], [6, 7], [8, 9], [8, 9]]


def paper_mnist_split(x, y, seed: int = 0):
    return label_partition(x, y, PAPER_MNIST_LABELS, seed=seed)
