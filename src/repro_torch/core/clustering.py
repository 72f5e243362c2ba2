"""Client clustering (paper §II eq. 3 + DBSCAN): the port's numpy copy of
``repro.core.clustering``.

The eq.-(3) input is the (N, d) request-frequency matrix. Under the dense
age layout it lives on the device and comes down whole every M rounds;
under the hierarchical layout the device keeps a ring of the per-round
requested indices and the host rebuilds the same matrix with
:func:`fold_request_log`."""
from __future__ import annotations

import numpy as np


def fold_request_log(freq: np.ndarray, members: np.ndarray,
                     indices: np.ndarray, *, n_clients: int,
                     d: int) -> np.ndarray:
    """Fold drained request-log slots into the cumulative (N, d) frequency
    matrix. ``members`` (..., m) int32 requesting client ids, sentinel
    ``n_clients`` for padded slots; ``indices`` (..., m, k) int32
    requested coordinates, sentinel ``d`` for no request. Every pair below
    the sentinels counts one request, as the dense layout's device
    scatter does. Mutates and returns ``freq``."""
    mem = np.asarray(members).reshape(-1)
    idx = np.asarray(indices).reshape(mem.shape[0], -1)
    ok = mem < n_clients
    rows = np.repeat(mem[ok], idx.shape[1])
    cols = idx[ok].reshape(-1)
    keep = cols < d
    np.add.at(freq, (rows[keep], cols[keep]), 1)
    return freq


def similarity_matrix(freq: np.ndarray) -> np.ndarray:
    """Eq. (3): d[i1, i2] = <f[i1], f[i2]> / <f[i1], f[i1]>. Zero-norm
    rows give 0 rows."""
    g = freq.astype(np.float64) @ freq.T.astype(np.float64)
    diag = np.diag(g).copy()
    diag[diag == 0] = 1.0
    return g / diag[:, None]


def connectivity_matrix(freq: np.ndarray) -> np.ndarray:
    """Symmetrized, [0,1]-clipped similarity (the paper's heatmap)."""
    d = similarity_matrix(freq)
    s = (d + d.T) / 2.0
    return np.clip(s, 0.0, 1.0)


def dbscan(dist: np.ndarray, eps: float, min_pts: int) -> np.ndarray:
    """DBSCAN on a precomputed distance matrix. Returns labels (noise=-1)."""
    n = dist.shape[0]
    labels = np.full(n, -2, np.int64)          # -2 = unvisited
    neighbors = [np.where(dist[i] <= eps)[0] for i in range(n)]
    core = np.array([len(nb) >= min_pts for nb in neighbors])
    cid = 0
    for i in range(n):
        if labels[i] != -2:
            continue
        if not core[i]:
            labels[i] = -1
            continue
        labels[i] = cid
        stack = list(neighbors[i])
        while stack:
            j = stack.pop()
            if labels[j] == -1:
                labels[j] = cid                # border point
            if labels[j] != -2:
                continue
            labels[j] = cid
            if core[j]:
                stack.extend(neighbors[j])
        cid += 1
    labels[labels == -2] = -1
    return labels


def cluster_clients(freq: np.ndarray, eps: float, min_pts: int) -> np.ndarray:
    """Eq. (3) -> symmetrize -> DBSCAN. Returns labels."""
    dist = 1.0 - connectivity_matrix(freq)
    np.fill_diagonal(dist, 0.0)
    return dbscan(dist, eps, min_pts)
