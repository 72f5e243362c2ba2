"""Compression-operator theory (paper §II-A) and wire byte accounting:
the port's numpy copy of ``repro.core.compression``.

A (possibly randomized) Comp_k satisfies
    E ||g - Comp_k(g)||^2 <= (1 - gamma) ||g||^2,  gamma in (0, 1].
rAge-k is such an operator with
    gamma = k / (k + (r - k) * beta + (d - r)),
where beta bounds |g|_(1) / |g|_(r) (largest over r-th largest
magnitude), reducing to k/d at r = k. :func:`beta_of` and
:func:`contraction` take numpy arrays or torch tensors on any device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_WIRE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
               "int8": 1, "uint8": 1}


def _host(g) -> np.ndarray:
    if isinstance(g, torch.Tensor):
        return g.detach().cpu().numpy()
    return np.asarray(g)


def gamma_rage_k(k: int, r: int, d: int, beta: float) -> float:
    assert 1 <= k <= r <= d and beta >= 1.0
    return k / (k + (r - k) * beta + (d - r))


def gamma_top_k(k: int, d: int) -> float:
    return k / d


def beta_of(g, r: int) -> float:
    """Empirical beta: |g|_(1) / |g|_(r) (ratio of 1st to r-th magnitude)."""
    mags = np.sort(np.abs(_host(g)))[::-1]
    denom = mags[r - 1]
    if denom == 0:
        return np.inf
    return float(mags[0] / denom)


def contraction(g, g_sparse) -> float:
    """||g - Comp(g)||^2 / ||g||^2 (must be <= 1 - gamma in expectation)."""
    g = np.asarray(_host(g), np.float64)
    gs = np.asarray(_host(g_sparse), np.float64)
    n = float(np.sum(g * g))
    if n == 0:
        return 0.0
    return float(np.sum((g - gs) ** 2) / n)


def bytes_per_index(d: int) -> int:
    """Bytes needed to address one of d coordinates: ceil(log2(d) / 8)."""
    if d <= 1:
        return 1
    return max(1, math.ceil(math.log2(d) / 8))


def value_bytes_of(wire_dtype: str) -> int:
    """Payload bytes per value for a RAgeKConfig.wire_dtype string."""
    try:
        return _WIRE_BYTES[str(wire_dtype)]
    except KeyError:
        return int(np.dtype(wire_dtype).itemsize)


def bytes_per_round(k: int, d: int, value_bytes: int | None = None,
                    index_bytes: int | None = None, dense: bool = False,
                    wire_dtype: str | None = None,
                    m_active: int | None = None) -> int:
    """Uplink bytes for one client in one global round (values sized by
    ``wire_dtype``, indices by ceil(log2(d)/8)); with ``m_active`` the
    round total for that many participants."""
    if value_bytes is None:
        value_bytes = value_bytes_of(wire_dtype) if wire_dtype else 4
    if dense:
        per_client = d * value_bytes
    else:
        if index_bytes is None:
            index_bytes = bytes_per_index(d)
        per_client = k * (value_bytes + index_bytes)
    if m_active is None:
        return per_client
    if m_active < 0:
        raise ValueError(f"m_active must be >= 0, got {m_active}")
    return m_active * per_client


def downlink_bytes_per_round(n_req: int, d: int,
                             index_bytes: int | None = None,
                             m_active: int | None = None) -> int:
    """PS->client solicitation bytes for one client in one round: the
    ``n_req`` coordinate indices the PS sends (k requested indices in the
    synchronous protocol, the r stalest in the async service's dispatch
    mode). The model broadcast, common to every method, is not counted.
    ``m_active`` gives the round total for that many clients."""
    if n_req < 0:
        raise ValueError(f"n_req must be >= 0, got {n_req}")
    if index_bytes is None:
        index_bytes = bytes_per_index(d)
    per_client = n_req * index_bytes
    if m_active is None:
        return per_client
    if m_active < 0:
        raise ValueError(f"m_active must be >= 0, got {m_active}")
    return m_active * per_client


def clustering_input_bytes(d: int, n_clients: int, *, k: int = 0,
                           M: int = 1, m_active: int | None = None,
                           layout: str = "dense") -> int:
    """Device->host bytes of the every-M clustering input (eq. 3) per
    recluster boundary. ``'dense'``: the whole (N, d) int32 frequency
    matrix, N·d·4 bytes. ``'hierarchical'``: the request log of the
    window, M slots of m participants' k indices and member id, int32:
    M·m·(k+1)·4 bytes. ``m_active`` is the scheduler's participant bound
    (None: every client)."""
    if layout == "dense":
        return n_clients * d * 4
    if layout != "hierarchical":
        raise ValueError(f"layout must be 'dense' or 'hierarchical', "
                         f"got {layout!r}")
    if M < 1 or k < 0:
        raise ValueError(f"need M >= 1 and k >= 0, got M={M}, k={k}")
    m = n_clients if m_active is None else m_active
    if m < 0 or m > n_clients:
        raise ValueError(f"m_active must be in [0, N={n_clients}], "
                         f"got {m_active}")
    return M * m * (k + 1) * 4
