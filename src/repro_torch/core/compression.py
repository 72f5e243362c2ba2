"""Uplink byte accounting: the port's copy of ``bytes_per_index``,
``value_bytes_of`` and ``bytes_per_round`` from
``repro.core.compression``."""
from __future__ import annotations

import math

import numpy as np

_WIRE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
               "int8": 1, "uint8": 1}


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
