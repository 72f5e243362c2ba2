"""The persistent autotune registry of the kernels' launch choices: the
port of ``repro.kernels.autotune``.

The CUDA kernels take some launch choices on the host at run time:
``decode_attention``'s tile and split count (``decode_attention.
choose_splits``) and ``maghist_batch``'s elements a block, which the
candidate report's two launches share (``maghist.chunk_for``, the least
that keeps a row within ``MAX_PARTS`` blocks). Their rules are a guess for
one card. This registry keeps the best choice per ``(kernel, shape, dtype,
backend)`` key in a JSON file, so that

* :func:`sweep` times candidate choices with a caller's timer (on the
  card; ``chip_smoke.py`` phase 13 runs one) and records the winner;
* the launchers consult :func:`lookup` before their own rule, falling
  back to the nearest recorded shape of the same kernel, dtype and
  backend, and to the rule when there is none. ``maghist_batch`` records
  its choice as the blocks a row (``parts``), which carries over to other
  widths; ``decode_attention``'s split count belongs to its position
  count, so its launcher takes exact matches alone.

Key scheme: ``"<kernel>|<d0>x<d1>...|<dtype>|<backend>"``, the reference's;
the backend is ``cuda:sm_90a`` (:data:`CARD`), the kernels' target: the
plain paths take no launch choice and consult nothing. Entries store
``{"shape", "config", "us"}``,
the time in microseconds from the card; the nearest match minimizes
``|log(numel / numel_q)|``. A missing or corrupt file is an empty
registry.

The JSON defaults to ``AUTOTUNE.json`` beside this module (the port's
own; the reference's ``experiments/bench/AUTOTUNE.json`` is never read or
written) and can be moved with ``REPRO_TORCH_AUTOTUNE_PATH`` or
:func:`set_path`.
"""
from __future__ import annotations

import json
import math
import os
import threading

_DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "AUTOTUNE.json")
ENV = "REPRO_TORCH_AUTOTUNE_PATH"
CARD = "cuda:sm_90a"

_lock = threading.Lock()
_path_override: str | None = None
_cache: dict | None = None
_stats = {"hits": 0, "misses": 0}
# bumped whenever the registry's contents may change: launchers that
# memoize their lookups compare it
version = 0


def path() -> str:
    return _path_override or os.environ.get(ENV) or _DEFAULT_PATH


def set_path(p: str | None) -> None:
    """Point the registry at another JSON file (tests, sweeps); None
    restores the default. Drops the in-memory copy."""
    global _path_override, _cache, version
    with _lock:
        _path_override = p
        _cache = None
        version += 1


def clear_cache() -> None:
    global _cache, version
    with _lock:
        _cache = None
        version += 1


def load(refresh: bool = False) -> dict:
    """The registry dict, read once per process (a missing or corrupt file
    is an empty registry, never an error)."""
    global _cache
    with _lock:
        if _cache is None or refresh:
            try:
                with open(path()) as f:
                    _cache = json.load(f)
                if not isinstance(_cache, dict):
                    _cache = {}
            except (OSError, ValueError):
                _cache = {}
        return _cache


def key_of(kernel: str, shape, dtype: str, backend: str) -> str:
    return (f"{kernel}|{'x'.join(str(int(s)) for s in shape)}"
            f"|{dtype}|{backend}")


def lookup(kernel: str, shape, dtype: str, backend: str, *,
           nearest: bool = True) -> dict | None:
    """Best known config for the key: the exact shape first, else (with
    ``nearest``) the nearest-numel recorded shape of the same kernel, dtype
    and backend, else None (the caller's own rule)."""
    reg = load()
    hit = reg.get(key_of(kernel, shape, dtype, backend))
    if hit is not None:
        _stats["hits"] += 1
        return dict(hit["config"])
    if not nearest:
        _stats["misses"] += 1
        return None
    numel = max(1, math.prod(int(s) for s in shape))
    prefix, suffix = f"{kernel}|", f"|{dtype}|{backend}"
    best, best_dist = None, float("inf")
    for k, v in reg.items():
        if not (k.startswith(prefix) and k.endswith(suffix)):
            continue
        cand = max(1, math.prod(int(s) for s in v.get("shape", [1])))
        dist = abs(math.log(cand / numel))
        if dist < best_dist:
            best, best_dist = v, dist
    if best is not None:
        _stats["hits"] += 1
        return dict(best["config"])
    _stats["misses"] += 1
    return None


def record(kernel: str, shape, dtype: str, backend: str,
           config: dict, us: float) -> str:
    """Insert or overwrite the entry and write the registry's JSON.
    Returns the key."""
    global version
    reg = load()
    key = key_of(kernel, shape, dtype, backend)
    with _lock:
        reg[key] = {"shape": [int(s) for s in shape],
                    "config": dict(config), "us": float(us)}
        p = path()
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        with open(p, "w") as f:
            json.dump(reg, f, indent=1, sort_keys=True)
        version += 1
    return key


def sweep(kernel: str, shape, dtype: str, backend: str,
          configs: list, timer) -> tuple[dict, list]:
    """Time every candidate config with ``timer(**config) -> us``, record
    the winner, and return ``(best_config, results)``, results
    ``[{**config, "us": ...}, ...]``."""
    results = []
    best_cfg, best_us = None, float("inf")
    for cfg in configs:
        us = float(timer(**cfg))
        results.append({**cfg, "us": us})
        if us < best_us:
            best_cfg, best_us = dict(cfg), us
    if best_cfg is not None:
        record(kernel, shape, dtype, backend, best_cfg, best_us)
    return best_cfg, results


def stats() -> dict:
    return dict(_stats)


def reset_stats() -> None:
    _stats["hits"] = _stats["misses"] = 0
