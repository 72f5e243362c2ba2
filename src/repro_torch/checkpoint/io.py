"""Checkpoints: a tree of arrays <-> ``.npz`` with path-keyed entries, the
port's copy of ``repro.checkpoint.io`` in the same on-disk layout.

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
tensors or numpy arrays (None is no leaf). An entry is
``ckpt_{step:08d}.npz`` holding one array per leaf, keyed by the leaf's
path joined with ``/`` (dict keys, NamedTuple field names, sequence
positions), bfloat16 stored as its uint16 bits with a dtype tag, beside
``ckpt_{step:08d}.npz.json``, the meta (step, each key's dtype, and
``extra``).

Each file is written to a ``.tmp`` name in the same directory, fsync'd
and ``os.replace``d into place, the npz first and the meta last: the
meta commits the entry. A crash leaves the previous entry intact and at
worst a ``.tmp`` file that the loader never reads. The loader walks the
committed entries newest first and falls back past any whose meta or
npz does not read; an explicit ``step`` is loaded strictly.
"""
from __future__ import annotations

import json
import os
import re
import zipfile

import numpy as np
import torch

_BF16_TAG = "__bf16__"


def _children(node):
    """(key, child) pairs of an inner node (dict keys, NamedTuple field
    names, sequence positions), or None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _like(node, children: list):
    """A node of ``node``'s kind holding ``children`` (in
    :func:`_children`'s order)."""
    kids = _children(node)
    if isinstance(node, dict):
        return dict(zip([k for k, _ in kids], children))
    if hasattr(node, "_fields"):
        return type(node)(*children)
    return type(node)(children)


def _path(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def _flatten(tree, prefix: str = "") -> dict:
    """Path-keyed leaves of ``tree`` (None skipped)."""
    if tree is None:
        return {}
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    flat = {}
    for key, child in kids:
        flat.update(_flatten(child, _path(prefix, key)))
    return flat


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, its dtype tag)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16_TAG
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            return arr.view(np.uint16), _BF16_TAG
    return arr, str(arr.dtype)


def _replace_atomic(write, final: str):
    """Write via ``write(f)`` to a same-directory temp file, fsync, then
    ``os.replace`` it into place."""
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


def save_checkpoint(path: str, step: int, tree, extra: dict | None = None):
    """Write ``tree`` as the entry for ``step`` under ``path``; returns the
    npz's file name."""
    os.makedirs(path, exist_ok=True)
    arrays, meta = {}, {"step": step, "keys": {}}
    for key, leaf in _flatten(tree).items():
        arrays[key], meta["keys"][key] = _to_numpy(leaf)
    meta["extra"] = extra or {}
    fn = os.path.join(path, f"ckpt_{step:08d}.npz")
    # uncompressed: float state barely compresses, and zlib would cost
    # the writer tens of ms a MB
    _replace_atomic(lambda f: np.savez(f, **arrays), fn)
    _replace_atomic(lambda f: f.write(json.dumps(meta).encode()),
                    fn + ".json")
    return fn


def _read_entry(path: str, step: int):
    """One entry's (meta, {key: array}), every array read here so that
    any corruption raises here."""
    fn = os.path.join(path, f"ckpt_{step:08d}.npz")
    with open(fn + ".json") as f:
        meta = json.load(f)
    with np.load(fn) as data:
        return meta, {key: data[key] for key in data.files}


def _from_numpy(arr: np.ndarray, tag: str, like):
    """A stored array back as a leaf of ``like``'s kind: a CPU tensor where
    ``like`` holds a tensor (and for every bfloat16 leaf), else numpy."""
    if tag == _BF16_TAG:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr))
    return np.array(arr)


def _rebuild(like, flat: dict, prefix: str = ""):
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return flat[prefix]
    return _like(like, [_rebuild(c, flat, _path(prefix, key))
                        for key, c in kids])


def load_checkpoint(path: str, like, step: int | None = None):
    """(tree, meta) restored into the structure of ``like``, each leaf
    with its saved shape and dtype. ``step=None`` takes the newest entry
    that reads, falling back past corrupt or uncommitted ones; an
    explicit ``step`` raises if that entry does not read."""
    steps = list_checkpoints(path)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {path}")
    candidates = [step] if step is not None else steps[::-1]
    meta = data = None
    errors = []
    for s in candidates:
        try:
            meta, data = _read_entry(path, s)
            break
        except (OSError, KeyError, ValueError, zipfile.BadZipFile,
                json.JSONDecodeError) as e:
            if step is not None:
                raise
            errors.append(f"ckpt_{s:08d}: {type(e).__name__}: {e}")
    if meta is None:
        raise FileNotFoundError(
            f"no loadable checkpoint under {path}: {'; '.join(errors)}")
    flat = {key: _from_numpy(data[key], meta["keys"][key], leaf)
            for key, leaf in _flatten(like).items()}
    return _rebuild(like, flat), meta


def list_checkpoints(path: str) -> list[int]:
    """Steps with a committed entry (both the npz and its meta)."""
    if not os.path.isdir(path):
        return []
    names = set(os.listdir(path))
    out = []
    for f in names:
        m = re.fullmatch(r"ckpt_(\d+)\.npz", f)
        if m and f + ".json" in names:
            out.append(int(m.group(1)))
    return sorted(out)


def prune_checkpoints(path: str, keep: int):
    """Delete all but the newest ``keep`` committed entries, and any
    ``.tmp`` left by an interrupted save."""
    steps = list_checkpoints(path)
    for f in os.listdir(path) if os.path.isdir(path) else []:
        if f.endswith(".tmp"):
            try:
                os.remove(os.path.join(path, f))
            except OSError:
                pass
    for s in steps[:-keep] if keep > 0 else []:
        for suffix in (".npz", ".npz.json"):
            try:
                os.remove(os.path.join(path, f"ckpt_{s:08d}{suffix}"))
            except OSError:
                pass
