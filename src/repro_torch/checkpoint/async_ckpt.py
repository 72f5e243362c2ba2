"""Async checkpointer, snapshot on the caller and write on a worker: the
port's copy of ``repro.checkpoint.async_ckpt``.

1. :meth:`AsyncCheckpointer.save` pins the tree on the calling thread: a
   tensor on the card is copied into pinned host memory without
   blocking, behind one event that marks the copies done; a host tensor
   or array is copied. Later work on the device, which updates the
   state in place, does not reach the snapshot. Then the snapshot goes
   to a one-worker executor and ``save`` returns.
2. The worker waits for the event, writes the entry atomically
   (``checkpoint.io``) and prunes to ``keep`` entries.

At most one write is in flight: a second ``save`` joins the first. A
worker's exception is re-raised at the next ``save``, ``wait`` or
``close``.
"""
from __future__ import annotations

import concurrent.futures as _fut
import threading

import numpy as np
import torch

from repro_torch.checkpoint.io import (_children, _like, list_checkpoints,
                                       load_checkpoint, prune_checkpoints,
                                       save_checkpoint)


def _pin(tree, cuda: list):
    """A host copy of ``tree`` of the same structure; ``cuda`` collects
    whether any copy left the card asynchronously."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        if isinstance(tree, torch.Tensor):
            if tree.is_cuda:
                host = torch.empty(tree.shape, dtype=tree.dtype,
                                   pin_memory=True)
                host.copy_(tree, non_blocking=True)
                cuda.append(True)
                return host
            return tree.detach().clone()
        return np.array(tree)
    return _like(tree, [_pin(c, cuda) for _, c in kids])


class AsyncCheckpointer:
    """Atomic keep-last-K checkpoint writer with a worker thread;
    ``blocking=True`` writes on the calling thread instead (the same
    files)."""

    def __init__(self, path: str, keep: int = 3, blocking: bool = False):
        self.path = path
        self.keep = int(keep)
        self.blocking = bool(blocking)
        self._pool = (None if blocking else _fut.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt"))
        self._pending: _fut.Future | None = None
        self._lock = threading.Lock()
        self.saves = 0

    def _write(self, step: int, host_tree, ready, extra):
        if ready is not None:
            ready.synchronize()
        save_checkpoint(self.path, step, host_tree, extra=extra)
        if self.keep > 0:
            prune_checkpoints(self.path, self.keep)

    def save(self, step: int, tree, extra: dict | None = None):
        """Snapshot ``tree`` now; write it in the background."""
        self.wait()
        cuda: list = []
        host_tree = _pin(tree, cuda)
        ready = None
        if cuda:
            ready = torch.cuda.Event()
            ready.record()
        self.saves += 1
        if self._pool is None:
            self._write(step, host_tree, ready, extra)
        else:
            with self._lock:
                self._pending = self._pool.submit(
                    self._write, step, host_tree, ready, extra)

    def wait(self):
        """Block until the write in flight, if any, lands; re-raise its
        exception here."""
        with self._lock:
            fut, self._pending = self._pending, None
        if fut is not None:
            fut.result()

    def close(self):
        try:
            self.wait()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def latest_step(self) -> int | None:
        steps = list_checkpoints(self.path)
        return steps[-1] if steps else None

    def load_latest(self, like):
        """(tree, meta) of the newest good entry, or None if none reads."""
        try:
            return load_checkpoint(self.path, like)
        except FileNotFoundError:
            return None
