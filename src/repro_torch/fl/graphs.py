"""CUDA graphs of one body, one per key: the capture protocol that the
engine's rounds and the service's events share.

A body is a function of no arguments that updates a fixed set of device
buffers in place and returns a pair of device metric vectors. A graph
bakes in the addresses and shapes of those buffers, so each key names
what can change between graphs (the age rows, the packing bounds), and
every graph is dropped when a buffer is replaced. The graphs replay one
at a time and share one memory pool, which goes with the last of them.
"""
from __future__ import annotations

import gc
import time

import torch

from repro_torch.kernels import build


class GraphCache(dict):
    """key -> (graph, launch tally, outputs) of a body on ``device``.
    ``generators`` are registered with each graph, so that each replay
    draws anew. ``capture_s`` is the host wall of the captures.

    Freeing a graph in the middle of another's capture invalidates the
    capture. So the body is passed to each call, not kept (a cache that
    held its owner's bound method would put the owner in a reference
    cycle, which the collector frees at any time), and the collector is
    off while a capture runs."""

    def __init__(self, device: torch.device, generators=()):
        super().__init__()
        self.device = device
        self.generators = tuple(generators)
        self.capture_s = 0.0
        self._pool = None
        self._stream = None

    def drop(self):
        """Forget every graph: they read the addresses of buffers about to
        be replaced. Their memory pool goes with them, so the next
        capture starts a new one."""
        if self and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.clear()
        self._pool = None

    def _capture(self, body, key):
        """Run the body once eagerly on the capture stream (a real run,
        which warms up the libraries' handles, workspaces and
        algorithms), then capture it as the graph for ``key``, the
        kernels' launches counted into the graph's tally. Returns the
        eager run's outputs. A failed capture raises."""
        t0 = time.perf_counter()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        stream, current = self._stream, torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = body()
        current.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        collect = gc.isenabled()
        gc.disable()
        try:
            with build.capturing() as tally, torch.cuda.graph(
                    graph, pool=self._pool, stream=stream):
                outs = body()
        finally:
            if collect:
                gc.enable()
        self[key] = (graph, dict(tally), outs)
        self.capture_s += time.perf_counter() - t0
        return out

    def chunk(self, body, key, n: int, *, eager: bool = False):
        """``n`` runs of ``body`` with no host sync: on the card each one
        replay of the graph for ``key`` (captured at its first use;
        ``eager`` runs the body instead), on the CPU the body. Returns
        the runs' metric vectors stacked on the device, (n, F) and (n, I)."""
        stacks = None
        for j in range(n):
            if self.device.type != "cuda" or eager:
                f, i = body()
            elif key not in self:
                f, i = self._capture(body, key)
            else:
                graph, tally, (f, i) = self[key]
                graph.replay()
                build.replayed(tally)
            if stacks is None:
                stacks = (f.new_empty((n, f.numel())),
                          i.new_empty((n, i.numel())))
            stacks[0][j].copy_(f)
            stacks[1][j].copy_(i)
        return stacks
