#!/usr/bin/env python3
"""Times one local step of the CIFAR CNN (Network-2) as the port's local
phase runs it, at fig5's shape (6 clients x batch 256, float32, TF32 off,
H 10 steps a call), on one NVIDIA card, beside variants of how its
convolutions are laid out and chosen:

- ``port``: the port's grouped convolution (clients folded into the
  channels, ``groups=6``) on NCHW tensors, ``paper_nets.conv2d_same``;
- ``channels_last``: the same grouped convolution, input and weights in
  channels-last memory format;
- ``per_client``: one convolution per client (6 launches a layer), NCHW;
- ``benchmark``: the port's, with ``torch.backends.cudnn.benchmark`` on;
- ``deterministic``: the port's, with
  ``torch.backends.cudnn.deterministic`` on.

For each, in turns (port first and last): device ms per local step (CUDA
events around the call, the median of 5 calls after 2 warm-up calls),
the largest |G| difference from the port's step on the same inputs, and
the top device operations of one call (``torch.profiler``). Then the
port's step twice more with ``deterministic`` on: whether G comes out
bitwise equal. Run it from the repository root:

    python3 cnn_step.py

It exits 2 without a card.
"""
from __future__ import annotations

import contextlib
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N, B, H = 6, 256, 10


@contextlib.contextmanager
def variant(torch, P, name: str):
    """The port's convolution replaced or its cuDNN flags set, inside."""
    conv = P.conv2d_same
    flags = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)

    def channels_last(h, w, b, stride, groups=1):
        cl = torch.channels_last
        return conv(h.contiguous(memory_format=cl),
                    w.contiguous(memory_format=cl), b, stride, groups)

    def per_client(h, w, b, stride, groups=1):
        return torch.cat([conv(hi, wi, bi, stride) for hi, wi, bi in
                          zip(h.chunk(groups, 1), w.chunk(groups, 0),
                              b.chunk(groups))], 1)

    if name == "channels_last":
        P.conv2d_same = channels_last
    elif name == "per_client":
        P.conv2d_same = per_client
    elif name == "benchmark":
        torch.backends.cudnn.benchmark = True
    elif name == "deterministic":
        torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        P.conv2d_same = conv
        (torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = flags


def top_ops(torch, fn, n: int = 5) -> str:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    us = [getattr(e, "self_device_time_total", 0) for e in rows]
    return "; ".join(f"{u / H / 1e3:.2f} ms x{e.count / H:g} {e.key[:60]}"
                     for u, e in sorted(zip(us, rows), key=lambda t: -t[0])
                     [:n])


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("cnn_step: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.device import strict_fp32
    from repro_torch.fl.engine import FederatedEngine
    from repro_torch.models import paper_nets as P

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}, cuDNN "
          f"{torch.backends.cudnn.version()}", flush=True)
    rng = np.random.default_rng(0)
    # a shard per client, each of B samples: the step's shapes alone matter
    shards = [(rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
               rng.integers(0, 10, B)) for _ in range(N)]
    eng = FederatedEngine("cnn", shards, shards[0], RAgeKConfig(
        r=2500, k=100, H=H, lr=1e-4, batch_size=B), seed=0)
    bx, by, _ = eng._store.draw(eng._data, eng.samp, H)

    def step():
        with strict_fp32():
            return eng._local_phase(eng.params_s, eng.opt_s, eng.state_s,
                                    bx, by)[3]

    def ms_per_step():
        times = []
        for i in range(7):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            step()
            t1.record()
            t1.synchronize()
            if i >= 2:
                times.append(t0.elapsed_time(t1) / H)
        return statistics.median(times)

    ref = step()
    for name in ("port", "channels_last", "per_client", "benchmark",
                 "deterministic", "port"):
        with variant(torch, P, name):
            ms = ms_per_step()
            err = float((step() - ref).abs().max())
            print(f"{name}: {ms:.3f} ms per local step (N {N} x B {B}), "
                  f"max |G - port's G| {err:.3e}; top: "
                  f"{top_ops(torch, step)}", flush=True)
    with variant(torch, P, "deterministic"):
        a, b = step(), step()
    print(f"deterministic: G bitwise equal over two calls "
          f"{torch.equal(a, b)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
