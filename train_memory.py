#!/usr/bin/env python3
"""The LM training step's peak memory on the card beside the dry run's
count of the same step.

The steps (``STEPS``) are ``launch.steps.make_train_step`` (Adam) at full
width cut to a few layers, in bfloat16 from random weights:
internlm2-1.8b (d 2,048, d_ff 8,192, vocab 92,544) at 2 and 4 layers on
8 x 1,024 tokens in two microbatches, and phi4-mini-3.8b (d 3,072, 24
heads over 8 KV heads, vocab 200,064) at 1 and 2 layers on 2 x 4,096
tokens in one (its flash attention runs 4 KV chunks a row), each with
``remat`` on and off:

    python3 train_memory.py                 # on the card
    python3 train_memory.py --dry           # on the CPU, no card
    python3 train_memory.py --probe ARCH    # on the CPU, no card

On the card each step's peak is ``torch.cuda.max_memory_allocated`` over
the step, less what was allocated before the parameters, the Adam state
and the batch were made; one untimed step first makes the process's
one-time allocations (cuBLAS's workspaces), so that no measured step
holds them. Its ms are a second step's wall time from the first's
outputs, between two synchronizations. A third step of phi4-mini-3.8b at
1 layer with remat (``ATTENTION_PROBE``) reads the card's memory around
the flash attention's backward: the bytes allocated when it starts (what
the layer's recompute left live for it) and the most while it runs,
through identity autograd nodes on its output and on q
(:func:`attention_peak`). The dry run's is ``launch.dryrun``'s tracker
peak over the same step on a fake (1, 1) mesh (``host_mesh_trace``): its
arguments and every tensor the step makes, freed where the step frees
it. Each run prints one JSON line, ``{"card" or "dry": {arch: {"peak":
{remat: {layers: bytes}}, "per_layer": {remat: bytes}[, "ms": {remat:
{layers: ms}}, "attention": {"live": bytes, "peak": bytes}]}}}``, the
growth a layer between the first and the last layer count. ``--probe``
prints the dry run's memory a device (``per_device_total``) of ARCH at
full width x train_4k x 16x16 at 1, 2 and 3 layers (units of
``attn_every`` layers for a hybrid), as ``{ARCH: {"layers": bytes}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# arch: the layer counts, batch x sequence, microbatches and remat settings
STEPS = {
    "internlm2-1.8b": dict(layers=(2, 4), batch=8, seq=1024, accum=2,
                           remat=(True, False)),
    "phi4-mini-3.8b": dict(layers=(1, 2), batch=2, seq=4096, accum=1,
                           remat=(True, False)),
}
# (arch, layers) of the step whose flash attention's backward is read
ATTENTION_PROBE = ("phi4-mini-3.8b", 1)


def _label(remat: bool) -> str:
    return "remat" if remat else "no remat"


def step_config(arch: str, layers: int, remat: bool):
    """(cfg, shape): ``arch``'s full-width config at ``layers`` layers and
    its training shape, taken in its microbatches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape

    st = STEPS[arch]
    shape = InputShape("train_mem", st["seq"], st["batch"], "train")
    cfg = get_config(arch).replace(n_layers=layers, remat=remat,
                                   grad_accum={shape.name: st["accum"]})
    return cfg, shape


def _per_layer(arch: str, peak: dict) -> dict:
    lo, hi = STEPS[arch]["layers"][0], STEPS[arch]["layers"][-1]
    return {k: (v[hi] - v[lo]) / (hi - lo) for k, v in peak.items()}


def _real_step(torch, dev, arch: str, layers: int, remat: bool):
    """(peak bytes, ms): one step's peak on ``dev`` above what was
    allocated before its parameters, Adam state and batch were made, and
    a second step's wall time."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import adam

    cfg, shape = step_config(arch, layers, remat)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init(cfg, gen, device=dev)
    state = adam(1e-4).init(params)
    batch = R.concrete_batch(cfg, shape, gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()    # the init's temporaries
    step = make_train_step(cfg, shape)
    out = step(params, state, batch)
    if not bool(torch.isfinite(out[2])):
        raise AssertionError(f"train_memory: loss {out[2]}")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del params, state
    t0 = time.perf_counter()
    out = step(out[0], out[1], batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(out[2])):
        raise AssertionError(f"train_memory: loss {out[2]}")
    del batch, out
    torch.cuda.empty_cache()
    return peak, ms


def attention_peak(torch, dev, arch: str, layers: int) -> dict:
    """One step of ``arch`` at ``layers`` layers with remat on ``dev``, its
    flash attention read by the card's allocator: {"live": bytes allocated
    when the first layer's attention backward starts, "peak": the most
    while it runs}. The readings come from identity autograd nodes on the
    attention's output (its backward runs just before the attention's)
    and on q (just after); values are unchanged."""
    from repro_torch.models import layers as L

    rec = {}

    class _Mark(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, read):
            ctx.read = read
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            ctx.read()
            return g, None

    def start():
        if "live" not in rec:
            torch.cuda.synchronize()
            rec["live"] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()

    def end():
        if "peak" not in rec:
            torch.cuda.synchronize()
            rec["peak"] = torch.cuda.max_memory_allocated()

    plain = L.flash_attention

    def marked(q, k, v, **kw):
        return _Mark.apply(plain(_Mark.apply(q, end), k, v, **kw), start)

    L.flash_attention = marked
    try:
        _real_step(torch, dev, arch, layers, True)
    finally:
        L.flash_attention = plain
    return rec


def real_peaks(torch, dev) -> dict:
    """Each arch's (remat, layers) steps on ``dev`` (a card): peak bytes
    and ms, after one untimed step."""
    first = next(iter(STEPS))
    _real_step(torch, dev, first, STEPS[first]["layers"][0],
               STEPS[first]["remat"][0])
    rec = {}
    for arch in STEPS:
        peak, ms = {}, {}
        for remat in STEPS[arch]["remat"]:
            for layers in STEPS[arch]["layers"]:
                b, t = _real_step(torch, dev, arch, layers, remat)
                peak.setdefault(_label(remat), {})[layers] = b
                ms.setdefault(_label(remat), {})[layers] = t
        rec[arch] = {"peak": peak, "per_layer": _per_layer(arch, peak),
                     "ms": ms}
        if arch == ATTENTION_PROBE[0]:
            rec[arch]["attention"] = attention_peak(torch, dev,
                                                    *ATTENTION_PROBE)
    return rec


def dry_peaks() -> dict:
    """The dry run's peak bytes of the same steps (on the CPU)."""
    from repro_torch.launch import dryrun as D

    rec = {}
    for arch in STEPS:
        peak = {}
        for remat in STEPS[arch]["remat"]:
            for layers in STEPS[arch]["layers"]:
                cfg, shape = step_config(arch, layers, remat)
                r = D.host_mesh_trace(cfg, shape, 1, 1, memory=True)
                peak.setdefault(_label(remat), {})[layers] = \
                    r["memory"]["peak_bytes"]
        rec[arch] = {"peak": peak, "per_layer": _per_layer(arch, peak)}
    return rec


def probe(arch: str) -> dict:
    """The dry run's memory a device of ``arch`` x train_4k x 16x16 at 1,
    2 and 3 units of layers."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import lower_combo

    full = get_config(arch)
    unit = full.attn_every if full.family == "hybrid" else 1
    out = {}
    for n in (1, 2, 3):
        cfg = full.replace(n_layers=unit * n, **(
            {"encoder_layers": n} if full.is_encoder_decoder else {}))
        with D.fake_group(256):
            lowered, _ = lower_combo(cfg, INPUT_SHAPES["train_4k"],
                                     make_production_mesh(multi_pod=False))
            out[n] = D.trace(lowered)["memory"]["per_device_total"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dry", action="store_true",
                    help="the dry run's count on the CPU, no card")
    ap.add_argument("--probe", metavar="ARCH",
                    help="the dry run's memory a device at 1-3 layers")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if args.probe:
        print(json.dumps({args.probe: probe(args.probe)}), flush=True)
        return 0
    if args.dry:
        rec = dry_peaks()
    else:
        if not torch.cuda.is_available():
            print("train_memory: no CUDA device", file=sys.stderr)
            return 2
        rec = real_peaks(torch, torch.device("cuda"))
    print(json.dumps({"dry" if args.dry else "card": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
