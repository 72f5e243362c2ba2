#!/usr/bin/env python3
"""The LM training step's peak memory on the card beside the dry run's
count of the same step.

The step is ``launch.steps.make_train_step`` (Adam, two microbatches) on
internlm2-1.8b at full width (d 2,048, d_ff 8,192, vocab 92,544) cut to
``LAYERS`` layers, in bfloat16 from random weights, on a batch of 8 x
1,024 tokens, with ``remat`` on and off:

    python3 train_memory.py                 # on the card
    python3 train_memory.py --dry           # on the CPU, no card
    python3 train_memory.py --probe ARCH    # on the CPU, no card

On the card each step's peak is ``torch.cuda.max_memory_allocated`` over
the step, less what was allocated before the parameters, the Adam state
and the batch were made; one untimed step first makes the process's
one-time allocations (cuBLAS's workspaces), so that no measured step
holds them. The dry run's is ``launch.dryrun``'s tracker peak over the
same step on a fake (1, 1) mesh (``host_mesh_trace``): its arguments and
every tensor the step makes, freed where the step frees it. Each run
prints one JSON line, ``{"card" or "dry": {"peak": {remat: {layers:
bytes}}, "per_layer": {remat: bytes}}}``, the growth a layer between
the first and the last layer count. ``--probe`` prints the dry run's
memory a device (``per_device_total``) of ARCH at full width x train_4k
x 16x16 at 1, 2 and 3 layers (units of ``attn_every`` layers for a
hybrid), as ``{ARCH: {"layers": bytes}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
ARCH = "internlm2-1.8b"
LAYERS = (2, 4)
BATCH, SEQ, ACCUM = 8, 1024, 2


def step_config(layers: int, remat: bool):
    """(cfg, shape): the full-width config at ``layers`` layers and the
    8 x 1,024 training shape, taken in ``ACCUM`` microbatches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape

    shape = InputShape("train_mem", SEQ, BATCH, "train")
    cfg = get_config(ARCH).replace(n_layers=layers, remat=remat,
                                   grad_accum={shape.name: ACCUM})
    return cfg, shape


def _per_layer(peak: dict) -> dict:
    lo, hi = LAYERS[0], LAYERS[-1]
    return {k: (v[hi] - v[lo]) / (hi - lo) for k, v in peak.items()}


def _real_step(torch, dev, layers: int, remat: bool) -> int:
    """One step's peak bytes on ``dev`` above what was allocated before
    its parameters, Adam state and batch were made."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import adam

    cfg, shape = step_config(layers, remat)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init(cfg, gen, device=dev)
    state = adam(1e-4).init(params)
    batch = R.concrete_batch(cfg, shape, gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()    # the init's temporaries
    out = make_train_step(cfg, shape)(params, state, batch)
    if not bool(torch.isfinite(out[2])):
        raise AssertionError(f"train_memory: loss {out[2]}")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del params, state, batch, out
    torch.cuda.empty_cache()
    return peak


def real_peaks(torch, dev) -> dict:
    """Each (remat, layers) step's peak bytes on ``dev`` (a card), after
    one untimed step."""
    _real_step(torch, dev, LAYERS[0], True)
    peak = {}
    for remat in (True, False):
        row = peak.setdefault("remat" if remat else "no remat", {})
        for layers in LAYERS:
            row[layers] = _real_step(torch, dev, layers, remat)
    return {"peak": peak, "per_layer": _per_layer(peak)}


def dry_peaks() -> dict:
    """The dry run's peak bytes of the same steps (on the CPU)."""
    from repro_torch.launch import dryrun as D

    peak = {}
    for remat in (True, False):
        row = peak.setdefault("remat" if remat else "no remat", {})
        for layers in LAYERS:
            cfg, shape = step_config(layers, remat)
            rec = D.host_mesh_trace(cfg, shape, 1, 1, memory=True)
            row[layers] = rec["memory"]["peak_bytes"]
    return {"peak": peak, "per_layer": _per_layer(peak)}


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
