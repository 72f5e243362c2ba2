"""Serving driver: batched prefill + decode with a KV cache, the port of
``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --batch 2 --prompt-len 8 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve   # internlm2-1.8b, card

Weights are random from seed 0 (no checkpoints are in the repository).
Without ``--device`` it runs on the card and raises without one.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.device import resolve
from repro_torch.models import transformer as T


@dataclass
class Generation:
    tokens: torch.Tensor         # (B, gen) generated token ids
    logits: torch.Tensor         # (B, Vp) float32 logits of the last step
    finite: bool                 # every step's logits were finite
    prefill_s: float             # host seconds of the prompt's steps
    decode_s: float              # host seconds of the generated steps


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(params, cfg, prompts: torch.Tensor, gen: int, *,
             temperature: float = 0.0,
             generator: torch.Generator | None = None) -> Generation:
    """Feed ``prompts`` (B, P) through P decode steps (prefill by decode
    steps, as the reference's serve loop does), then generate ``gen``
    tokens: greedy argmax at temperature 0, else a draw from
    softmax(logits / temperature) with ``generator``. The cache holds
    P + gen positions on the prompts' device."""
    B, P = prompts.shape
    dev = prompts.device
    cache = T.init_cache(cfg, B, P + gen, device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for t in range(P):
        logits, cache = T.decode_step(params, cfg, {"token": prompts[:, t]},
                                      cache, t)
        finite &= torch.isfinite(logits).all()
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    toks = []
    t0 = time.perf_counter()
    cur = torch.argmax(logits, -1)
    for t in range(P, P + gen):
        toks.append(cur)
        logits, cache = T.decode_step(params, cfg, {"token": cur}, cache, t)
        finite &= torch.isfinite(logits).all()
        if temperature > 0:
            probs = torch.softmax(logits / temperature, -1)
            cur = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            cur = torch.argmax(logits, -1)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return Generation(torch.stack(toks, 1), logits, bool(finite), t_prefill,
                      t_decode)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(remat=False)
    dev = resolve(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init(cfg, gen, device=dev)
    B, P = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device=dev)
    out = generate(params, cfg, prompts, args.gen,
                   temperature=args.temperature, generator=gen)
    print(f"arch={cfg.name} batch={B} prefill={out.prefill_s:.2f}s "
          f"decode={args.gen / out.decode_s:.1f} tok/s/batch")
    print("generated token ids (first row):", out.tokens[0].tolist())


if __name__ == "__main__":
    main()
