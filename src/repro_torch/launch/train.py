"""LM training driver with the rAge-k gradient exchange (the paper's
protocol as a data-parallel collective): the port of
``repro.launch.train``, with its flags, defaults and printed lines.

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 20 \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --steps 10   # card

Without ``--smoke`` the arch runs at full size (internlm2-1.8b: 24
layers, 1,699,842,048 parameters in bfloat16). ``--arch`` takes the dense,
MoE, SSM (mamba2-780m) and hybrid (zamba2-2.7b) ids; an MoE arch's loss
carries 0.01 * its load-balance term, and the SSM layers' float32
``A_log``, ``D``, ``dt_bias`` and ``gate_norm`` are buckets of their own
dtype beside the bfloat16 ones. The VLM (pixtral-12b) and audio
(whisper-large-v3) archs are refused before a device is touched: their
losses read ``embeds`` and ``frames``, which the token stream does not
make, so the reference's CLI stops on them with a ``KeyError`` (ROADMAP
queue 3, fault 9); ``models.registry.concrete_batch`` makes their
batches for ``loss_fn`` and ``make_sync_train_step``. Weights are random
from seed 0, the tokens ``data.token_stream``'s from seed 1. Without
``--device`` it runs on the card and raises without one. ``main(argv)``
returns the losses of every step and the summed wire bytes.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data.pipeline import token_stream
from repro_torch.device import resolve
from repro_torch.dist.sparse_sync import init_age_state, make_sync_train_step
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import adam
from repro_torch.tree import leaves


def to_device(batch: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--method", choices=("rage_k", "dense"), default="rage_k")
    ap.add_argument("--r", type=int, default=2048)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    T.require_lm(cfg)
    if cfg.family in ("vlm", "audio"):
        raise ValueError(
            f"{cfg.name}: the {cfg.family} family's loss reads "
            f"{'embeds' if cfg.family == 'vlm' else 'frames'}, which the "
            f"token stream does not make (the reference's CLI stops there "
            f"with a KeyError: ROADMAP queue 3, fault 9)")
    cfg = cfg.replace(remat=False)
    dev = resolve(args.device)
    mesh = make_host_mesh(args.data_axis, 1, device=dev)

    params = T.init(cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    n_params = sum(p.numel() for p in leaves(params))
    print(f"arch={cfg.name} params={n_params:,} method={args.method}")

    opt = adam(args.lr)
    opt_state = opt.init(params)
    ages = init_age_state(params)

    def loss_fn(p, batch):
        return T.loss_fn(p, cfg, batch)[0]

    step = make_sync_train_step(loss_fn, opt, mesh, method=args.method,
                                r=args.r, k=args.k)
    stream = token_stream(cfg.vocab_size, args.batch, args.seq, seed=1)
    losses = []
    wire = 0
    t0 = time.time()
    for i in range(1, args.steps + 1):
        batch = to_device(next(stream), dev)
        params, opt_state, ages, loss, stats = step(params, opt_state, ages,
                                                    batch)
        losses.append(loss)
        wire += stats["wire_bytes_per_shard"]
        if i % args.log_every == 0 or i == args.steps:
            dt = time.time() - t0
            print(f"step {i:5d} loss={float(loss):.4f} "
                  f"steps/s={i / dt:.2f} wire={wire/2**20:.2f}MiB/shard")
    if args.ckpt:
        from repro_torch.checkpoint import save_checkpoint
        save_checkpoint(args.ckpt, args.steps, params)
        print(f"saved checkpoint to {args.ckpt}")
    return {"losses": [float(x) for x in losses], "wire_bytes": wire,
            "params": params}


if __name__ == "__main__":
    main()
