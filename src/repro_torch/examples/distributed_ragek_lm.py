"""rAge-k as a distributed-training collective: train internlm2-1.8b's
smoke config where each step exchanges only k sparse gradient entries a
bucket instead of a dense all-reduce, against the dense exchange on the
same stream. The port of the reference's
``examples/distributed_ragek_lm.py``.

  PYTHONPATH=src python -m repro_torch.examples.distributed_ragek_lm \
      --steps 60 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import token_stream
from repro_torch.device import resolve
from repro_torch.dist.sparse_sync import init_age_state, make_sync_train_step
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import to_device
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import adam
from repro_torch.tree import leaves


def run(method: str, steps: int, r: int, k: int, device=None) -> dict:
    """``steps`` steps of one method from seed 0's weights; prints the
    reference's line and returns the final loss and the wire bytes."""
    dev = resolve(device)
    cfg = get_smoke_config("internlm2-1.8b").replace(remat=False)
    mesh = make_host_mesh(1, 1, device=dev)
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    opt = adam(1e-3)
    opt_state = opt.init(params)
    ages = init_age_state(params)

    def loss_fn(p, batch):
        return T.loss_fn(p, cfg, batch)[0]

    step = make_sync_train_step(loss_fn, opt, mesh, method=method, r=r, k=k)
    stream = token_stream(cfg.vocab_size, 8, 128, seed=1)
    wire, loss = 0, None
    t0 = time.time()
    for _ in range(steps):
        params, opt_state, ages, loss, stats = step(
            params, opt_state, ages, to_device(next(stream), dev))
        wire += stats["wire_bytes_per_shard"]
    n_params = sum(p.numel() for p in leaves(params))
    dense_wire = steps * n_params * 2
    print(f"[{method:7s}] final loss={float(loss):.4f} "
          f"wire={wire/2**20:.2f} MiB "
          f"(dense would be {dense_wire/2**20:.0f} MiB) "
          f"wall={time.time()-t0:.1f}s")
    return {"loss": float(loss), "wire_bytes": wire}


def main(argv=None) -> dict:
    """Runs rAge-k, then dense; returns {method: run's result}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--r", type=int, default=4096)
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    return {m: run(m, args.steps, args.r, args.k, args.device)
            for m in ("rage_k", "dense")}


if __name__ == "__main__":
    main()
