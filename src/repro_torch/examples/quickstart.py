"""Quickstart: the rAge-k mechanism in 60 seconds.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import RAgeKConfig
from repro_torch.core import (ParameterServer, beta_of, contraction,
                              gamma_rage_k, rage_k)
from repro_torch.device import resolve


def main(argv=None) -> np.ndarray:
    """Prints the three parts; returns the PS's cluster labels."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    d, r, k = 64, 16, 4

    # --- Algorithm 2 on one gradient --------------------------------------
    g = torch.randn(d, generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    age = torch.zeros(d, dtype=torch.int32, device=dev)
    print("== rAge-k (Algorithm 2) ==")
    for t in range(3):
        sparse, idx, age = rage_k(g, age, r=r, k=k)
        print(f"round {t}: requested indices {sorted(idx.tolist())}")
    print("-> each round explores DIFFERENT indices of the top-r set "
          "(ages reset on send, grow otherwise)\n")

    # --- compression-operator guarantee (paper §II-A) ----------------------
    beta = beta_of(g, r)
    gamma = gamma_rage_k(k, r, d, beta)
    sparse, _, _ = rage_k(g, torch.zeros_like(age), r=r, k=k)
    print(f"gamma = {gamma:.4f};  contraction {contraction(g, sparse):.4f} "
          f"<= 1-gamma = {1 - gamma:.4f}\n")

    # --- the PS protocol with clustering -----------------------------------
    print("== PS protocol: 4 clients, 2 hidden groups ==")
    hp = RAgeKConfig(r=8, k=3, M=2)
    ps = ParameterServer(d=32, n_clients=4, hp=hp)
    rng = np.random.default_rng(0)
    for t in range(6):
        cands = {i: (0 if i < 2 else 16) + rng.permutation(16)[:8]
                 for i in range(4)}
        rnd = ps.select_indices(cands)
        labels = ps.finish_round(rnd)
    print(f"clusters found: {labels.tolist()}  (clients 0,1 vs 2,3)")
    return labels


if __name__ == "__main__":
    main()
