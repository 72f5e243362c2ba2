"""Paper experiment (Figs. 4-5): federated CIFAR10-like with 6 clients in
3 label-group pairs: DBSCAN grouping and rAge-k on the 2,515,338-parameter
Network-2 CNN (fewer rounds than the paper's).

  PYTHONPATH=src python -m repro_torch.examples.clustered_cifar \
      [--rounds 24] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.base import RAgeKConfig
from repro_torch.data.federated import paper_cifar_split
from repro_torch.data.synthetic import cifar10_like
from repro_torch.device import resolve
from repro_torch.fl import FederatedEngine


def main(argv=None):
    """Returns the run's FLResult."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    (xtr, ytr), (xte, yte) = cifar10_like(n_train=3_000, n_test=1_000, seed=0)
    shards = paper_cifar_split(xtr, ytr)

    hp = RAgeKConfig(r=2500, k=100, H=5, M=8, lr=1e-3, batch_size=32,
                     method="rage_k")
    engine = FederatedEngine("cnn", shards, (xte, yte), hp, device=dev)
    res = engine.run_scanned(args.rounds,
                             eval_every=max(args.rounds // 6, 1),
                             heatmap_at=(args.rounds,), verbose=True)
    engine.close()
    print("\nconnectivity matrix (rounded):")
    print(np.round(res.heatmaps[args.rounds], 2))
    print("clusters:", res.cluster_labels[-1].tolist(),
          "(expect pairs (0,1), (2,3), (4,5))")
    return res


if __name__ == "__main__":
    main()
