"""Paper experiment (Figs. 2-3): federated MNIST with 10 clients in five
same-label pairs; rAge-k vs rTop-k.

  PYTHONPATH=src python -m repro_torch.examples.federated_mnist \
      [--rounds 150] [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import RAgeKConfig
from repro_torch.data.federated import paper_mnist_split
from repro_torch.data.synthetic import mnist_like
from repro_torch.device import resolve
from repro_torch.fl import FederatedEngine


def main(argv=None) -> dict:
    """Runs both methods; returns {method: FLResult}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    (xtr, ytr), (xte, yte) = mnist_like(n_train=6_000, n_test=2_000, seed=0)
    shards = paper_mnist_split(xtr, ytr)
    print(f"10 clients; client i holds labels "
          f"{[sorted(set(ys.tolist())) for _, ys in shards]}")

    out = {}
    for method in ("rage_k", "rtop_k"):
        hp = RAgeKConfig(r=75, k=10, H=4, M=20, lr=2e-3, batch_size=64,
                         method=method)
        engine = FederatedEngine("mlp", shards, (xte, yte), hp, device=dev)
        res = engine.run_scanned(args.rounds,
                                 eval_every=max(args.rounds // 10, 1),
                                 verbose=True)
        engine.close()
        s = res.summary()
        print(f"[{method}] final acc={s['final_acc']:.3f} "
              f"uplink={s['total_uplink_mb']:.2f} MiB "
              f"clusters={res.cluster_labels[-1].tolist()}\n")
        out[method] = res
    return out


if __name__ == "__main__":
    main()
