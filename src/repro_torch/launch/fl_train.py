"""The paper's own experiment driver: federated training of the Table-I
networks on non-i.i.d. splits with rAge-k / rTop-k / top-k / dense, on
the port (the reference's flags, printed lines and ``--out`` keys, plus
``--device``).

  PYTHONPATH=src python -m repro_torch.launch.fl_train --dataset mnist \
      --method rage_k --rounds 200

Without ``--device`` it runs on the CUDA card and raises without one;
``--device cpu`` runs the kernels' plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from repro_torch.checkpoint import AsyncCheckpointer
from repro_torch.configs.base import RAgeKConfig
from repro_torch.data.federated import paper_cifar_split, paper_mnist_split
from repro_torch.data.synthetic import cifar10_like, mnist_like
from repro_torch.device import resolve
from repro_torch.fl import (AsyncService, FaultModel, FederatedEngine,
                            LatencyModel)


class _KillingCheckpointer(AsyncCheckpointer):
    """Crash injector: hard-kills the process (``os._exit(17)``, no
    cleanup, no atexit) right after the first checkpoint at or past
    ``kill_at`` has durably committed; the resumed run must replay
    bit-identically from that entry."""

    def __init__(self, path: str, kill_at: int, **kw):
        super().__init__(path, **kw)
        self.kill_at = int(kill_at)

    def save(self, step, tree, extra=None):
        super().save(step, tree, extra=extra)
        if step >= self.kill_at:
            self.wait()
            print(f"[_KillingCheckpointer] committed step {step}, "
                  f"exiting hard", flush=True)
            os._exit(17)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=("mnist", "cifar"), default="mnist")
    ap.add_argument("--method", default="rage_k",
                    choices=("rage_k", "rtop_k", "top_k", "random_k",
                             "dense", "cafe"))
    ap.add_argument("--cafe-lam", type=float, default=0.1,
                    help="cost weight of the CAFe age-minus-cost score "
                         "(--method cafe)")
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--paper-hparams", action="store_true",
                    help="exact paper r/k/H/M/lr/batch (slow on CPU)")
    ap.add_argument("--r", type=int, default=None)
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--H", type=int, default=None)
    ap.add_argument("--M", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--n-train", type=int, default=None)
    ap.add_argument("--ef", action="store_true", help="error feedback")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write curves JSON here")
    ap.add_argument("--aggregate", default="auto",
                    choices=("auto", "jnp", "pallas"),
                    help="sparse-aggregation hand-off (pallas = the "
                         "segmented selection layout straight into the "
                         "fused scatter-add kernel; jnp = the per-client "
                         "(N, k) rows; auto = pallas; on the card both "
                         "launch the CUDA sparse_aggregate kernel)")
    ap.add_argument("--driver", default="scan",
                    choices=("step", "scan", "async"),
                    help="round driver: 'step' runs one round at a "
                         "time (host-paced, easiest to inspect); 'scan' "
                         "runs whole chunks of rounds between host stops, "
                         "each round one CUDA graph replay on the card "
                         "(bit-identical, faster); 'async' runs the "
                         "event-driven "
                         "buffered PS service plane (DESIGN.md §10) — "
                         "--rounds then counts buffer FLUSHES, and "
                         "--buffer-k/--staleness-eta/--version-window/"
                         "--hetero/--jitter configure it")
    ap.add_argument("--buffer-k", type=int, default=0,
                    help="async driver: aggregate after K client "
                         "updates land (FedBuff window; 0 -> N, which "
                         "with --hetero 0 --jitter 0 and "
                         "--version-window 1 is bit-identical to the "
                         "sync drivers)")
    ap.add_argument("--staleness-eta", type=float, default=0.5,
                    help="async driver: exponent of the age-decayed "
                         "staleness discount 1/(1+s)^eta on late "
                         "arrivals")
    ap.add_argument("--version-window", type=int, default=4,
                    help="async driver: parameter snapshots the PS "
                         "retains (staleness clips at V-1; V*d memory)")
    ap.add_argument("--solicit", default="report",
                    choices=("report", "dispatch"),
                    help="async driver: 'report' keeps the paper's "
                         "landing-time candidate protocol; 'dispatch' "
                         "solicits the r stalest cluster coordinates at "
                         "dispatch time (downlink-billed)")
    ap.add_argument("--hetero", type=float, default=0.5,
                    help="async driver: client speed heterogeneity "
                         "(lognormal sigma of the per-client base "
                         "latency; 0 = identical clients)")
    ap.add_argument("--jitter", type=float, default=0.25,
                    help="async driver: per-dispatch latency jitter "
                         "(lognormal sigma; 0 = deterministic)")
    ap.add_argument("--candidates", default="threshold",
                    choices=("threshold", "sort"),
                    help="top-r candidate plane: 'threshold' computes "
                         "the per-client report via the histogram "
                         "two-pass (one streaming pass over d + an "
                         "r-sized exact rank; default), 'sort' via a "
                         "full stable sort — bit-identical outputs, kept "
                         "for A/B debugging")
    ap.add_argument("--selection", default="segmented",
                    choices=("scan", "segmented"),
                    help="rage_k selection plane: 'segmented' runs the "
                         "in-cluster disjointness recursion per cluster "
                         "in parallel (default); 'scan' is the "
                         "sequential all-clients reference "
                         "(bit-identical, for A/B debugging)")
    ap.add_argument("--schedule", default="full",
                    choices=("full", "uniform", "aoi", "deadline"),
                    help="participation plane (DESIGN.md §9): 'full' = "
                         "every client every round (paper), 'uniform' = "
                         "m of N at random, 'aoi' = the m "
                         "longest-unheard clients (peak-age balancing), "
                         "'deadline' = timely-FL straggler dropout with "
                         "staleness-discounted next-round arrivals")
    ap.add_argument("--participation-m", type=int, default=0,
                    help="participants per round for --schedule "
                         "uniform/aoi (0 -> max(N // 4, 1))")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="round deadline in simulated seconds for "
                         "--schedule deadline (0 -> 1.0, ~the median "
                         "simulated client round time)")
    ap.add_argument("--age-layout", default="dense",
                    choices=("dense", "hierarchical"),
                    help="PS age-plane layout (DESIGN.md §12): 'dense' "
                         "keeps (N, d) cluster_age + freq on device; "
                         "'hierarchical' keys cluster_age by live "
                         "cluster id and logs requests sparsely — "
                         "bit-identical curves, ~C/N the age-plane "
                         "memory at large N")
    ap.add_argument("--compute", default="auto",
                    choices=("auto", "gathered", "masked"),
                    help="local compute plane (DESIGN.md §11): "
                         "'gathered' trains only the round's active "
                         "clients (gather-train-scatter, cost scales "
                         "with the scheduler's m bound), 'masked' "
                         "trains all N and discards inactive results; "
                         "'auto' picks gathered iff the schedule bounds "
                         "m below N — outputs are bit-identical")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (resilience plane, "
                         "DESIGN.md §13); saves ride an async writer "
                         "thread, atomically, keep-last-3")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint cadence in rounds (sync drivers) / "
                         "aggregations (async driver); 0 = off")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest loadable checkpoint in "
                         "--ckpt-dir (corrupt/uncommitted entries are "
                         "skipped); --rounds counts the TOTAL run, so "
                         "the resumed process only replays the "
                         "remainder, bit-identically")
    ap.add_argument("--faults", default=None,
                    help="fault-injection spec (fl.faults.FaultModel), "
                         "e.g. 'nan:0.1,crash:0.05,drop:0.1,byz:0.01,"
                         "dark:3+7,byz_scale:1e6'")
    ap.add_argument("--no-quarantine", action="store_true",
                    help="disable the PS-side validation gate (corrupt "
                         "updates reach the aggregate — for A/B runs)")
    ap.add_argument("--kill-at-round", type=int, default=0,
                    help="crash injector: os._exit(17) right after "
                         "the first checkpoint at/past this round "
                         "commits (requires --ckpt-dir and "
                         "--ckpt-every)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    if args.dataset == "mnist":
        defaults = (dict(r=75, k=10, H=4, M=20, lr=1e-4, batch_size=256)
                    if args.paper_hparams
                    else dict(r=75, k=10, H=4, M=20, lr=2e-3, batch_size=64))
        n_train = args.n_train or (60_000 if args.paper_hparams else 6_000)
        (xtr, ytr), test = mnist_like(n_train=n_train, n_test=2_000,
                                      seed=args.seed)
        shards = paper_mnist_split(xtr, ytr, seed=args.seed)
        kind = "mlp"
    else:
        defaults = (dict(r=2500, k=100, H=100, M=200, lr=1e-4, batch_size=256)
                    if args.paper_hparams
                    else dict(r=2500, k=100, H=10, M=20, lr=1e-3,
                              batch_size=64))
        n_train = args.n_train or (50_000 if args.paper_hparams else 12_000)
        (xtr, ytr), test = cifar10_like(n_train=n_train, n_test=1_500,
                                        seed=args.seed)
        shards = paper_cifar_split(xtr, ytr, seed=args.seed)
        kind = "cnn"

    for name in ("r", "k", "H", "M", "lr"):
        v = getattr(args, name)
        if v is not None:
            defaults[name] = v
    if args.batch:
        defaults["batch_size"] = args.batch
    hp = RAgeKConfig(method=args.method, cafe_lam=args.cafe_lam,
                     candidates=args.candidates, schedule=args.schedule,
                     participation_m=args.participation_m,
                     deadline_s=args.deadline_s,
                     buffer_k=args.buffer_k,
                     staleness_eta=args.staleness_eta,
                     version_window=args.version_window,
                     age_layout=args.age_layout, **defaults)

    faults = (FaultModel.parse(args.faults, len(shards), seed=args.seed,
                               device=dev) if args.faults else None)
    quarantine = not args.no_quarantine
    ck = None
    if args.ckpt_dir:
        ck = (_KillingCheckpointer(args.ckpt_dir, args.kill_at_round)
              if args.kill_at_round else AsyncCheckpointer(args.ckpt_dir))
    elif args.kill_at_round:
        raise SystemExit("--kill-at-round needs --ckpt-dir/--ckpt-every")

    if args.driver == "async":
        latency = LatencyModel(len(shards), hetero=args.hetero,
                               jitter=args.jitter, seed=args.seed,
                               device=dev)
        svc = AsyncService(kind, shards, test, hp, seed=args.seed,
                           device=dev, latency=latency,
                           solicit=args.solicit, faults=faults,
                           quarantine=quarantine)
        if args.resume and ck is not None and ck.latest_step() is not None:
            svc.load_state(ck)
            print(f"resumed from aggregation {svc.aggs_done} "
                  f"({ck.latest_step()=})")
        res = svc.run_async(args.rounds - svc.aggs_done,
                            eval_every=max(args.rounds // 20, 1),
                            verbose=True, checkpointer=ck,
                            ckpt_every=args.ckpt_every)
        if ck is not None:
            ck.close()
        summary = res.summary()
        print("summary:", summary)
        print("final clusters:", res.cluster_labels[-1].tolist())
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"driver": "async", "rounds": res.rounds,
                           "acc": res.acc, "loss": res.loss,
                           "uplink": res.uplink_bytes,
                           "downlink": res.downlink_bytes,
                           "clock": res.clock,
                           "aggregations": summary["aggregations"],
                           "staleness_hist": {
                               str(s): c for s, c in
                               res.staleness_hist().items()},
                           "clusters": res.cluster_labels[-1].tolist(),
                           "buffer_k": svc.K,
                           "staleness_eta": hp.staleness_eta,
                           "version_window": hp.version_window,
                           "solicit": args.solicit,
                           "quarantined": summary["total_quarantined"],
                           "crashed": summary["total_crashed"],
                           "dropped": summary["total_dropped"],
                           "retried": summary["total_retried"]},
                          f, indent=1)
        return

    engine = FederatedEngine(kind, shards, test, hp, seed=args.seed,
                             device=dev, ef=args.ef,
                             aggregate_impl=args.aggregate,
                             selection=args.selection, compute=args.compute,
                             faults=faults, quarantine=quarantine)
    prior = None
    if args.resume and ck is not None and ck.latest_step() is not None:
        prior = engine.load_state(ck)
        print(f"resumed at round {engine.round_idx}")
    drive = engine.run if args.driver == "step" else engine.run_scanned
    res = drive(args.rounds - engine.round_idx,
                eval_every=max(args.rounds // 20, 1),
                heatmap_at=(1, args.rounds), verbose=True,
                checkpointer=ck, ckpt_every=args.ckpt_every, result=prior)
    engine.close()
    if ck is not None:
        ck.close()
    print("summary:", res.summary())
    print("final clusters:", res.cluster_labels[-1].tolist())
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rounds": res.rounds, "acc": res.acc,
                       "loss": res.loss, "uplink": res.uplink_bytes,
                       "clusters": res.cluster_labels[-1].tolist(),
                       "schedule": args.schedule,
                       "n_active": res.n_active,
                       "aoi_mean": res.aoi_mean,
                       "aoi_peak": res.aoi_peak,
                       "age_mean": res.age_mean,
                       "age_peak": res.age_peak,
                       "n_quarantined": res.n_quarantined,
                       "n_crashed": res.n_crashed,
                       "n_dropped": res.n_dropped},
                      f, indent=1)


if __name__ == "__main__":
    main()
