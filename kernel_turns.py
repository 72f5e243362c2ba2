#!/usr/bin/env python3
"""Times the rAge-k round's report and selection kernels, the baselines'
report, and fig3 rAge-k and rTop-k rounds, for the port found under
``--src`` (default: this checkout), on
one NVIDIA card. Run it for two trees in turns in one call (old, new,
new, old) to compare them on the same card:

    python3 kernel_turns.py --src build/parent --label old

where ``build/parent`` holds another checkout (``git archive``). Prints:

- the candidate report (``ops.threshold_topk_batch``) at fig3 (10 x
  39,760, r 75) and at the CIFAR report (6 x 2,515,338, r 2,500) on
  ``torch.randn`` rows: device ms, the kernels each call launches and
  their microseconds (``torch.profiler``), and ``torch.topk(G.abs(), r)``;
- ``maghist_batch`` alone at both shapes;
- the baselines' report (``ops.threshold_topk``, rTop-k's and CAFe's) at
  both shapes on the same rows: device ms and the kernels it launches,
  beside ``torch.topk(G.abs(), r)``;
- ``segmented_age_topk`` at (C, S, r, k) = (10, 1, 75, 10), (5, 2, 75,
  10), (6, 1, 2500, 100) and (3, 2, 2500, 100), every slot valid;
- 20 fig3 rAge-k rounds and 20 rTop-k rounds (median ms), each then 10
  more under ``torch.profiler``: device busy ms, ``cudaLaunchKernel``
  calls and the round's spans per round.

Device times are ``chip_smoke.device_ms`` (median of 25 calls, each
behind a sleep kernel). It exits 2 without a card.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def profile_rounds(torch, eng, rounds: int = 10) -> str:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as CS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / rounds * 1e3
    ka = prof.key_averages()
    busy = sum(CS._dev_us(e) for e in ka if e.device_type == DeviceType.CUDA
               and e.key not in CS.SPANS) / rounds / 1e3
    launch = sum(e.count for e in ka if e.device_type != DeviceType.CUDA
                 and e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                               "cuLaunchKernelEx")) / rounds
    spans = {e.key: (e.cpu_time_total / rounds / 1e3,
                     CS._dev_us(e, True) / rounds / 1e3)
             for e in ka if e.key in CS.SPANS
             and e.device_type != DeviceType.CUDA}
    return (f"{wall:.3f} ms per profiled round, device busy {busy:.3f} ms, "
            f"kernel launch calls {launch:.1f}, spans (host / device ms): "
            + ", ".join(f"{k} {h:.3f} / {d:.3f}"
                        for k, (h, d) in sorted(spans.items())))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=ROOT)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as CS    # puts this checkout's src on the path ...
    sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
    # ... so the port under --src goes in front of it
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.data.federated import paper_mnist_split
    from repro_torch.data.synthetic import mnist_like
    from repro_torch.fl.engine import FederatedEngine
    from repro_torch.kernels import build
    from repro_torch.kernels import maghist as MH
    from repro_torch.kernels import ops
    from repro_torch.kernels import segmented_topk as ST

    torch.backends.cuda.matmul.allow_tf32 = False
    tag = f"[{args.label or args.src}]"
    say = CS.say
    say(f"{tag} port from {os.path.dirname(ops.__file__)} on "
        f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}")
    t0 = time.perf_counter()
    build.library()
    say(f"{tag} build {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for n, d, r in CS.REPORT_SHAPES:
        G = torch.randn((n, d), generator=gen, device=dev)
        if not torch.equal(ops.threshold_topk_batch(G, r).cpu(),
                           ops.threshold_topk_batch(G.cpu(), r)):
            raise AssertionError(f"the report differs at {(n, d, r)}")
        ms = CS.device_ms(lambda: ops.threshold_topk_batch(G, r))
        lib = CS.device_ms(lambda: torch.topk(G.abs(), r, dim=1))
        hist = CS.device_ms(lambda: MH.maghist_batch(G))
        say(f"{tag} report N={n} d={d} r={r}: {ms:.4f} ms, torch.topk "
            f"{lib:.4f} ms; maghist_batch alone {hist:.4f} ms; per call: "
            + CS.kernel_breakdown(torch,
                                  lambda: ops.threshold_topk_batch(G, r)))
        for a, b in zip(ops.threshold_topk(G, r), ops.threshold_topk(G.cpu(),
                                                                     r)):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"threshold_topk differs at {(n, d, r)}")
        ms = CS.device_ms(lambda: ops.threshold_topk(G, r))
        say(f"{tag} baselines' report N={n} d={d} r={r}: {ms:.4f} ms, "
            f"torch.topk {lib:.4f} ms; per call: " + CS.kernel_breakdown(
                torch, lambda: ops.threshold_topk(G, r)))
    for C, S, r, k in CS.SEG_SHAPES:
        cand = torch.stack([torch.randperm(3 * r, generator=gen,
                                           device=dev)[:r]
                            for _ in range(C * S)]).view(C, S, r).int()
        cand[:, 1:, : r // 2] = cand[:, :1, : r // 2]
        age = torch.randint(0, 4, (C, S, r), generator=gen,
                            device=dev).int()
        valid = torch.ones((C, S), dtype=torch.bool, device=dev)
        if not torch.equal(ST.segmented_age_topk(cand, age, valid, k),
                           ST.segmented_age_topk_plain(cand, age, valid, k)):
            raise AssertionError(f"segmented_age_topk differs at "
                                 f"{(C, S, r, k)}")
        ms = CS.device_ms(lambda: ST.segmented_age_topk(cand, age, valid, k))
        say(f"{tag} segmented_age_topk C={C} S={S} r={r} k={k}: {ms:.4f} ms")
    (x, y), test = mnist_like(n_train=60_000, n_test=2_000, seed=0)
    shards = paper_mnist_split(x, y, seed=0)
    for method in ("rage_k", "rtop_k"):
        eng = FederatedEngine("mlp", shards, test,
                              RAgeKConfig(**CS.FIG3, method=method), seed=0)
        t_rounds = []
        for _ in range(20):
            t0 = time.perf_counter()
            eng.step()
            t_rounds.append(time.perf_counter() - t0)
        want = CS.PAIRS if method == "rage_k" else list(range(eng.n))
        if eng.cluster_of.tolist() != want:
            raise AssertionError(f"{method} clusters {eng.cluster_of.tolist()}")
        say(f"{tag} fig3 {method} rounds 1-20: median "
            f"{statistics.median(t_rounds) * 1e3:.2f} ms, clusters "
            f"{eng.cluster_of.tolist()}")
        say(f"{tag} fig3 {method} rounds 21-30: "
            + profile_rounds(torch, eng))
    return 0


if __name__ == "__main__":
    sys.exit(main())
