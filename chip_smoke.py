#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: ``python3 chip_smoke.py`` from the repository root.

Phases, each printed on its own lines; any failure exits non-zero before
the last line:

1. card: the ``nvidia-smi`` name and power limit, TF32 off for matmul and
   cuDNN;
2. build: the CUDA kernel library from ``src/repro_torch/kernels/csrc``;
3. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the fig3 shapes and on edge-case inputs (integers exact,
   floats within the stated tolerance), with device times;
4. parity: one fig3 round on the card against the same round on the CPU
   (the plain versions) from the same params and batches;
5. slice: the fig3 rAge-k run, ``FederatedEngine("mlp")`` at the paper's
   hyper-parameters for 20 rounds through the step driver; losses
   finite, the five label-pair clusters at round 20, and each kernel
   launched exactly once per round.

``--profile`` adds ten more rounds under ``torch.profiler`` (host and
device time per span of the round, the device's idle share, the top
kernels; tables and the trace in ``build/profile/``).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2 and
prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory, NVIDIA data sheet
FP32_OPS_PER_S = 67e12           # H100 SXM non-tensor float32 peak
FIG3 = dict(r=75, k=10, H=4, M=20, lr=1e-4, batch_size=256)
PAIRS = [0, 0, 1, 1, 2, 2, 3, 3, 4, 4]
SPECIAL = [float("nan"), float("inf"), -float("inf"), 0.0, -0.0, 1e-40,
           -3e-39, 2.0 ** -45, 2.0 ** -40, 2.0 ** -39, 3e38, 1.0, 2.0 ** 24]


def say(*parts):
    print(*parts, flush=True)


def device_ms(fn, *, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call of ``fn``: each call is queued behind
    a sleep kernel, so the two events bracket the device work alone and not
    the host's launch overhead."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def bound(nbytes: int, nops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def grads(torch, n, d, gen, dev):
    G = torch.randn((n, d), generator=gen, device=dev) * torch.pow(
        10.0, torch.randint(-12, 4, (n, d), generator=gen,
                            device=dev).float())
    sp = torch.tensor(SPECIAL, device=dev)
    for i in range(n):
        pos = torch.randperm(d, generator=gen, device=dev)[:len(SPECIAL)]
        G[i, pos] = sp[:len(pos)]
    return G


def phase_kernels(torch, dev):
    from repro_torch.kernels import maghist as MH
    from repro_torch.kernels import ops
    from repro_torch.kernels import segmented_topk as ST
    from repro_torch.kernels import sparse_aggregate as SA

    gen = torch.Generator(device=dev).manual_seed(0)
    out = []

    # maghist_batch: fig3 (10, 39,760) and ragged or special rows; exact
    for n, d in ((10, 39_760), (3, 4097), (1, 13)):
        G = grads(torch, n, d, gen, dev)
        if not torch.equal(MH.maghist_batch(G), MH.hist_rows(G)):
            raise AssertionError(f"maghist_batch differs at {(n, d)}")
        if not torch.equal(ops.threshold_topk_batch(G, min(75, d)).cpu(),
                           ops.threshold_topk_batch(G.cpu(), min(75, d))):
            raise AssertionError(f"threshold_topk_batch differs at {(n, d)}")
    G = torch.randn((10, 39_760), generator=gen, device=dev)
    ids = (torch.arange(10, device=dev).unsqueeze(1) * MH.NBINS
           + MH.exponent_bins(G.abs())).reshape(-1)
    n, d = G.shape
    b, by = bound(4 * n * d + 4 * n * MH.NBINS, n * d)
    out.append(dict(
        name="maghist_batch", route="cuda",
        source="src/repro_torch/kernels/csrc/maghist.cu",
        replaces="src/repro/kernels/maghist.py:83", max_abs_err=0,
        ms=device_ms(lambda: MH.maghist_batch(G)),
        plain_ms=device_ms(lambda: MH.hist_rows(G)), bound_ms=b,
        bound_by=by,
        library_ms=device_ms(lambda: torch.bincount(
            ids, minlength=n * MH.NBINS))))

    # segmented_age_topk: fig3 before (10, 1) and after (5, 2) the first
    # recluster, plus ties, taken lanes, invalid slots and r > block size
    def seg_inputs(C, S, r):
        cand = torch.stack([torch.randperm(3 * r, generator=gen,
                                           device=dev)[:r]
                            for _ in range(C * S)]).view(C, S, r)
        cand[:, 1:, : r // 2] = cand[:, :1, : r // 2]
        age = torch.randint(0, 4, (C, S, r), generator=gen, device=dev)
        valid = torch.rand((C, S), generator=gen, device=dev) < 0.75
        valid[:, 0] = True
        return cand.int(), age.int(), valid

    for C, S, r, k in ((10, 1, 75, 10), (5, 2, 75, 10), (3, 4, 300, 5),
                       (2, 3, 7, 7)):
        cand, age, valid = seg_inputs(C, S, r)
        for disjoint in (True, False):
            got = ST.segmented_age_topk(cand, age, valid, k,
                                        disjoint=disjoint)
            want = ST.segmented_age_topk_plain(cand, age, valid, k,
                                               disjoint=disjoint)
            if not torch.equal(got, want):
                raise AssertionError(f"segmented_age_topk differs at "
                                     f"{(C, S, r, k, disjoint)}")
    times = {}
    for C, S in ((10, 1), (5, 2)):
        cand, age, valid = seg_inputs(C, S, 75)
        valid[:] = True
        times[(C, S)] = (
            device_ms(lambda: ST.segmented_age_topk(cand, age, valid, 10)),
            device_ms(lambda: ST.segmented_age_topk_plain(cand, age, valid,
                                                          10)))
        say(f"  segmented_age_topk C={C} S={S}: kernel "
            f"{times[(C, S)][0]:.4f} ms, plain {times[(C, S)][1]:.4f} ms")
    C, S, r, k = 5, 2, 75, 10
    b, by = bound(4 * (2 * C * S * r + C * S + C * S * k), C * S * k * r)
    out.append(dict(
        name="segmented_age_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/segmented_topk.cu",
        replaces="src/repro/kernels/segmented_topk.py:73", max_abs_err=0,
        ms=times[(5, 2)][0], plain_ms=times[(5, 2)][1], bound_ms=b,
        bound_by=by, library_ms=None))

    # sparse_aggregate: NK = 100 uploads into d = 39,760, plus duplicates
    # and the sentinels d and -2; floats within rtol=1e-5, atol=1e-6
    err = 0.0
    for d, nk in ((39_760, 100), (1000, 3000), (513, 7)):
        idx = torch.randint(-3, d + 3, (nk,), generator=gen, device=dev)
        q = nk // 4
        idx[:q] = idx[q:2 * q].clone()                  # duplicates
        idx[-2:] = torch.tensor([d, -2], device=dev)     # sentinels
        vals = torch.randn(nk, generator=gen, device=dev)
        age = torch.randint(0, 30, (d,), generator=gen, device=dev).int()
        dense, new_age = SA.sparse_aggregate(idx, vals, age)
        dense_p, age_p = SA.sparse_aggregate_plain(idx, vals, age)
        torch.testing.assert_close(dense, dense_p, rtol=1e-5, atol=1e-6)
        if not torch.equal(new_age, age_p):
            raise AssertionError(f"sparse_aggregate ages differ at {d}")
        if not torch.equal(dense, SA.sparse_aggregate(idx, vals, age)[0]):
            raise AssertionError("sparse_aggregate is not bitwise repeatable")
        err = max(err, float((dense - dense_p).abs().max()))
    d, nk = 39_760, 100
    idx = torch.randperm(d, generator=gen, device=dev)[:nk].int()
    vals = torch.randn(nk, generator=gen, device=dev)
    age = torch.zeros(d, dtype=torch.int32, device=dev)
    idx64 = idx.long()
    b, by = bound(8 * nk + 12 * d, nk)
    out.append(dict(
        name="sparse_aggregate", route="cuda",
        source="src/repro_torch/kernels/csrc/sparse_aggregate.cu",
        replaces="src/repro/kernels/sparse_aggregate.py:60", max_abs_err=err,
        ms=device_ms(lambda: SA.sparse_aggregate(idx, vals, age)),
        plain_ms=device_ms(lambda: SA.sparse_aggregate_plain(idx, vals, age)),
        bound_ms=b, bound_by=by,
        library_ms=device_ms(lambda: torch.zeros(
            d, device=dev).index_add_(0, idx64, vals))))
    for k in out:
        say(f"  {k['name']}: kernel {k['ms']:.4f} ms, plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']} ms, bound "
            f"{k['bound_ms']:.6f} ms ({k['bound_by']}), max_abs_err "
            f"{k['max_abs_err']}")
    return out


def phase_parity(torch, dev, shards, test):
    """One fig3 round on the card and on the CPU from the same params and
    batches. Indices and ages exactly; floats within rtol=1e-4, atol=1e-6,
    wider than the CPU tests' 1e-5 because cuBLAS and the CPU BLAS sum
    float32 products in another order across four dependent Adam steps."""
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.fl.engine import FederatedEngine

    hp = RAgeKConfig(**FIG3)
    card = FederatedEngine("mlp", shards, test, hp, seed=0, device=dev)
    cpu = FederatedEngine("mlp", shards, test, hp, seed=0, device="cpu")
    bx, by, _ = card._store.draw(card._data, card.samp, hp.H)
    mc = card._round_impl(bx, by)
    mh = cpu._round_impl(bx.cpu(), by.cpu())
    torch.cuda.synchronize()
    if not torch.equal(mc["idx"].cpu(), mh["idx"]):
        raise AssertionError("requested indices differ between card and CPU")
    if not torch.equal(card.age.cluster_age.cpu(), cpu.age.cluster_age):
        raise AssertionError("cluster ages differ between card and CPU")
    tol = dict(rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(mc["losses"].cpu(), mh["losses"], **tol)
    torch.testing.assert_close(mc["g_sum"].cpu(), mh["g_sum"], **tol)
    torch.testing.assert_close(card.g_params.cpu(), cpu.g_params, **tol)
    err = float((mc["g_sum"].cpu() - mh["g_sum"]).abs().max())
    say(f"parity: one fig3 round card == CPU (indices, ages exact; max "
        f"|g_sum diff| {err:.3e})")


def phase_slice(torch, dev, shards, test):
    import numpy as np
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.fl.engine import FederatedEngine
    from repro_torch.kernels import build

    torch.cuda.reset_peak_memory_stats()
    eng = FederatedEngine("mlp", shards, test, RAgeKConfig(**FIG3), seed=0)
    build.reset_launches()
    t_rounds = []
    for t in range(20):
        before = dict(build.LAUNCHES)
        t0 = time.perf_counter()
        m = eng.step()
        t_rounds.append(time.perf_counter() - t0)
        rose = {k: build.LAUNCHES[k] - before[k] for k in before}
        if any(v != 1 for v in rose.values()):
            raise AssertionError(f"round {t + 1}: kernel launches {rose}")
        if not np.isfinite(m["losses"]).all():
            raise AssertionError(f"round {t + 1}: non-finite losses")
    launches = dict(build.LAUNCHES)
    acc = eng.eval_acc()
    peak = torch.cuda.max_memory_allocated()
    if eng.cluster_of.tolist() != PAIRS:
        raise AssertionError(f"clusters {eng.cluster_of.tolist()} at round "
                             f"20, expected {PAIRS}")
    say(f"slice: 20 fig3 rounds on {torch.cuda.get_device_name(0)}: "
        f"clusters {eng.cluster_of.tolist()}, final losses mean "
        f"{float(m['losses'].mean()):.4f}, acc {acc:.4f}")
    say(f"slice: {20 / sum(t_rounds):.2f} rounds/s over rounds 1-20, "
        f"{19 / sum(t_rounds[1:]):.2f} rounds/s over rounds 2-20 "
        f"(round 1 {t_rounds[0] * 1e3:.1f} ms, median round "
        f"{statistics.median(t_rounds) * 1e3:.2f} ms, incl. the round-20 "
        f"recluster {eng.recluster_s * 1e3:.1f} ms); peak device memory "
        f"{peak / 2**20:.1f} MiB")
    say(f"slice: kernel launches {launches}")
    return launches, eng, statistics.median(t_rounds)


SPANS = ("draw", "local_phase", "select", "aggregate", "global_update",
         "metrics")


def phase_profile(torch, eng, median_round_s: float, rounds: int = 10):
    """``--profile``: ``rounds`` more fig3 rounds (after the round-20
    recluster, so C = 5 clusters of S = 2) under ``torch.profiler``: the
    round's spans by host and device time, the device's busy share, and
    the top kernels. Tables and the trace go to ``build/profile/``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e, total=False):
        name = "device_time_total" if total else "self_device_time_total"
        return getattr(e, name, getattr(e, name.replace("device", "cuda"), 0))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ka = prof.key_averages()
    # device rows: kernels and copies; the spans' own device rows are the
    # annotation ranges, not work
    kern = [e for e in ka
            if e.device_type == DeviceType.CUDA and e.key not in SPANS]
    busy = sum(dev_us(e) for e in kern) / rounds / 1e3
    wall = wall_us / rounds / 1e3
    med = median_round_s * 1e3
    say(f"profile: {rounds} rounds, {wall:.3f} ms per round with the "
        f"profiler on; device busy {busy:.3f} ms per round = "
        f"{100 * busy / wall:.1f}% of that (idle {100 - 100 * busy / wall:.1f}"
        f"%), {100 * busy / med:.1f}% of the unprofiled median round "
        f"{med:.2f} ms")
    for span in SPANS:
        e = next((e for e in ka if e.key == span
                  and e.device_type != DeviceType.CUDA), None)
        if e is not None:
            say(f"  span {span}: host {e.cpu_time_total / rounds / 1e3:.3f}"
                f" ms/round, device {dev_us(e, True) / rounds / 1e3:.3f} "
                f"ms/round")
    for e in sorted(kern, key=dev_us, reverse=True)[:8]:
        say(f"  device {dev_us(e) / rounds:8.2f} us/round x"
            f"{e.count / rounds:5.1f}  {e.key[:80]}")
    host = [e for e in ka
            if e.device_type != DeviceType.CUDA and e.key not in SPANS]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:6]:
        say(f"  host {e.self_cpu_time_total / rounds / 1e3:8.3f} ms/round "
            f"x{e.count / rounds:6.1f}  {e.key[:80]}")
    out = os.path.join(ROOT, "build", "profile")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "profile_table.txt"), "w") as f:
        f.write(ka.table(sort_by="self_cpu_time_total", row_limit=60))
    prof.export_chrome_trace(os.path.join(out, "profile_trace.json"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.data.federated import paper_mnist_split
    from repro_torch.data.synthetic import mnist_like
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    say(smi[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    say(f"card: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    say(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            say("  " + line.strip())

    kernels = phase_kernels(torch, dev)

    t0 = time.perf_counter()
    (x, y), test = mnist_like(n_train=60_000, n_test=2_000, seed=0)
    shards = paper_mnist_split(x, y, seed=0)
    say(f"data: mnist_like 60000/2000 and paper_mnist_split in "
        f"{time.perf_counter() - t0:.1f} s")
    phase_parity(torch, dev, shards, test)
    launches, eng, median_round_s = phase_slice(torch, dev, shards, test)
    if "--profile" in sys.argv[1:]:
        phase_profile(torch, eng, median_round_s)

    for k in kernels:
        k["launches"] = launches[k["name"]]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
