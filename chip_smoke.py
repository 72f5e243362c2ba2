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
   floats within the stated tolerance), with device times: the rAge-k
   candidate report (two launches) card == CPU at fig3 and at the CIFAR
   report (6 x 2,515,338, r 2,500) on rows that drive each of its
   branches, beside ``torch.topk``, and past its shared sort (r 20,000 and
   10,000); the baselines' report (``ops.threshold_topk``, the same two
   launches with the magnitudes) at fig3 and CIFAR beside ``torch.topk``;
   ``segmented_age_topk`` at the fig3 and CIFAR selection shapes and at
   clusters past one block (S 156 and 256 at fig3's r and k, CIFAR's six
   clients in one cluster); ``decode_attention`` at head dims 32 to 256;
4. parity: one fig3 round on the card against the same round on the CPU
   (the plain versions) from the same params and batches, for rAge-k
   (segmented and scan), CAFe, top-k, dense and rTop-k;
5. slice: the fig3 rAge-k run, ``FederatedEngine("mlp")`` at the paper's
   hyper-parameters for 20 rounds through the step driver; losses
   finite, the five label-pair clusters at round 20, and its four
   kernels (the report's two, the selection, the aggregation) launched
   exactly once per round (``maghist`` never);
6. baselines: rTop-k, the paper's Fig. 3 counterpart, for 20 rounds
   (the report's two kernels and ``sparse_aggregate`` once per round,
   ``maghist`` never; clusters stay singletons), then 5 rounds each of
   CAFe, top-k, random-k, dense and rAge-k scan, each round checked
   against its method's kernel launches;
7. LM parity: internlm2-1.8b at full width with 2 layers in float32,
   12 decode steps from the same parameters and tokens on the card and
   on the CPU (logits, greedy tokens and caches); then its smoke config
   (head dim 32) in float32, ``generate`` card == CPU, and
   ``python -m repro_torch.launch.serve --smoke`` on the card;
8. serve: internlm2-1.8b at full width and depth in bfloat16, random
   weights from seed 0, through ``launch.serve.generate`` (batch 8,
   prompt 128, 32 generated tokens): finite logits, ``decode_attention``
   launched once per layer per step and no other kernel; prefill s,
   decode tokens/s, peak memory and KV bytes;
9. long decode: the same model with a 32,768-position cache of batch 8
   filled with seeded random values, 16 decode steps at its end: host ms
   per step, then under ``torch.profiler`` the device's busy ms and
   ``decode_attention``'s device ms per step.

Each path's launch counts are set to 0 just before it runs and read just
after; the kernels' JSON record sums them over the paths.

``--profile`` adds ten more rounds of the rAge-k slice and of the rTop-k
run under ``torch.profiler`` (host and device time per span of the
round, the device's idle share, the top kernels; tables and traces in
``build/profile/``), and eight more decode steps of the serve phase.

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
ARCH = "internlm2-1.8b"
# decode_attention: the reference sweep (H, G, D, S) of tests/test_kernels.py,
# a rep that is no power of two, rep 16 at D 64 (the largest shared-memory
# layout), a ragged long cache, and internlm2's decode shape at a real
# cache (B, H, G, D, S)
DA_SWEEP = [(8, 8, 64, 512), (8, 2, 64, 700), (16, 1, 128, 1024),
            (4, 4, 256, 512), (12, 4, 64, 77), (16, 1, 64, 300),
            (16, 8, 128, 4099), (4, 2, 32, 400), (16, 1, 32, 1000)]
DA_MAIN = (8, 16, 8, 128, 32_768)
DA_SERVE = (8, 16, 8, 128, 160)      # the serve phase's cache at its end
# rtol; atol is the same times min(1, max |o|) (see _da_close)
DA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# sparse_aggregate at (clients N, uploads k each, d): fig3, the paper's
# CIFAR setting (benchmarks/fig5_cifar.py: k 100 into Network-2's d;
# paper_cifar_split has 6 clients), then 1,000 and 250,000 uploads into the
# same d, correctness and scaling shapes that no workload runs
SA_SHAPES = [(10, 10, 39_760), (6, 100, 2_515_338), (10, 100, 2_515_338),
             (10, 25_000, 2_515_338)]
# the long-cache decode phase: batch, cache positions, decode steps
LONG = (8, 32_768, 16)
FIG3 = dict(r=75, k=10, H=4, M=20, lr=1e-4, batch_size=256)
PAIRS = [0, 0, 1, 1, 2, 2, 3, 3, 4, 4]
# kernel launches per round of each (method, selection) path
PER_ROUND = {
    ("rage_k", "segmented"): {"maghist_batch": 1, "threshold_topk_batch": 1,
                              "segmented_age_topk": 1, "sparse_aggregate": 1},
    ("rage_k", "scan"): {"maghist_batch": 1, "threshold_topk_batch": 1,
                         "sparse_aggregate": 1},
    ("rtop_k", "segmented"): {"maghist_batch": 1, "threshold_topk_batch": 1,
                              "sparse_aggregate": 1},
    ("cafe", "segmented"): {"maghist_batch": 1, "threshold_topk_batch": 1,
                            "sparse_aggregate": 1},
    ("top_k", "segmented"): {"sparse_aggregate": 1},
    ("random_k", "segmented"): {"sparse_aggregate": 1},
    ("dense", "segmented"): {},
}
SPECIAL = [float("nan"), float("inf"), -float("inf"), 0.0, -0.0, 1e-40,
           -3e-39, 2.0 ** -45, 2.0 ** -40, 2.0 ** -39, 3e38, 1.0, 2.0 ** 24]
# the candidate report at (clients N, d, r): fig3, and the CIFAR CNN's
# (benchmarks/fig5_cifar.py: r 2,500; paper_cifar_split: 6 clients)
REPORT_SHAPES = [(10, 39_760, 75), (6, 2_515_338, 2500)]
# past the report's shared sort (r > 8,192): an r of 20,000, and the CIFAR
# row with r 10,000
REPORT_LARGE = [(2, 200_000, 20_000), (1, 2_515_338, 10_000)]
# segmented_age_topk at (C, S, r, k): fig3 before and after the first
# recluster, and CIFAR's six clients before and after theirs
SEG_SHAPES = [(10, 1, 75, 10), (5, 2, 75, 10), (6, 1, 2500, 100),
              (3, 2, 2500, 100)]
# clusters past one block's shared memory: fig3's r and k from S 156, all
# six CIFAR clients in one cluster; the hash in device memory; one member
# past 8,192 lanes
SEG_LARGE = [(1, 156, 75, 10), (1, 256, 75, 10), (1, 6, 2500, 100),
             (2, 170, 120, 100), (1, 2, 10_000, 50)]


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


def _dev_us(e, total=False):
    """A profiler row's device microseconds (self, or with its children)."""
    name = "device_time_total" if total else "self_device_time_total"
    return getattr(e, name, getattr(e, name.replace("device", "cuda"), 0))


def kernel_breakdown(torch, fn, reps: int = 10) -> str:
    """Device us per launch of each kernel that ``fn`` launches, and its
    launches per call, from ``torch.profiler`` over ``reps`` calls after
    one warm-up (the profiler may miss a launch: x0.9 means 9 of 10)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    def name(key):   # the kernel's name without namespace or arguments
        key = key.replace("(anonymous namespace)::", "")
        return key.split("(")[0].split("<")[0].split(" ")[-1] or key[:40]
    return ", ".join(f"{name(e.key)} {_dev_us(e) / max(1, e.count):.2f} us "
                     f"x{e.count / reps:g}"
                     for e in sorted(rows, key=_dev_us, reverse=True))


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

    gen = torch.Generator(device=dev).manual_seed(0)
    out = []

    out += report_check(torch, dev, gen)

    # maghist: one vector and the batch of the fig3 path, the ragged tails
    # (1, 4097) and (3, 13), every row holding the SPECIAL values; exact.
    # threshold_topk, the report it feeds, card against CPU exactly.
    for shape in ((39_760,), (10, 39_760), (1, 4097), (3, 13)):
        rows = shape[0] if len(shape) == 2 else 1
        G = grads(torch, rows, shape[-1], gen, dev).reshape(shape)
        if not torch.equal(MH.maghist(G), MH.hist_blocks(G)):
            raise AssertionError(f"maghist differs at {shape}")
        r = min(75, shape[-1])
        for a, b in zip(ops.threshold_topk(G, r),
                        ops.threshold_topk(G.cpu(), r)):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"threshold_topk differs at {shape}")
    G = torch.randn((10, 39_760), generator=gen, device=dev)
    n, d = G.shape
    nb = -(-d // MH.BLOCK_D)
    # the library call counts the same zero-padded blocks
    Gp = torch.nn.functional.pad(G, (0, nb * MH.BLOCK_D - d))
    ids = ((torch.arange(n * nb, device=dev).view(n, nb, 1) * MH.NBINS)
           + MH.exponent_bins(Gp.abs()).view(n, nb, MH.BLOCK_D)).reshape(-1)
    if not torch.equal(torch.bincount(ids, minlength=n * nb * MH.NBINS)
                       .view(n, nb, MH.NBINS).int(), MH.maghist(G)):
        raise AssertionError("maghist differs from its bincount yardstick")
    b, by = bound(4 * n * d + 4 * n * nb * MH.NBINS, n * d)
    out.append(dict(
        name="maghist", route="cuda",
        source="src/repro_torch/kernels/csrc/maghist_blocks.cu",
        replaces="src/repro/kernels/maghist.py:57", max_abs_err=0,
        ms=device_ms(lambda: MH.maghist(G)),
        plain_ms=device_ms(lambda: MH.hist_blocks(G)), bound_ms=b,
        bound_by=by,
        library_ms=device_ms(lambda: torch.bincount(
            ids, minlength=n * nb * MH.NBINS)),
        baselines_report=baselines_report_check(torch, dev, gen)))

    out.append(segmented_check(torch, dev, gen))
    out.append(sparse_aggregate_check(torch, dev, gen))
    out.append(decode_attention_check(torch, dev, gen))
    for k in out:
        say(f"  {k['name']}: kernel {k['ms']:.4f} ms, plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']} ms, bound "
            f"{k['bound_ms']:.6f} ms ({k['bound_by']}), max_abs_err "
            f"{k['max_abs_err']}")
    return out


def baselines_report_check(torch, dev, gen):
    """The baselines' report (``ops.threshold_topk``: on the card the
    candidate report's two launches with its magnitudes, ``maghist``
    never) against the same call on the CPU, vals and indices exactly, at
    each ``REPORT_SHAPES`` on rows with the ``SPECIAL`` values and on the
    ``report_rows``, and on one vector. Device times at each shape on
    ``torch.randn`` rows beside its bound (one read of G, the report
    written), its plain version (``report.threshold_topk_plain``: the
    per-block histograms, the threshold in torch, a full-row stable sort)
    and ``torch.topk(G.abs(), r)``. Returns the records."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ops
    from repro_torch.kernels import report as RP

    want = {k: int(k in ("maghist_batch", "threshold_topk_batch"))
            for k in build.LAUNCHES}

    def check(G, r):
        before = dict(build.LAUNCHES)
        got = ops.threshold_topk(G, r)
        rose = {k: build.LAUNCHES[k] - before[k] for k in before}
        if rose != want:
            raise AssertionError(f"the baselines' report launched {rose}")
        for a, b in zip(got, ops.threshold_topk(G.cpu(), r)):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"threshold_topk differs at "
                                     f"{tuple(G.shape)}, r {r}")

    recs = []
    for n, d, r in REPORT_SHAPES:
        check(grads(torch, n, d, gen, dev), r)
        check(report_rows(torch, 7, d, gen, dev), r)
        check(grads(torch, 1, d, gen, dev)[0], r)
        G = torch.randn((n, d), generator=gen, device=dev)
        b, by = bound(4 * n * d + 8 * n * r, n * d)
        t = dict(n=n, d=d, r=r,
                 ms=device_ms(lambda: ops.threshold_topk(G, r)),
                 plain_ms=device_ms(lambda: RP.threshold_topk_plain(G, r)),
                 bound_ms=b, bound_by=by,
                 library_ms=device_ms(lambda: torch.topk(G.abs(), r, dim=1)))
        say(f"  threshold_topk (the baselines' report) N={n} d={d} r={r}: "
            f"kernels {t['ms']:.4f} ms (2 launches), plain "
            f"{t['plain_ms']:.4f}, torch.topk {t['library_ms']:.4f}, bound "
            f"{b:.6f} ({by}); profiled: " + kernel_breakdown(
                torch, lambda: ops.threshold_topk(G, r)))
        recs.append(t)
    return recs


def report_rows(torch, n, d, gen, dev):
    """n rows that drive the report's branches, the kinds in turn: one
    value, one binade (the refine), few distinct magnitudes, denormals
    alone (tau = 0), huge values and inf (the top bin of many exponents),
    five non-NaN values (the NaN lanes fill the report), all NaN."""
    def randn():
        return torch.randn((d,), generator=gen, device=dev)
    sign = torch.where(torch.rand((d,), generator=gen, device=dev) < 0.5,
                       -1.0, 1.0)
    huge = randn() * torch.pow(2.0, torch.randint(
        23, 120, (d,), generator=gen, device=dev).float())
    huge[:3] = float("inf")
    few = torch.full((d,), float("nan"), device=dev)
    few[torch.randperm(d, generator=gen, device=dev)[:5]] = randn()[:5]
    kinds = [torch.full((d,), -0.3, device=dev),
             sign * (1.0 + torch.rand((d,), generator=gen, device=dev)),
             torch.round(randn() * 4) / 4,
             torch.randint(-50, 50, (d,), generator=gen,
                           device=dev).float() * 2.0 ** -140,
             huge, few, torch.full((d,), float("nan"), device=dev)]
    return torch.stack([kinds[i % len(kinds)] for i in range(n)])


def report_check(torch, dev, gen):
    """``maghist_batch`` against ``hist_rows`` and the candidate report
    (``ops.threshold_topk_batch``) on the card against the same report on
    the CPU, exactly: at fig3 and the ragged (3, 4097) and (1, 13), every
    row holding the ``SPECIAL`` values, then at each ``REPORT_SHAPES`` on
    such rows and on the ``report_rows``; each report call launches the
    histogram pass and the report kernel once each, nothing else. Device
    times at each shape: the report beside its bound (one read of G; two
    reads printed too), its plain version and ``torch.topk(G.abs(), r)``,
    which finds the same set with no promise on ties; ``maghist_batch``
    beside ``bincount``. Returns the kernels' records at fig3."""
    from repro_torch.kernels import build
    from repro_torch.kernels import maghist as MH
    from repro_torch.kernels import ops
    from repro_torch.kernels import report as RP

    want = {k: int(k in ("maghist_batch", "threshold_topk_batch"))
            for k in build.LAUNCHES}

    def check(G, r):
        before = dict(build.LAUNCHES)
        got = ops.threshold_topk_batch(G, r)
        rose = {k: build.LAUNCHES[k] - before[k] for k in before}
        if rose != want:
            raise AssertionError(f"the report launched {rose}")
        if not torch.equal(got.cpu(), ops.threshold_topk_batch(G.cpu(), r)):
            raise AssertionError(f"threshold_topk_batch differs at "
                                 f"{tuple(G.shape)}, r {r}")

    for n, d in ((10, 39_760), (3, 4097), (1, 13)):
        G = grads(torch, n, d, gen, dev)
        if not torch.equal(MH.maghist_batch(G), MH.hist_rows(G)):
            raise AssertionError(f"maghist_batch differs at {(n, d)}")
        check(G, min(75, d))
    out = []
    for n, d, r in REPORT_SHAPES:
        G = grads(torch, n, d, gen, dev)
        if not torch.equal(MH.maghist_batch(G), MH.hist_rows(G)):
            raise AssertionError(f"maghist_batch differs at {(n, d)}")
        check(G, r)
        check(report_rows(torch, 7, d, gen, dev), r)
        G = torch.randn((n, d), generator=gen, device=dev)
        got = ops.threshold_topk_batch(G, r)
        lib = torch.topk(G.abs(), r, dim=1)
        # the yardstick finds the same magnitudes
        if not torch.equal(G.abs().gather(1, got.long()).sort(1).values,
                           lib.values.sort(1).values):
            raise AssertionError("torch.topk and the report disagree")
        b, by = bound(4 * n * d + 4 * n * r, n * d)
        b2 = bound(8 * n * d + 4 * n * r, n * d)[0]
        rec = dict(
            name="threshold_topk_batch", route="cuda",
            source="src/repro_torch/kernels/csrc/report.cu",
            replaces="src/repro/kernels/maghist.py:83", max_abs_err=0,
            ms=device_ms(lambda: ops.threshold_topk_batch(G, r)),
            plain_ms=device_ms(lambda: RP.threshold_topk_batch_plain(G, r)),
            bound_ms=b, bound_by=by,
            library_ms=device_ms(lambda: torch.topk(G.abs(), r, dim=1)))
        ids = (torch.arange(n, device=dev).unsqueeze(1) * MH.NBINS
               + MH.exponent_bins(G.abs())).reshape(-1)
        hb, hby = bound(4 * n * d + 4 * n * MH.NBINS, n * d)
        hist = dict(
            name="maghist_batch", route="cuda",
            source="src/repro_torch/kernels/csrc/maghist.cu",
            replaces="src/repro/kernels/maghist.py:83", max_abs_err=0,
            ms=device_ms(lambda: MH.maghist_batch(G)),
            plain_ms=device_ms(lambda: MH.hist_rows(G)), bound_ms=hb,
            bound_by=hby,
            library_ms=device_ms(lambda: torch.bincount(
                ids, minlength=n * MH.NBINS)))
        say(f"  threshold_topk_batch N={n} d={d} r={r}: kernels "
            f"{rec['ms']:.4f} ms (2 launches), plain {rec['plain_ms']:.4f}, "
            f"torch.topk {rec['library_ms']:.4f}, bound {b:.6f} ({by}, one "
            f"read of G; two reads {b2:.6f}); profiled: " + kernel_breakdown(
                torch, lambda: ops.threshold_topk_batch(G, r)))
        say(f"  maghist_batch N={n} d={d}: kernel {hist['ms']:.4f} ms, plain "
            f"{hist['plain_ms']:.4f}, bincount {hist['library_ms']:.4f}, "
            f"bound {hb:.6f} ({hby})")
        if not out:
            out = [hist, rec]
    # past the shared sort: the gathered pairs sorted in device memory
    large = []
    for n, d, r in REPORT_LARGE:
        check(grads(torch, n, d, gen, dev), r)
        check(report_rows(torch, 2, d, gen, dev)[:n], r)
        G = torch.randn((n, d), generator=gen, device=dev)
        b, by = bound(4 * n * d + 4 * n * r, n * d)
        t = dict(n=n, d=d, r=r,
                 ms=device_ms(lambda: ops.threshold_topk_batch(G, r)),
                 plain_ms=device_ms(
                     lambda: RP.threshold_topk_batch_plain(G, r)),
                 bound_ms=b, bound_by=by,
                 library_ms=device_ms(lambda: torch.topk(G.abs(), r, dim=1)))
        say(f"  threshold_topk_batch past the shared sort N={n} d={d} r={r}: "
            f"kernels {t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, "
            f"torch.topk {t['library_ms']:.4f}, bound {b:.6f} ({by}); "
            f"profiled: " + kernel_breakdown(
                torch, lambda: ops.threshold_topk_batch(G, r)))
        large.append(t)
    out[1]["large_r"] = large
    return out


def segmented_check(torch, dev, gen):
    """``segmented_age_topk`` on the card against its plain version,
    exactly, with and without ``disjoint``: at ``SEG_SHAPES`` and (3, 4,
    300, 5), (2, 3, 7, 7), with ties, taken lanes and invalid slots; and
    with r = k, S = 3 and equal ages, where every member after the first
    finds fewer than k untaken lanes. Device times at ``SEG_SHAPES``.
    Returns the record at fig3 after the first recluster, (5, 2)."""
    from repro_torch.kernels import segmented_topk as ST

    def inputs(C, S, r):
        cand = torch.stack([torch.randperm(3 * r, generator=gen,
                                           device=dev)[:r]
                            for _ in range(C * S)]).view(C, S, r)
        cand[:, 1:, : r // 2] = cand[:, :1, : r // 2]
        age = torch.randint(0, 4, (C, S, r), generator=gen, device=dev)
        valid = torch.rand((C, S), generator=gen, device=dev) < 0.75
        valid[:, 0] = True
        return cand.int(), age.int(), valid

    def check(cand, age, valid, k, disjoint):
        got = ST.segmented_age_topk(cand, age, valid, k, disjoint=disjoint)
        want = ST.segmented_age_topk_plain(cand, age, valid, k,
                                           disjoint=disjoint)
        if not torch.equal(got, want):
            raise AssertionError(f"segmented_age_topk differs at "
                                 f"{tuple(cand.shape)}, k {k}, disjoint "
                                 f"{disjoint}")

    for C, S, r, k in SEG_SHAPES + [(3, 4, 300, 5), (2, 3, 7, 7)]:
        cand, age, valid = inputs(C, S, r)
        for disjoint in (True, False):
            check(cand, age, valid, k, disjoint)
    cand = torch.randperm(40, generator=gen, device=dev)[:10].int()
    cand = cand.view(1, 1, 10).repeat(4, 3, 1)
    cand[:, 1:, 0] = 1000
    check(cand, torch.full_like(cand, 2), torch.ones((4, 3), device=dev,
                                                     dtype=torch.bool),
          10, True)
    rec = None
    for C, S, r, k in SEG_SHAPES:
        cand, age, valid = inputs(C, S, r)
        valid[:] = True
        b, by = bound(4 * (2 * C * S * r + C * S + C * S * k), C * S * k * r)
        t = dict(name="segmented_age_topk", route="cuda",
                 source="src/repro_torch/kernels/csrc/segmented_topk.cu",
                 replaces="src/repro/kernels/segmented_topk.py:73",
                 max_abs_err=0,
                 ms=device_ms(lambda: ST.segmented_age_topk(cand, age, valid,
                                                            k)),
                 plain_ms=device_ms(lambda: ST.segmented_age_topk_plain(
                     cand, age, valid, k)),
                 bound_ms=b, bound_by=by, library_ms=None)
        say(f"  segmented_age_topk C={C} S={S} r={r} k={k}: kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, bound "
            f"{b:.7f} ({by})")
        if (C, S) == (5, 2):
            rec = t
    # clusters past one block: ranked in device memory, then the walk;
    # int32 and int64 candidates, a -1 candidate
    large = []
    for C, S, r, k in SEG_LARGE:
        if ST.layout(S, r, k)["path"] != "global":
            raise AssertionError(f"{(C, S, r, k)} takes one block")
        cand, age, valid = inputs(C, S, r)
        cand[:, -1, 0] = -1
        for disjoint in (True, False):
            check(cand, age, valid, k, disjoint)
            check(cand.long(), age, valid, k, disjoint)
        valid[:] = True
        b, by = bound(4 * (2 * C * S * r + C * S + C * S * k), C * S * k * r)
        t = dict(C=C, S=S, r=r, k=k,
                 ms=device_ms(lambda: ST.segmented_age_topk(cand, age, valid,
                                                            k)),
                 plain_ms=device_ms(lambda: ST.segmented_age_topk_plain(
                     cand, age, valid, k), reps=3, warmup=1),
                 bound_ms=b, bound_by=by)
        say(f"  segmented_age_topk past one block C={C} S={S} r={r} k={k}: "
            f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, bound "
            f"{b:.7f} ({by}); profiled: " + kernel_breakdown(
                torch, lambda: ST.segmented_age_topk(cand, age, valid, k)))
        large.append(t)
    rec["large_s"] = large
    return rec


def _upload_order_sum(torch, idx, vals, d):
    """The host's dense sum in upload order: ``numpy.add.at`` in float32
    over the uploads whose index lies in [0, d)."""
    import numpy as np
    idx, vals = idx.cpu().numpy(), vals.cpu().numpy()
    ok = (idx >= 0) & (idx < d)
    out = np.zeros(d, np.float32)
    np.add.at(out, idx[ok], vals[ok])
    return torch.from_numpy(out)


def sparse_aggregate_check(torch, dev, gen):
    """The CUDA kernel bitwise against the host's upload-order sum and
    against its plain version (ages exact; sums within rtol=1e-5,
    atol=1e-6, since the plain ``index_add_`` adds with atomics in no
    fixed order): duplicates, the sentinels d and -2 and other indices out
    of range, 250,000 uploads into 1,000 coordinates, and the
    ``SA_SHAPES`` (each client's k indices distinct). At about 250 adds a
    coordinate the atomics' order moves the plain sums by more than that
    tolerance, so there the sums are held to the upload-order sum alone.
    Device times at each shape beside the bound, the plain version and
    ``index_add_`` into zeros, which computes the dense sum alone, without
    the age lane."""
    from repro_torch.kernels import sparse_aggregate as SA

    def check(idx, vals, age, plain_sums=True):
        d = age.shape[0]
        dense, new_age = SA.sparse_aggregate(idx, vals, age)
        dense_p, age_p = SA.sparse_aggregate_plain(idx, vals, age)
        if plain_sums:
            torch.testing.assert_close(dense, dense_p, rtol=1e-5, atol=1e-6)
        if not torch.equal(new_age, age_p):
            raise AssertionError(f"sparse_aggregate ages differ at d {d}, "
                                 f"NK {idx.numel()}")
        if not torch.equal(dense.cpu(),
                           _upload_order_sum(torch, idx, vals, d)):
            raise AssertionError(f"sparse_aggregate is not the upload-order "
                                 f"sum at d {d}, NK {idx.numel()}")
        if not torch.equal(dense, SA.sparse_aggregate(idx, vals, age)[0]):
            raise AssertionError("sparse_aggregate is not bitwise repeatable")
        return float((dense - dense_p).abs().max()) if plain_sums else 0.0

    def ages(d):
        return torch.randint(0, 30, (d,), generator=gen, device=dev).int()

    err = 0.0
    for d, nk, span in ((39_760, 100, None), (1000, 3000, None),
                        (513, 7, None), (2_515_338, 250_000, 1000)):
        top = span or d
        idx = torch.randint(-3, top + 3, (nk,), generator=gen, device=dev)
        q = nk // 4
        idx[:q] = idx[q:2 * q].clone()                  # duplicates
        idx[-2:] = torch.tensor([d, -2], device=dev)     # sentinels
        vals = torch.randn(nk, generator=gen, device=dev)
        err = max(err, check(idx, vals, ages(d), plain_sums=span is None))
    shapes = []
    for n, k, d in SA_SHAPES:
        idx = torch.stack([torch.randperm(d, generator=gen, device=dev)[:k]
                           for _ in range(n)]).reshape(-1).int()
        vals = torch.randn(n * k, generator=gen, device=dev)
        age = ages(d)
        err = max(err, check(idx, vals, age))
        idx64 = idx.long()
        b, by = bound(8 * n * k + 12 * d, n * k)
        t = dict(nk=n * k, d=d,
                 ms=device_ms(lambda: SA.sparse_aggregate(idx, vals, age)),
                 plain_ms=device_ms(
                     lambda: SA.sparse_aggregate_plain(idx, vals, age)),
                 bound_ms=b, bound_by=by,
                 library_ms=device_ms(lambda: torch.zeros(
                     d, device=dev).index_add_(0, idx64, vals)))
        say(f"  sparse_aggregate NK={n * k} ({n} x {k}) d={d}: kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, index_add_ "
            f"{t['library_ms']:.4f}, bound {t['bound_ms']:.6f} ({by}); "
            f"profiled: " + kernel_breakdown(
                torch, lambda: SA.sparse_aggregate(idx, vals, age)))
        shapes.append(t)
    main = {k: shapes[0][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    return dict(name="sparse_aggregate", route="cuda",
                source="src/repro_torch/kernels/csrc/sparse_aggregate.cu",
                replaces="src/repro/kernels/sparse_aggregate.py:60",
                max_abs_err=err, **main, shapes=shapes)


def phase_parity(torch, dev, shards, test):
    """One fig3 round on the card and on the CPU from the same params and
    batches, for each method. Indices, ages and request counts (CAFe's
    cost) exactly; floats within rtol=1e-4, atol=1e-6, wider than the CPU
    tests' 1e-5 because cuBLAS and the CPU BLAS sum float32 products in
    another order across four dependent Adam steps. rTop-k draws from
    each device's own generator, so there the candidate report must be
    equal and each draw inside its own report."""
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.core.strategies import topr_candidates
    from repro_torch.fl.engine import FederatedEngine

    tol = dict(rtol=1e-4, atol=1e-6)
    for method, selection in (("rage_k", "segmented"), ("rage_k", "scan"),
                              ("cafe", "segmented"), ("top_k", "segmented"),
                              ("dense", "segmented"), ("rtop_k", "segmented")):
        hp = RAgeKConfig(**FIG3, method=method)
        card, cpu = (FederatedEngine("mlp", shards, test, hp, seed=0,
                                     device=where, selection=selection)
                     for where in (dev, "cpu"))
        bx, by, _ = card._store.draw(card._data, card.samp, hp.H)
        mc = card._round_impl(bx, by)
        mh = cpu._round_impl(bx.cpu(), by.cpu())
        torch.cuda.synchronize()
        name = f"{method}/{selection}"
        torch.testing.assert_close(mc["losses"].cpu(), mh["losses"], **tol)
        if method == "rtop_k":
            reports = [topr_candidates(m["G"], hp.r, hp.candidates).cpu()
                       for m in (mc, mh)]
            if not torch.equal(*reports):
                raise AssertionError(f"{name}: candidate reports differ")
            for m, rep in zip((mc, mh), reports):
                if not (m["idx"].cpu().unsqueeze(-1)
                        == rep.unsqueeze(1)).any(-1).all():
                    raise AssertionError(f"{name}: a pick outside the report")
        else:
            if method == "dense":
                if mc["idx"] is not None or mh["idx"] is not None:
                    raise AssertionError(f"{name}: dense requested indices")
            elif not torch.equal(mc["idx"].cpu(), mh["idx"]):
                raise AssertionError(f"{name}: requested indices differ")
            torch.testing.assert_close(mc["g_sum"].cpu(), mh["g_sum"], **tol)
            torch.testing.assert_close(card.g_params.cpu(), cpu.g_params,
                                       **tol)
        if not (torch.equal(card.age.cluster_age.cpu(), cpu.age.cluster_age)
                and torch.equal(card.age.freq.cpu(), cpu.age.freq)):
            raise AssertionError(f"{name}: ages or request counts differ")
        if method == "rtop_k":
            say(f"parity: one fig3 {name} round: candidate reports card == "
                f"CPU, every pick inside its report")
        else:
            err = float((mc["g_sum"].cpu() - mh["g_sum"]).abs().max())
            say(f"parity: one fig3 {name} round card == CPU (indices, ages, "
                f"counts exact; max |g_sum diff| {err:.3e})")


def drive(eng, rounds: int, path):
    """``rounds`` steps of ``eng`` with every launch count set to 0 just
    before; each round must launch exactly the kernels of ``PER_ROUND[path]``
    (once each) and no other, with finite losses. Returns (the counts
    read just after, the rounds' host times, the last round's metrics)."""
    import numpy as np
    from repro_torch.kernels import build

    build.reset_launches()
    want = {k: PER_ROUND[path].get(k, 0) for k in build.LAUNCHES}
    t_rounds = []
    for t in range(rounds):
        before = dict(build.LAUNCHES)
        t0 = time.perf_counter()
        m = eng.step()
        t_rounds.append(time.perf_counter() - t0)
        rose = {k: build.LAUNCHES[k] - before[k] for k in before}
        if rose != want:
            raise AssertionError(f"{path} round {t + 1}: kernel launches "
                                 f"{rose}, expected {want}")
        if not np.isfinite(m["losses"]).all():
            raise AssertionError(f"{path} round {t + 1}: non-finite losses")
    return dict(build.LAUNCHES), t_rounds, m


def phase_slice(torch, dev, shards, test):
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.fl.engine import FederatedEngine

    torch.cuda.reset_peak_memory_stats()
    eng = FederatedEngine("mlp", shards, test, RAgeKConfig(**FIG3), seed=0)
    launches, t_rounds, m = drive(eng, 20, ("rage_k", "segmented"))
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
    return launches, eng, statistics.median(t_rounds), acc


def phase_baselines(torch, shards, test, rage_acc: float):
    """rTop-k for 20 fig3 rounds, then 5 rounds of each other path; every
    round against its path's kernel launches. Returns the launch counts
    summed over the paths, the rTop-k engine and its median round in s."""
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.fl.engine import FederatedEngine

    total = {}
    rtop = None
    for method, selection, rounds in (
            ("rtop_k", "segmented", 20), ("cafe", "segmented", 5),
            ("top_k", "segmented", 5), ("random_k", "segmented", 5),
            ("dense", "segmented", 5), ("rage_k", "scan", 5)):
        eng = FederatedEngine("mlp", shards, test,
                              RAgeKConfig(**FIG3, method=method), seed=0,
                              selection=selection)
        launches, t_rounds, m = drive(eng, rounds, (method, selection))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        name = f"{method}/{selection}"
        say(f"baselines: {name}: {rounds} rounds, {rounds / sum(t_rounds):.2f}"
            f" rounds/s over rounds 1-{rounds}, "
            f"{(rounds - 1) / sum(t_rounds[1:]):.2f} over rounds 2-{rounds} "
            f"(median round {statistics.median(t_rounds) * 1e3:.2f} ms), "
            f"final losses mean {float(m['losses'].mean()):.4f}, "
            f"launches {launches}")
        if method == "rtop_k":
            if eng.cluster_of.tolist() != list(range(eng.n)):
                raise AssertionError(f"rtop_k reclustered: "
                                     f"{eng.cluster_of.tolist()}")
            say(f"baselines: accuracy after 20 fig3 rounds: rage_k "
                f"{rage_acc:.4f}, rtop_k {eng.eval_acc():.4f}")
            rtop = (eng, statistics.median(t_rounds))
    return (total, *rtop)


SPANS = ("draw", "local_phase", "select", "aggregate", "global_update",
         "metrics")


def phase_profile(torch, eng, median_round_s: float, rounds: int = 10):
    """``--profile``: ``rounds`` more fig3 rounds of ``eng`` (for rAge-k,
    after the round-20 recluster, so C = 5 clusters of S = 2) under
    ``torch.profiler``: the round's spans by host and device time, the
    device's busy share, and the top kernels. Tables and the trace go to
    ``build/profile/``, named by the engine's method."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev_us = _dev_us
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
    method = eng.hp.method
    say(f"profile {method}: {rounds} rounds, {wall:.3f} ms per round with "
        f"the profiler on; device busy {busy:.3f} ms per round = "
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
    with open(os.path.join(out, f"profile_table_{method}.txt"), "w") as f:
        f.write(ka.table(sort_by="self_cpu_time_total", row_limit=60))
    prof.export_chrome_trace(os.path.join(out,
                                          f"profile_trace_{method}.json"))


def _sdpa(torch, q, k, v, cache_len):
    """The library's call for the same function: (B, H, 1, D) queries over
    (B, G, S, D) views of the cache with GQA and a boolean mask."""
    S = k.shape[1]
    mask = (torch.arange(S, device=q.device) < cache_len).view(1, 1, 1, S)
    return torch.nn.functional.scaled_dot_product_attention(
        q.unsqueeze(2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True).squeeze(2)


def _da_bound(B, H, G, D, n, itemsize):
    """Each valid K and V row read once, q read and out written once; two
    multiply-adds per K or V element per query row, one exp per score."""
    nbytes = itemsize * (2 * B * H * D + 2 * B * n * G * D)
    return bound(nbytes, 4 * B * H * n * D + B * H * n)


def _da_close(torch, got, want, tol):
    """|got - want| <= tol * |want| + tol * min(1, max |want|). A softmax
    average over n positions of N(0, 1) values is about n^-1/2 in size
    (about 0.009 at 32,768 positions), so a fixed atol of tol would pass an
    error as large as the output; scaled, it stays a few bfloat16 steps of
    the largest output."""
    atol = tol * min(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=atol)
    return atol


def decode_attention_check(torch, dev, gen):
    """The CUDA kernel against its plain version at the sweep shapes (B 2)
    in float32 and bfloat16 with cache_len 0, 1, S - 13 and S, with the
    tile and splits ``choose_splits`` takes and with 1, 2, 3 and 7 splits
    of small tiles (at cache_len 1 all but the first of those are empty),
    bitwise repeatable, and at internlm2's decode shape with a
    32,768-position bfloat16 cache, within ``_da_close``; device times
    beside the bound, the plain version and
    ``scaled_dot_product_attention``, and the cut each shape's launch
    took (``LAST_CUT``)."""
    from repro_torch.kernels import decode_attention as DA

    def cut(q, k, v, clen):
        DA.decode_attention(q, k, v, clen)
        c = dict(DA.LAST_CUT)
        return c, f"{c['splits']} splits of {c['tile_bytes'] // 1024} KB tiles"

    def inputs(B, H, G, D, S, dtype):
        return (torch.randn((B, H, D), generator=gen, device=dev).to(dtype),
                torch.randn((B, S, G, D), generator=gen, device=dev).to(dtype),
                torch.randn((B, S, G, D), generator=gen, device=dev).to(dtype))

    def check(q, k, v, clen, tol, splits=None):
        def run():
            if splits is None:
                return DA.decode_attention(q, k, v, clen)
            return DA._decode_attention_splits(q, k, v, clen, splits)
        got = run()
        want = DA.decode_attention_plain(q, k, v, clen)
        atol = _da_close(torch, got, want, tol)
        if not torch.equal(got, run()):
            raise AssertionError("decode_attention is not bitwise repeatable")
        if clen == 0 and got.any():
            raise AssertionError("decode_attention: cache_len 0 is not zeros")
        return float((got.float() - want.float()).abs().max()), atol

    def times(q, k, v, clen, tol):
        B, H, D = q.shape
        G = k.shape[2]
        b, by = _da_bound(B, H, G, D, min(clen, k.shape[1]),
                          q.element_size())
        # the yardstick computes the same function
        _da_close(torch, _sdpa(torch, q, k, v, clen),
                  DA.decode_attention_plain(q, k, v, clen), tol)
        return dict(ms=device_ms(lambda: DA.decode_attention(q, k, v, clen)),
                    plain_ms=device_ms(
                        lambda: DA.decode_attention_plain(q, k, v, clen)),
                    bound_ms=b, bound_by=by,
                    library_ms=device_ms(lambda: _sdpa(torch, q, k, v, clen)))

    for dtype, tol in DA_TOL.items():
        for H, G, D, S in DA_SWEEP:
            q, k, v = inputs(2, H, G, D, S, getattr(torch, dtype))
            err = max(check(q, k, v, clen, tol, splits)[0]
                      for clen in (0, 1, S - 13, S)
                      for splits in (None, 1, 2, 3, 7))
            t = times(q, k, v, S, tol)
            say(f"  decode_attention B=2 H={H} G={G} D={D} S={S} {dtype}: "
                f"max_abs_err {err:.3e} (rtol {tol}); at cache_len S "
                f"{cut(q, k, v, S)[1]}, kernel "
                f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, sdpa "
                f"{t['library_ms']:.4f}, bound {t['bound_ms']:.6f} "
                f"({t['bound_by']})")
    B, H, G, D, S = DA_SERVE
    q, k, v = inputs(B, H, G, D, S, torch.bfloat16)
    err, atol = check(q, k, v, S, DA_TOL["bfloat16"])
    t = times(q, k, v, S, DA_TOL["bfloat16"])
    say(f"  decode_attention serve B={B} H={H} G={G} D={D} S={S} bfloat16: "
        f"max_abs_err {err:.3e} (atol {atol:.2e}); {cut(q, k, v, S)[1]}, "
        f"kernel {t['ms']:.4f} ms, "
        f"plain {t['plain_ms']:.4f}, sdpa {t['library_ms']:.4f}, bound "
        f"{t['bound_ms']:.6f} ({t['bound_by']})")
    B, H, G, D, S = DA_MAIN
    q, k, v = inputs(B, H, G, D, S, torch.bfloat16)
    errs = [check(q, k, v, clen, DA_TOL["bfloat16"])
            for clen in (0, 1, S - 13, S)]
    err = max(e for e, _ in errs)
    t = times(q, k, v, S, DA_TOL["bfloat16"])
    main_cut, cut_text = cut(q, k, v, S)
    say(f"  decode_attention internlm2 B={B} H={H} G={G} D={D} S={S} "
        f"bfloat16 ({2 * k.numel() * 2 / 1e9:.2f} GB of K and V): "
        f"max_abs_err {err:.3e} (atol at cache_len S {errs[-1][1]:.2e}); "
        f"{cut_text}, kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f}, sdpa {t['library_ms']:.4f}, bound "
        f"{t['bound_ms']:.6f} ({t['bound_by']}); profiled: "
        + kernel_breakdown(torch, lambda: DA.decode_attention(q, k, v, S)))
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cuh",
                replaces="src/repro/kernels/decode_attention.py:60",
                max_abs_err=err, **t, splits=main_cut["splits"],
                tile_bytes=main_cut["tile_bytes"])


def phase_lm_parity(torch, dev):
    """internlm2-1.8b at full width with 2 layers in float32: 8 prompt and
    4 generated decode steps on the card and on the CPU from the same
    parameters, both fed the CPU's tokens. Logits within rtol=atol=1e-4
    and caches within 1e-5 (cuBLAS and the CPU's BLAS sum the
    2048- and 8192-long float32 products in other orders; TF32 off), the
    greedy tokens equal."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(ARCH).replace(n_layers=2, dtype="float32")
    t0 = time.perf_counter()
    cpu = T.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = _tree_to(cpu, dev)
    B, P, GEN = 2, 8, 4
    toks = torch.randint(0, cfg.vocab_size, (B, P),
                         generator=torch.Generator().manual_seed(1))
    caches = [T.init_cache(cfg, B, P + GEN, device=d) for d in ("cpu", dev)]
    err = 0.0
    for t in range(P + GEN):
        tok = toks[:, t] if t < P else cur
        lc, caches[0] = T.decode_step(cpu, cfg, {"token": tok}, caches[0], t)
        lg, caches[1] = T.decode_step(card, cfg, {"token": tok.to(dev)},
                                      caches[1], t)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
        cur = lc.argmax(-1)
        if not torch.equal(lg.argmax(-1).cpu(), cur):
            raise AssertionError(f"LM parity: greedy tokens differ at {t}")
        err = max(err, float((lg.cpu() - lc).abs().max()))
    for name in ("k", "v"):
        torch.testing.assert_close(caches[1][name].cpu(), caches[0][name],
                                   rtol=1e-5, atol=1e-5)
    say(f"LM parity: {cfg.name} d={cfg.d_model} H={cfg.n_heads} "
        f"G={cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size}, "
        f"{cfg.n_layers} layers, float32: {P + GEN} decode steps card == "
        f"CPU (max |logit diff| {err:.3e}, greedy tokens equal, caches "
        f"within 1e-5) in {time.perf_counter() - t0:.1f} s")


def phase_smoke_serve(torch, dev):
    """internlm2-1.8b's smoke config (head dim 32) in float32: ``generate``
    (batch 4, prompt 16, 8 tokens) on the card and on the CPU from the same
    CPU-drawn parameters and prompts, greedy tokens equal and logits
    within rtol=atol=1e-4 (as the LM parity); ``decode_attention`` once
    per layer per step and no other kernel. Then ``python -m
    repro_torch.launch.serve --smoke`` without ``--device``, on the card,
    must exit 0. Returns the in-process run's launch counts."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T

    cfg = get_smoke_config(ARCH).replace(dtype="float32", remat=False)
    cpu = T.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    B, P, GEN = 4, 16, 8
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(1))
    want = generate(cpu, cfg, prompts, GEN)
    build.reset_launches()
    got = generate(_tree_to(cpu, dev), cfg, prompts.to(dev), GEN)
    launches = dict(build.LAUNCHES)
    expect = {k: (cfg.n_layers * (P + GEN) if k == "decode_attention" else 0)
              for k in launches}
    if launches != expect:
        raise AssertionError(f"smoke serve: kernel launches {launches}, "
                             f"expected {expect}")
    if not torch.equal(got.tokens.cpu(), want.tokens):
        raise AssertionError("smoke serve: greedy tokens differ from the CPU")
    torch.testing.assert_close(got.logits.cpu(), want.logits, rtol=1e-4,
                               atol=1e-4)
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--smoke"], capture_output=True, text=True,
                         timeout=300,
                         env={**os.environ,
                              "PYTHONPATH": os.path.join(ROOT, "src")})
    if cli.returncode != 0:
        raise AssertionError(f"serve --smoke failed:\n{cli.stderr[-2000:]}")
    say(f"smoke serve: {cfg.name} smoke (d={cfg.d_model} H={cfg.n_heads} "
        f"G={cfg.n_kv_heads} head dim {cfg.head_dim_}) float32, batch {B}, "
        f"{P + GEN} steps: card == CPU (greedy tokens equal, max |logit "
        f"diff| {float((got.logits.cpu() - want.logits).abs().max()):.3e}); "
        f"launches {launches}; `serve --smoke` on the card in "
        f"{time.perf_counter() - t0:.1f} s: "
        + " | ".join(cli.stdout.strip().splitlines()))
    return launches


def phase_serve(torch, dev, profile: bool):
    """internlm2-1.8b at full width and depth, bfloat16, random weights
    from seed 0 on the card, served through ``launch.serve.generate``.
    Returns the launch counts of the run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T

    cfg = get_config(ARCH)
    B, P, GEN = 8, 128, 32
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init(cfg, gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device=dev)
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(w.numel() for w in _leaves(params))
    w_bytes = sum(w.numel() * w.element_size() for w in _leaves(params))
    build.reset_launches()
    out = generate(params, cfg, prompts, GEN)
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {k: (cfg.n_layers * (P + GEN) if k == "decode_attention" else 0)
            for k in launches}
    if launches != want:
        raise AssertionError(f"serve: kernel launches {launches}, "
                             f"expected {want}")
    if not out.finite or out.logits.shape != (B, cfg.padded_vocab):
        raise AssertionError("serve: non-finite logits or a wrong shape")
    kv_bytes = (2 * cfg.n_layers * B * (P + GEN) * cfg.n_kv_heads
                * cfg.head_dim_ * 2)
    say(f"serve: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
        f"{n_params / 1e9:.3f} B params ({w_bytes / 1e9:.3f} GB bfloat16), "
        f"batch {B}, prompt {P}, {GEN} generated tokens on "
        f"{torch.cuda.get_device_name(0)}")
    say(f"serve: prefill (by {P} decode steps) {out.prefill_s:.3f} s")
    say(f"serve: decode {B * GEN / out.decode_s:.1f} tokens/s over the "
        f"batch ({GEN / out.decode_s:.1f} tok/s per sequence, "
        f"{out.decode_s / GEN * 1e3:.2f} ms per step)")
    say(f"serve: peak device memory while serving {peak / 2**30:.3f} GiB; "
        f"KV cache {kv_bytes / 2**20:.1f} MiB")
    say(f"serve: kernel launches {launches} "
        f"({cfg.n_layers} decode_attention per step, {P + GEN} steps)")
    say("serve: generated token ids (first row): "
        f"{out.tokens[0].tolist()}")
    if profile:
        profile_decode(torch, dev, params, cfg, prompts)
    return launches


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def profile_decode(torch, dev, params, cfg, prompts, steps: int = 8):
    """``--profile``: ``steps`` decode steps of the serve configuration
    after a 128-token prompt, under ``torch.profiler``: host ms and device
    busy ms per step, the device's idle share, the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T

    B, P = prompts.shape
    cache = T.init_cache(cfg, B, P + steps, device=dev)
    for t in range(P):
        _, cache = T.decode_step(params, cfg, {"token": prompts[:, t]},
                                 cache, t)
    tok = prompts[:, -1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(P, P + steps):
            _, cache = T.decode_step(params, cfg, {"token": tok}, cache, t)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3

    dev_us = _dev_us
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kern) / steps / 1e3
    say(f"profile serve: {steps} decode steps, {wall:.3f} ms per step with "
        f"the profiler on; device busy {busy:.3f} ms per step "
        f"({100 * busy / wall:.1f}%, idle {100 - 100 * busy / wall:.1f}%)")
    for e in sorted(kern, key=dev_us, reverse=True)[:8]:
        say(f"  device {dev_us(e) / steps:9.2f} us/step x"
            f"{e.count / steps:6.1f}  {e.key[:80]}")
    host = [e for e in prof.key_averages()
            if e.device_type != DeviceType.CUDA]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        say(f"  host {e.self_cpu_time_total / steps / 1e3:8.3f} ms/step "
            f"x{e.count / steps:7.1f}  {e.key[:80]}")


def phase_long_decode(torch, dev, cfg=None):
    """internlm2-1.8b at full width and depth in bfloat16, random weights
    from seed 0, with a ``LONG`` cache (8 rows of 32,768 positions: 25.8
    GB of K and V over 24 layers) filled layer by layer with seeded random
    values up to position 32,752, then 16 decode steps at positions
    32,752-32,767: host ms per step after a sync, then the same 16 steps
    again under ``torch.profiler`` for the device's busy ms per step and
    ``decode_attention``'s device ms per step. Each run launches
    ``decode_attention`` once per layer per step and no other kernel, and
    its logits are finite. Returns the first run's launch counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.models import transformer as T

    cfg = cfg or get_config(ARCH)
    B, S, steps = LONG
    fill = S - steps
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = T.init(cfg, gen, device=dev)
    cache = T.init_cache(cfg, B, S, device=dev)
    for i in range(cfg.n_layers):
        for name in ("k", "v"):
            cache[name][i, :, :fill].normal_(generator=gen)
    tok0 = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=dev)
    torch.cuda.synchronize()
    kv_gb = sum(c.numel() * c.element_size() for c in cache.values()) / 1e9
    say(f"long decode: {cfg.name} {cfg.n_layers} layers {cfg.dtype}, batch "
        f"{B}, a {S}-position cache ({kv_gb:.2f} GB of K and V) filled to "
        f"{fill} in {time.perf_counter() - t0:.1f} s; {steps} decode steps "
        f"at positions {fill}-{S - 1}")
    want = {k: (cfg.n_layers * steps if k == "decode_attention" else 0)
            for k in build.LAUNCHES}

    def run():
        build.reset_launches()
        tok = tok0
        finite = torch.ones((), dtype=torch.bool, device=dev)
        for t in range(fill, S):
            logits, _ = T.decode_step(params, cfg, {"token": tok}, cache, t)
            finite &= torch.isfinite(logits).all()
            tok = torch.argmax(logits, -1)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        if launches != want:
            raise AssertionError(f"long decode: kernel launches {launches}, "
                                 f"expected {want}")
        if not bool(finite):
            raise AssertionError("long decode: non-finite logits")
        return launches

    t0 = time.perf_counter()
    launches = run()
    host = (time.perf_counter() - t0) / steps * 1e3
    say(f"long decode: {host:.2f} ms per step on the host clock after a "
        f"sync ({B * steps / (host * steps / 1e3):.1f} tokens/s over the "
        f"batch); launches {launches}; decode_attention's cut at the "
        f"last step {DA.LAST_CUT}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) / steps * 1e3

    dev_us = _dev_us
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kern) / steps / 1e3
    attn = sum(dev_us(e) for e in kern
               if "decode_attention" in e.key) / steps / 1e3
    say(f"long decode: profiled, {wall:.2f} ms per step; device busy "
        f"{busy:.3f} ms per step (idle {100 - 100 * busy / wall:.1f}%), "
        f"decode_attention {attn:.3f} ms per step "
        f"({100 * attn / max(busy, 1e-9):.1f}% of the busy time)")
    for e in sorted(kern, key=dev_us, reverse=True)[:6]:
        say(f"  device {dev_us(e) / steps:9.2f} us/step x"
            f"{e.count / steps:6.1f}  {e.key[:80]}")
    return launches


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
    launches, eng, median_round_s, acc = phase_slice(torch, dev, shards,
                                                     test)
    profile = "--profile" in sys.argv[1:]
    if profile:
        phase_profile(torch, eng, median_round_s)
    base, rtop, rtop_median_s = phase_baselines(torch, shards, test, acc)
    if profile:
        phase_profile(torch, rtop, rtop_median_s)
    del eng, rtop
    phase_lm_parity(torch, dev)
    smoke = phase_smoke_serve(torch, dev)
    serve = phase_serve(torch, dev, profile)
    torch.cuda.empty_cache()
    long = phase_long_decode(torch, dev)

    for k in kernels:
        k["launches"] = sum(run[k["name"]]
                            for run in (launches, base, smoke, serve, long))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
