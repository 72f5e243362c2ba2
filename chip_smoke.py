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
   the three FL kernels on a partial round's inputs: the report on m = 2
   gathered rows, the report on the rows the fault lanes make (all NaN,
   all inf, x1e8), the selection on partial packings with a cluster that
   has no active member, the aggregation with sentinel rows; the report
   on the async service's one row (1 x 39,760, r 75 and 1 x 2,515,338,
   r 2,500) card == CPU, each faulted row alone too;
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
6a. chunked: the fig3 paths through ``run_scanned`` (20 rAge-k rounds,
   the label pairs at round 20 from the recluster worker; 20 rTop-k; 5
   of each other path), each round on the card one replay of a CUDA
   graph of the round, each run bitwise equal to ``run`` from the same
   seed; every replay's launches by its graph's tally, which the
   profiler's kernel count matches; a chunk of replays with no host sync
   (``set_sync_debug_mode("error")``); then the rates of rAge-k and
   rTop-k, the step driver and the chunked one in turns;
6b. cifar parity: one fig5 round, ``FederatedEngine("cnn")`` on the
   full Network-2 (d = 2,515,338, 6 clients of ``paper_cifar_split``, r
   2,500, k 100) at batch 32 and H 1, on the card against the CPU from
   the same params, BatchNorm state and batches, for rAge-k (segmented
   and scan) and rTop-k;
6c. cifar slice: ``cifar10_like`` 50,000/10,000 at fig5's
   hyper-parameters (batch 256, Adam lr 1e-4): the rAge-k round twice
   from the same inputs (bitwise equal or not, reported), 2 rounds at
   the paper's H 100, then 20 rAge-k rounds at H 10 and M 10 (two
   reclusters; the labels after each), the three kernels on one more
   round's real gradients, 4 rounds whose recluster (eps 1.0) joins all
   six clients in one cluster, and 10 rTop-k rounds at H 10, every round
   against its method's kernel launches;
6d. cifar chunked: 2 rAge-k rounds at the paper's H 100 and 10 at H 10,
   M 5 through ``run_scanned`` on cuDNN's default algorithms (capture
   time, the graphs' pool), the draw's cost at H 100, 4 rounds chunked
   against 4 stepwise under
   ``device.deterministic()`` bitwise, the (1, 6) one-cluster graph, and
   the rate at H 10, the two drivers in turns;
6e. partial parity: one fig3 round on the card against the CPU from
   the same params, batches and plan (handed to both; a uniform m 2
   plan and a deadline plan), gathered and masked, for rAge-k
   (segmented and scan), rTop-k, CAFe and dense, and rAge-k with error
   feedback;
6f. partial slice: fig3 at the paper's hyper-parameters, 20 rAge-k
   rounds each under uniform m 2 and aoi m 2 (gathered) and deadline
   1.0 (masked), and the ablation's rAge-k with error feedback, each
   through ``run`` and ``run_scanned``, bitwise equal; n_active, the
   aoi peak, the deadline's staleness discipline, every round's
   launches, a chunk with no host sync, the labels at round 20;
6g. compute plane: ``engine_bench``'s 32 clients of 100 samples,
   uniform m 32, 8 and 2, gathered and masked, chunked, in turns: ms
   and device-busy ms a round; gathered against masked from one seed;
6h. fig5 partial (after 6d): Network-2 under uniform m 2 at H 10,
   gathered and masked through ``run_scanned`` in turns (ms a round, a
   local step, the busy share), one gathered round card == CPU at
   batch 32, H 1, and rAge-k with error feedback chunked == stepwise
   under ``device.deterministic()``;
6i. hier fig3: the hierarchical age layout at fig3 with M 5 (two
   boundaries that change the cluster count): every method, rAge-k's
   sequential plane and uniform m 2 (gathered), dense and hierarchical
   from one seed through both drivers, bitwise equal (losses, picks,
   labels, the frequency matrix, params, the live age rows), every
   round's launches, the age rows following C, a hierarchical chunk
   with no host sync; one hierarchical round card == CPU (full and
   uniform m 2; the log ring exactly);
6j. resume: fig3 rAge-k dense and hierarchical and rTop-k, 20 rounds
   chunked saving every 5, resumed at round 10 in fresh engines through
   each driver, bitwise the uninterrupted run; bytes on disk, the
   caller's blocking time of a save (async and blocking), and the rate
   with a save every 4 rounds (none, async, blocking, in turns);
6k. age memory: engine_bench's grouped shards at N 64, 256 and 1,024
   (r 16, k 4, H 1, M 3, batch 8): the age plane's device bytes, dense
   and hierarchical, at init and after the first compaction, the
   allocator across it, the boundary's pull against
   ``clustering_input_bytes`` and its wall (drain, DBSCAN, apply,
   recapture), the chunked rate after it in turns, and
   ``segmented_age_topk`` at N 1,024's packing, kernel == plain;
6l. fig5 hier (after 6h): 20 rAge-k rounds at H 10, M 10 chunked, dense
   and hierarchical: the labels at each recluster equal, the
   boundary's pull and wall both ways, every round's launches;
6m. fig5 resume: hierarchical at H 10, M 2 under
   ``device.deterministic()``, 8 rounds saving at 4, resumed there,
   bitwise; the entry's bytes and a save's blocking time;
6n. faults (after 6j): the fault lanes' rates over 1,000 rounds and
   dispatches; one faulted fig3 round card == CPU from handed masks
   (masked and gathered, dense and hierarchical); 20 rAge-k rounds under
   a fault model stepped == chunked bitwise with the counters, each
   round's launches the unfaulted round's, finite with the gate and NaN
   without; resume under faults bitwise in both layouts; a faulted chunk
   with no host sync; the chunked rate with and without faults in turns;
6o. async (after 6n): ``AsyncService`` at fig3: the degenerate service
   against the engine over 20 aggregations (the first round and quantity
   that differ, if any; losses within rtol 1e-3; the label pairs at 20);
   K 5, V 4 under hetero 1.0 in report and dispatch modes and both
   layouts: the event order against a host replay, graph replays ==
   eager events bitwise, each eager landing's candidates == the plain
   report on its row, the report's two launches a report-mode event and
   none in dispatch mode,
   a chunk of replays with no host sync; faults with a dark client;
   resume bitwise; events/s eager and replayed, in turns;
6p. fig5 async (after 6m): Network-2's service, 2 aggregations at K 6,
   V 2, H 10: finite losses, the report's launches, ms an event; two
   eager landings' candidates == the plain report on their rows;
6q. cli (after 6p): ``python -m repro_torch.launch.fl_train`` through
   ``main(argv)``: fig3 at ``--paper-hparams`` for 20 rounds by the scan
   and the step driver (equal ``--out``, the label pairs, each round's
   four launches), the paper's 200 rounds of rAge-k and rTop-k (wall
   and final accuracy), the reference CI's smokes at ``--n-train 2000``
   and 5 rounds (uniform m 8, hierarchical == dense, ``--aggregate
   jnp`` == ``pallas``, faults, the async service at K 4), kill and
   resume in subprocesses (rc 17, a byte-equal ``--out``), fig5 at
   ``--paper-hparams`` for 2 rounds (each round's launches), the three
   examples at their defaults, ``apply_method`` and ``rage_k`` on a
   fig3 gradient row and ``GlobalServer`` card == CPU;
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
   ``decode_attention``'s device ms per step;
6r. lm train (after 9): the rAge-k report on internlm2-1.8b's
   ``mlp.w1`` and embedding gradient rows (402,653,184 and 189,792,256
   bfloat16, r 485 and 229) and on a seeded row, and ``sparse_aggregate``
   at d 402,653,184 with 61 and 122 uploads, each == its plain version
   on the card, beside ``torch.topk`` and ``index_add_``, and the
   report's survivors; every sync (``sync_grads`` for rage_k, cafe,
   top_k and dense on both candidate planes, ``make_manual_sync`` with
   masks and the gate, ``make_buffered_sync``) on the smoke config card
   == CPU from handed gradients over a world-size-1 NCCL group;
   internlm2-1.8b at full width in bfloat16 (batch 8, seq 128, r 2,048,
   k 256), ``LM_STEPS`` steps of each ``LM_PATHS`` path from one
   ``T.init``: finite losses, each step's launches (``lm_per_step``), ms
   a step, the busy share and top kernels of profiled steps, peak bytes;
   ``launch.train --smoke --steps 20`` for both methods and the example
   at ``--steps 60`` on the card;
10. families (after 6r): the other dense configs, MoE and MLA
   (gemma-2b, phi4-mini-3.8b, qwen1.5-110b, granite-moe-3b-a800m,
   deepseek-v2-236b): ``decode_attention`` at each GQA arch's serve
   shape (B 8 at 160 and 4,096 positions; gemma's rep 8 at head dim 256)
   == its plain version beside SDPA; each arch card == CPU in float32
   over 12 decode steps (gemma, phi4 and granite at full width with 2
   layers, qwen and deepseek at their smoke configs); each served at
   full width in bfloat16 through ``generate`` (batch 8, prompt 128, 32
   tokens; qwen cut to 8 of 80 layers and deepseek to 4 of 60 by one
   card's 80 GB, each against ``prefill`` over the same tokens):
   ``decode_attention`` once per layer per step, none under MLA;
   granite-moe-3b-a800m at full width, 16 of its 32 layers, in bfloat16:
   the report and ``sparse_aggregate`` at its ``experts_w1`` gradient
   row == their plain versions, then ``LM_STEPS`` steps of each
   ``MOE_PATHS`` path (single rage_k threshold, the manual sync with the
   gate on a world-size-1 NCCL group, dense) with each step's lb_loss,
   drop_frac and launches, ms, busy share and peak; deepseek's smoke
   training card == CPU; ``launch.train --smoke`` for granite and
   deepseek and ``launch.serve --smoke`` for each new arch on the card;
11. ssm and hybrid (after 10): mamba2-780m (48 Mamba2 layers) and
   zamba2-2.7b (54, with one shared attention block after every 6, head
   dim 80): ``decode_attention`` at D 80 at zamba2's serve shape (B 8,
   H = G = 32) over 160, 4,096 and 8,192 positions in bfloat16 and
   float32 == its plain version, bitwise repeatable, beside SDPA and the
   bytes bound; each arch card == CPU in float32 at full width (mamba2
   at 2 layers, zamba2 at 6: one group and one shared-block application)
   over 12 decode steps, the prefill over the fed tokens, and decode ==
   prefill on the card; each served at full width and depth in bfloat16
   through ``generate`` (batch 8, prompt 128, 32 tokens;
   ``decode_attention`` once per shared-block application per step, none
   for mamba2) with the top device kernels of a decode step; each
   trained at full width in bfloat16 (mamba2 at full depth, zamba2 cut
   to ``HYBRID_TRAIN_LAYERS`` = 30 layers) through ``MOE_PATHS``, after the
   report and ``sparse_aggregate`` at its largest bucket's gradient ==
   their plain versions; ``launch.serve --smoke`` and ``launch.train
   --smoke`` for both archs on the card;
12. vlm and audio (after 11): pixtral-12b (the dense stack, 40 layers,
   fed embeddings) and whisper-large-v3 (32 encoder and 32 decoder
   layers, head dim 64, cross attention through ``decode_attention``):
   ``decode_attention`` at pixtral's serve shape (B 8, H 32, G 8, D 128
   over 160 and 4,096 positions) and whisper's (H = G = 20, D 64 over
   448 self and 1,500 cross positions, the cross shape in float32 too)
   == its plain version beside SDPA and the bound; each arch card == CPU
   in float32 at full width with 2 layers (whisper: 2 encoder and 2
   decoder layers, its cross caches filled from the encoder by
   ``fill_cross``): 12 decode steps from tokens, pixtral's from
   ``embed`` inputs too, prefill, and decode == prefill on the card;
   pixtral served at full width and depth in bfloat16 (``serve_arch``,
   four profiled steps); whisper decoded at full width and depth
   through ``decode_step`` (30 s of audio, batch 8: the cross caches
   filled from its encoder, a 128-token prompt, 32 greedy tokens,
   steps past its 448 target positions clamped alike, four profiled
   steps); each trained at full width on ``registry.concrete_batch``
   batches (pixtral cut to 4 of 40 layers, whisper at full depth)
   through ``MOE_PATHS`` after the report and ``sparse_aggregate`` at
   its largest bucket's gradient; ``launch.serve --arch pixtral-12b
   --smoke`` on the card, and the refusals of ``launch.serve`` for
   whisper and ``launch.train`` for both, each asserted;
13. the model axis: phase 6r's full-width internlm2-1.8b gradient, its
   specs resolved for the production mesh's model axis (data 1, model
   16, ``rules={"fsdp": None}``), every leaf cut into its 16 local
   slices, each slice's exchange through ``make_manual_sync`` with
   ``candidates='threshold'`` on the card against the same exchange
   through the plain versions on the card (indices and ages exact,
   synced values bitwise); the report and ``sparse_aggregate`` at the
   largest slice (``mlp.w1``'s (24, 2,048, 512)) beside the bound and
   ``torch.topk``; one dry-run combination (internlm2-1.8b x train_4k x
   16x16, ``--sync rage_k``) under this machine's torch, in a
   subprocess on the CPU that runs beside the card's phases; one
   autotune sweep at internlm2's decode shapes and at ``mlp.w1``'s
   slice into a temporary registry (``build/dryrun_smoke/AUTOTUNE.json``),
   each winner held to its plain twin;
14. train memory (after 13): internlm2-1.8b at full
   width cut to 2 and 4 layers, one step of
   ``launch.steps.make_train_step`` (Adam, two microbatches of 4 x 1,024
   tokens) and phi4-mini-3.8b at full width cut to 1 and 2 layers, one
   step of 2 x 4,096 tokens, each with remat on and off
   (``train_memory.py``): ``torch.cuda.max_memory_allocated`` over each
   step and a second step's ms beside the dry run's tracker peak of the
   same steps on a fake (1, 1) mesh (in a CPU subprocess beside the
   card's phases), the dry run's growth a layer within
   ``TRAIN_MEMORY_TOL`` of the card's; and the allocator read around
   phi4's flash attention backward (what its recompute left live, and
   the most while it runs).

Each phase prints a ``time:`` line when it ends: seconds since the
build, and whether phase 13's dry run is still running beside it.

Each path's launch counts are set to 0 just before it runs and read just
after; the kernels' JSON record sums them over the paths.

``--profile`` adds ten more rounds of the rAge-k slice and of the rTop-k
run under ``torch.profiler`` (host and device time per span of the
round, the device's idle share, the top kernels; tables and traces in
``build/profile/``), three more CIFAR rAge-k rounds at H 10 after the
slice's two reclusters, a profiled window of each driver in the rates
(host ms, device busy ms, ``cudaLaunchKernel`` and ``cudaGraphLaunch``
a round), and eight more decode steps of the serve phase.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2 and
prints no result.
"""
from __future__ import annotations

import json
import os
import shutil
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
# fig5 (benchmarks/fig5_cifar.py with BENCH_FULL=1): Network-2, the 6
# clients of paper_cifar_split, r 2,500, k 100, H 100, M 200, batch 256,
# Adam lr 1e-4, 1,400 rounds
FIG5 = dict(r=2500, k=100, H=100, M=200, lr=1e-4, batch_size=256)
# the CIFAR slice's cuts: H 100 -> 10 and M 200 -> 10 for its 20 rAge-k
# and 10 rTop-k rounds (1,400 -> 20 rounds); 2 rounds keep the paper's H
FIG5_CUT = dict(H=10, M=10)
# the card-against-CPU round: a batch and H that the CPU runs in seconds
FIG5_PARITY = dict(H=1, batch_size=32)
SPECIAL = [float("nan"), float("inf"), -float("inf"), 0.0, -0.0, 1e-40,
           -3e-39, 2.0 ** -45, 2.0 ** -40, 2.0 ** -39, 3e38, 1.0, 2.0 ** 24]
# the candidate report at (clients N, d, r): fig3, and the CIFAR CNN's
# (benchmarks/fig5_cifar.py: r 2,500; paper_cifar_split: 6 clients)
REPORT_SHAPES = [(10, 39_760, 75), (6, 2_515_338, 2500)]
# past the report's shared sort (r > 8,192): an r of 20,000, and the CIFAR
# row with r 10,000
REPORT_LARGE = [(2, 200_000, 20_000), (1, 2_515_338, 10_000)]
# the async service's report-mode landing: one client's row at fig3 and
# at the CIFAR CNN's width
SERVICE_REPORT = [(1, 39_760, 75), (1, 2_515_338, 2500)]
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


def kernel_name(key: str) -> str:
    """A device row's kernel name without namespace, template or
    arguments."""
    key = key.replace("(anonymous namespace)::", "")
    return key.split("(")[0].split("<")[0].split(" ")[-1] or key[:40]


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
    return ", ".join(f"{kernel_name(e.key)} "
                     f"{_dev_us(e) / max(1, e.count):.2f} us "
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
    faulted_rows_check(torch, dev, gen)

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
    for name, recs in partial_kernels_check(torch, dev, gen).items():
        next(k for k in out if k["name"] == name)["partial"] = recs
    for k in out:
        say(f"  {k['name']}: kernel {k['ms']:.4f} ms, plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']} ms, bound "
            f"{k['bound_ms']:.6f} ms ({k['bound_by']}), max_abs_err "
            f"{k['max_abs_err']}")
    return out


def report_exact(torch, G, r, baselines: bool = False):
    """One report call on the card (``ops.threshold_topk_batch``, or with
    ``baselines`` the baselines' ``ops.threshold_topk``) against the same
    call on the CPU, exactly; the call launches the histogram pass and
    the report kernel once each, nothing else."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ops

    fn = ops.threshold_topk if baselines else ops.threshold_topk_batch
    before = dict(build.LAUNCHES)
    got = fn(G, r)
    rose = {k: build.LAUNCHES[k] - before[k] for k in before}
    if rose != {k: int(k in ("maghist_batch", "threshold_topk_batch"))
                for k in before}:
        raise AssertionError(f"{fn.__name__} launched {rose} at "
                             f"{tuple(G.shape)}, r {r}")
    want = fn(G.cpu(), r)
    for a, b in zip(*((x,) if torch.is_tensor(x) else x
                      for x in (got, want))):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"{fn.__name__} differs at "
                                 f"{tuple(G.shape)}, r {r}")


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
    from repro_torch.kernels import ops
    from repro_torch.kernels import report as RP

    recs = []
    for n, d, r in REPORT_SHAPES:
        for G in (grads(torch, n, d, gen, dev),
                  report_rows(torch, 7, d, gen, dev),
                  grads(torch, 1, d, gen, dev)[0]):
            report_exact(torch, G, r, baselines=True)
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
    beside ``bincount``. At each ``SERVICE_REPORT`` (the service's one
    row) the same exact check, on a row with the ``SPECIAL`` values and
    on each of the ``report_rows`` alone. Returns the kernels' records
    at fig3."""
    from repro_torch.kernels import maghist as MH
    from repro_torch.kernels import ops
    from repro_torch.kernels import report as RP

    for n, d in ((10, 39_760), (3, 4097), (1, 13)):
        G = grads(torch, n, d, gen, dev)
        if not torch.equal(MH.maghist_batch(G), MH.hist_rows(G)):
            raise AssertionError(f"maghist_batch differs at {(n, d)}")
        report_exact(torch, G, min(75, d))
    out = []
    for n, d, r in REPORT_SHAPES:
        G = grads(torch, n, d, gen, dev)
        if not torch.equal(MH.maghist_batch(G), MH.hist_rows(G)):
            raise AssertionError(f"maghist_batch differs at {(n, d)}")
        report_exact(torch, G, r)
        report_exact(torch, report_rows(torch, 7, d, gen, dev), r)
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
    for n, d, r in SERVICE_REPORT:
        report_exact(torch, grads(torch, n, d, gen, dev), r)
        for row in report_rows(torch, 7, d, gen, dev):
            report_exact(torch, row.unsqueeze(0), r)
    say(f"  threshold_topk_batch on the service's single rows "
        f"{SERVICE_REPORT}: card == CPU exactly (the SPECIAL values and "
        f"each of the seven report_rows kinds alone), two launches a call")
    # past the shared sort: the gathered pairs sorted in device memory
    large = []
    for n, d, r in REPORT_LARGE:
        report_exact(torch, grads(torch, n, d, gen, dev), r)
        report_exact(torch, report_rows(torch, 2, d, gen, dev)[:n], r)
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
    total = sum(dev_us(e) for e in kern) / rounds / 1e3
    busy = busy_union_us(prof) / rounds / 1e3
    wall = wall_us / rounds / 1e3
    med = median_round_s * 1e3
    method = f"{eng.kind}_{eng.hp.method}"
    say(f"profile {method}: {rounds} rounds, {wall:.3f} ms per round with "
        f"the profiler on; device busy {busy:.3f} ms per round = "
        f"{100 * busy / wall:.1f}% of that (idle {100 - 100 * busy / wall:.1f}"
        f"%), {100 * busy / med:.1f}% of the unprofiled median round "
        f"{med:.2f} ms; device rows' time summed {total:.3f} ms (above the "
        f"busy time where streams overlap)")
    for span in SPANS:
        e = next((e for e in ka if e.key == span
                  and e.device_type != DeviceType.CUDA), None)
        if e is not None:
            say(f"  span {span}: host {e.cpu_time_total / rounds / 1e3:.3f}"
                f" ms/round, device {dev_us(e, True) / rounds / 1e3:.3f} "
                f"ms/round (the kernels its launches name)")
    H = eng.hp.H
    say(f"  per local step (H {H}): {med / H:.3f} ms of the unprofiled "
        f"median round, device busy {busy / H:.3f} ms of the profiled one")
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


def busy_union_us(prof) -> float:
    """Microseconds in which some kernel, copy or memset ran on the
    device: the union of the device events' intervals (a sum counts the
    overlap of two streams twice)."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.name not in SPANS)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _groups_matched(labels) -> str:
    """fig5's count of label pairs clustered together, and whether the
    three groups are apart."""
    pairs = sum(labels[a] == labels[a + 1] for a in (0, 2, 4))
    apart = len({labels[0], labels[2], labels[4]}) == 3
    return (f"{pairs}/3 label groups together, "
            f"{'apart' if apart else 'not apart'}")


def branch_grad(torch, eng, x, y, forced=None):
    """The first local step's forward of the CNN engine ``eng`` (at its
    current params and model state) on the batch (x (N, H, B, ...), y):
    every ReLU's sign mask and the max pool's indices, in call order.
    With ``forced`` (another device's such branches) each ReLU takes the
    forced mask and the pool the forced indices, and the gradient G of
    that pass comes too. Returns (branches, G (N, d) or None). The CPU's
    G under the card's branches is the oracle of the card's G where
    rounding put a ReLU input on the other side of 0 on the two devices.
    ``torch.relu`` and ``F.max_pool2d`` are swapped for the pass."""
    import torch.nn.functional as F
    from repro_torch.device import strict_fp32
    from repro_torch.fl import client as C
    from repro_torch.models import paper_nets as P

    relu, pool = torch.relu, F.max_pool2d
    out = {"relu": [], "pool": []}
    it = {k: iter(v) for k, v in (forced or {}).items()}

    def relu_(h):
        if forced is not None:
            return torch.where(next(it["relu"]).to(h.device), h, 0.0)
        out["relu"].append((h > 0).cpu())
        return relu(h)

    def pool_(h, k, s):
        if forced is not None:
            idx = next(it["pool"]).to(h.device)
            return h.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        y_, idx = pool(h, k, s, return_indices=True)
        out["pool"].append(idx.cpu())
        return y_
    torch.relu, F.max_pool2d = relu_, pool_
    try:
        with strict_fp32():
            p = eng.params_s.detach().requires_grad_(forced is not None)
            logits, _ = P.cnn_apply(eng._unflatten(p), eng.state_s,
                                    x[:, 0], train=True)
            if forced is None:
                return out, None
            loss = C.softmax_xent(logits, y[:, 0])
            return out, torch.autograd.grad(loss.sum(), p)[0]
    finally:
        torch.relu, F.max_pool2d = relu, pool


# ReLU inputs that rounding may put on the other side of 0 on the card
# and on the CPU: at most this many in all, in at most this many clients
MAX_FLIPS = (4, 1)


def flipped_clients(card_br, cpu_br, n: int) -> tuple[list, set]:
    """The ReLU inputs of another sign on the two devices, a count a ReLU
    call, and the clients they belong to (a convolution's channels are
    grouped by client, a dense layer's leading axis is the client).
    Raises past ``MAX_FLIPS``: more is drift, not rounding at 0."""
    counts, clients = [], set()
    for a, b in zip(card_br["relu"], cpu_br["relu"]):
        diff = a != b
        counts.append(int(diff.sum()))
        if diff.ndim == 4:                       # (B, N*C, H, W)
            per = diff.reshape(diff.shape[0], n, -1).any(2).any(0)
        else:                                    # (N, B, F)
            per = diff.reshape(n, -1).any(1)
        clients |= set(per.nonzero().flatten().tolist())
    if sum(counts) > MAX_FLIPS[0] or len(clients) > MAX_FLIPS[1]:
        raise AssertionError(f"ReLU inputs of another sign on the card "
                             f"and the CPU: {counts} a call, clients "
                             f"{sorted(clients)}; at most {MAX_FLIPS}")
    return counts, clients


def phase_cifar_parity(torch, dev, shards, test):
    """One fig5 round of the full Network-2 (N 6, r 2,500, k 100; batch 32,
    H 1) on the card and on the CPU from the same params, BatchNorm state
    and batches, for rAge-k (segmented and scan) and rTop-k. Floats
    (losses, G, g_sum, the new global params, the BatchNorm state) within
    rtol=1e-4, atol=1e-6, as the fig3 parity (cuDNN and the CPU sum the
    float32 products in other orders; TF32 off); indices, ages and
    request counts exactly; the card's report of its G equal to the CPU's
    report of that same G. rTop-k draws from each device's generator, so
    there each pick must lie inside its own report and g_sum and the
    params are not compared; the two reports, each of its own device's
    G, must hold the same set wherever the smallest gap in |G| at the
    r-th place exceeds twice the largest |G| difference (their order
    inside swaps at near ties). Each comparison's largest difference is
    printed before it is checked, with the margin of the card's report:
    the smallest gap in |G| at the r-th and k-th place of a row. Where
    rounding puts a ReLU input on the other side of 0 on the card than on
    the CPU (``branch_grad``; printed, a count a ReLU call), that client's
    G row takes another branch: it is held, at the same tolerance, to the
    CPU's gradient under the card's branches."""
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.core.strategies import topr_candidates
    from repro_torch.fl import client as C
    from repro_torch.fl.engine import FederatedEngine

    tol = dict(rtol=1e-4, atol=1e-6)
    for method, selection in (("rage_k", "segmented"), ("rage_k", "scan"),
                              ("rtop_k", "segmented")):
        hp = RAgeKConfig(**{**FIG5, **FIG5_PARITY}, method=method)
        card, cpu = (FederatedEngine("cnn", shards, test, hp, seed=0,
                                     device=where, selection=selection)
                     for where in (dev, "cpu"))
        bx, by, _ = card._store.draw(card._data, card.samp, hp.H)
        # the branches each device takes; where a ReLU input has another
        # sign on the card, that client's G row is held to the CPU's
        # gradient under the card's branches
        card_br = branch_grad(torch, card, bx, by)[0]
        flips, flipped = flipped_clients(
            card_br, branch_grad(torch, cpu, bx.cpu(), by.cpu())[0],
            len(shards))
        forced = (branch_grad(torch, cpu, bx.cpu(), by.cpu(), card_br)[1]
                  if flipped else None)
        t0 = time.perf_counter()
        mc = card._round_impl(bx, by)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        mh = cpu._round_impl(bx.cpu(), by.cpu())
        t_cpu = time.perf_counter() - t0
        name = f"cnn {method}/{selection}"
        rows = sorted(flipped)
        G_ref = mh["G"].clone()
        G_ref[rows] = forced[rows] if rows else G_ref[rows]
        plain_G = float((mc["G"].cpu() - mh["G"]).abs().max())
        floats = {"losses": (mc["losses"], mh["losses"]),
                  "G": (mc["G"], G_ref)}
        if method != "rtop_k":
            floats.update(g_sum=(mc["g_sum"], mh["g_sum"]),
                          params=(card.g_params, cpu.g_params))
        for i, (a, b) in enumerate(zip(C.tree_leaves(card.state_s),
                                       C.tree_leaves(cpu.state_s))):
            floats[f"bn{i // 2}.{('mean', 'var')[i % 2]}"] = (a, b)
        errs = {k: float((a.cpu() - b).abs().max())
                for k, (a, b) in floats.items()}
        mag = mc["G"].abs().sort(dim=1, descending=True).values
        gap_r = float((mag[:, hp.r - 1] - mag[:, hp.r]).min())
        gap_k = float((mag[:, hp.k - 1] - mag[:, hp.k]).min())
        say(f"cifar parity: one {name} round (batch {hp.batch_size}, H "
            f"{hp.H}): card {t_card:.2f} s, CPU {t_cpu:.2f} s; max |diff| "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f"; the card's report margin: smallest |G| gap at place r "
            f"{gap_r:.3e}, at place k {gap_k:.3e}; ReLU inputs of another "
            f"sign on the card, a ReLU call each: {flips}"
            + (f", so G's rows {rows} are held to the CPU's gradient under "
               f"the card's branches (against the CPU's own: max |diff| "
               f"{plain_G:.3e})" if rows else ""))
        for k, (a, b) in floats.items():
            torch.testing.assert_close(a.cpu(), b, **tol,
                                       msg=lambda m: f"{name} {k}: {m}")
        # the integers from one G: the card's report kernels on the card's
        # G against the CPU's plain report of the same G
        if not torch.equal(topr_candidates(mc["G"], hp.r, "threshold").cpu(),
                           topr_candidates(mc["G"].cpu(), hp.r, "threshold")):
            raise AssertionError(f"{name}: the card's report of its G differs "
                                 f"from the CPU's report of the same G")
        if method == "rtop_k":
            reports = [topr_candidates(m["G"], hp.r, hp.candidates).cpu()
                       for m in (mc, mh)]
            same_set = torch.equal(*(r.sort(1).values for r in reports))
            say(f"cifar parity: {name}: the two devices' reports of their "
                f"own G: sets equal {same_set}, "
                f"{int((reports[0] != reports[1]).sum())} of "
                f"{reports[0].numel()} places differ in order (near ties "
                f"inside the report swap where |G| moves by {plain_G:.1e})")
            # the sets must agree wherever the float differences cannot
            # cross the r-th place
            if not same_set and gap_r > 2 * plain_G:
                raise AssertionError(f"{name}: candidate report sets differ")
            for m, rep in zip((mc, mh), reports):
                if not (m["idx"].cpu().unsqueeze(-1)
                        == rep.unsqueeze(1)).any(-1).all():
                    raise AssertionError(f"{name}: a pick outside the report")
        elif not torch.equal(mc["idx"].cpu(), mh["idx"]):
            raise AssertionError(f"{name}: requested indices differ")
        if not (torch.equal(card.age.cluster_age.cpu(), cpu.age.cluster_age)
                and torch.equal(card.age.freq.cpu(), cpu.age.freq)):
            raise AssertionError(f"{name}: ages or request counts differ")
        say(f"cifar parity: {name}: card == CPU (the report of one G "
            f"exact; "
            + ("every pick inside its report"
               if method == "rtop_k" else "indices, ages, counts exact")
            + f"; floats within rtol {tol['rtol']}, atol {tol['atol']})")


def cifar_repeat(torch, dev, shards, test):
    """The CIFAR slice's rAge-k round (batch 256, H 10) twice on the card
    from the same params and batches: whether G and the new global params
    are bitwise equal (cuDNN's weight-gradient algorithms may add with
    atomics). Printed, not gated."""
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.fl.engine import FederatedEngine

    hp = RAgeKConfig(**{**FIG5, **FIG5_CUT})
    out = []
    bx = by = None
    for _ in range(2):
        eng = FederatedEngine("cnn", shards, test, hp, seed=0)
        if bx is None:
            bx, by, _ = eng._store.draw(eng._data, eng.samp, hp.H)
        m = eng._round_impl(bx, by)
        out.append((m["G"], eng.g_params, m["idx"]))
        del eng
    (g1, p1, i1), (g2, p2, i2) = out
    say(f"cifar repeat: the rAge-k round (batch {hp.batch_size}, H {hp.H}) "
        f"twice from the same inputs: G bitwise equal {torch.equal(g1, g2)} "
        f"(max |diff| {float((g1 - g2).abs().max()):.3e}), new params "
        f"bitwise equal {torch.equal(p1, p2)} (max |diff| "
        f"{float((p1 - p2).abs().max()):.3e}), picks equal "
        f"{torch.equal(i1, i2)}")


def cifar_real_times(torch, eng):
    """The slice's kernels on real gradients: ``eng``'s local phase on one
    more draw (the engine left as it was) gives G (6, 2,515,338) and its
    report; each kernel equal to its plain version there, then device
    times beside the bound and the library call: the report and
    ``maghist_batch`` alone; ``segmented_age_topk`` on those reports with
    the engine's cluster ages at (C, S) = (6, 1), (3, 2) and (1, 6); and
    ``sparse_aggregate`` of the (1, 6) picks' 600 uploads. Returns the
    records by kernel name."""
    from repro_torch.device import strict_fp32
    from repro_torch.kernels import maghist as MH
    from repro_torch.kernels import ops
    from repro_torch.kernels import report as RP
    from repro_torch.kernels import segmented_topk as ST
    from repro_torch.kernels import sparse_aggregate as SA

    hp = eng.hp
    r, k = hp.r, hp.k
    bx, by, _ = eng._store.draw(eng._data, eng.samp, hp.H)
    with strict_fp32():
        G, cands = eng._local_phase(eng.params_s, eng.opt_s, eng.state_s,
                                    bx, by)[3:5]
    n, d = G.shape
    rep = ops.threshold_topk_batch(G, r)
    if not (torch.equal(rep, cands)
            and torch.equal(rep, RP.threshold_topk_batch_plain(G, r))):
        raise AssertionError("the report on real gradients differs from "
                             "its plain version")
    if not torch.equal(MH.maghist_batch(G), MH.hist_rows(G)):
        raise AssertionError("maghist_batch on real gradients differs")
    zero = float((G == 0).float().mean())
    b, by_ = bound(4 * n * d + 4 * n * r, n * d)
    out = {"threshold_topk_batch": dict(
        ms=device_ms(lambda: ops.threshold_topk_batch(G, r)),
        plain_ms=device_ms(lambda: RP.threshold_topk_batch_plain(G, r)),
        bound_ms=b, bound_by=by_,
        library_ms=device_ms(lambda: torch.topk(G.abs(), r, dim=1)))}
    hb, hby = bound(4 * n * d + 4 * n * MH.NBINS, n * d)
    out["maghist_batch"] = dict(
        ms=device_ms(lambda: MH.maghist_batch(G)),
        plain_ms=device_ms(lambda: MH.hist_rows(G)), bound_ms=hb,
        bound_by=hby, library_ms=None)
    say(f"  real gradients ({n} x {d}, {100 * zero:.2f}% exact zeros): "
        f"report {out['threshold_topk_batch']['ms']:.4f} ms (plain "
        f"{out['threshold_topk_batch']['plain_ms']:.4f}, torch.topk "
        f"{out['threshold_topk_batch']['library_ms']:.4f}, bound {b:.6f}); "
        f"maghist_batch alone {out['maghist_batch']['ms']:.4f}; profiled: "
        + kernel_breakdown(torch, lambda: ops.threshold_topk_batch(G, r)))
    cand = rep.long()
    ages = eng.age.cluster_age.index_select(
        0, eng.age.cluster_of.long()).gather(1, cand)
    sel = {}
    picks = None
    for C, S in ((6, 1), (3, 2), (1, 6)):
        c3, a3 = cand.view(C, S, r), ages.view(C, S, r)
        valid = torch.ones((C, S), dtype=torch.bool, device=G.device)
        got = ST.segmented_age_topk(c3, a3, valid, k)
        if not torch.equal(got, ST.segmented_age_topk_plain(c3, a3, valid,
                                                            k)):
            raise AssertionError(f"segmented_age_topk on real reports "
                                 f"differs at ({C}, {S})")
        sb, sby = bound(4 * (2 * C * S * r + C * S + C * S * k),
                        C * S * k * r)
        sel[f"{C}x{S}"] = dict(
            path=ST.layout(S, r, k)["path"],
            ms=device_ms(lambda: ST.segmented_age_topk(c3, a3, valid, k)),
            plain_ms=device_ms(lambda: ST.segmented_age_topk_plain(
                c3, a3, valid, k), reps=5, warmup=1),
            bound_ms=sb, bound_by=sby, library_ms=None)
        picks = got
    out["segmented_age_topk"] = sel
    say("  real reports, segmented_age_topk: " + ", ".join(
        f"({c}) {t['path']} {t['ms']:.4f} ms (plain {t['plain_ms']:.4f})"
        for c, t in sel.items()))
    idx = picks.reshape(-1)
    vals = G.reshape(-1).gather(0, (torch.arange(n, device=G.device)
                                    .repeat_interleave(k) * d
                                    + idx.long()))
    age = eng.age.cluster_age[0].contiguous()
    dense, _ = SA.sparse_aggregate(idx, vals, age)
    if not torch.equal(dense.cpu(), _upload_order_sum(torch, idx, vals, d)):
        raise AssertionError("sparse_aggregate on real picks is not the "
                             "upload-order sum")
    ab, aby = bound(8 * n * k + 12 * d, n * k)
    idx64 = idx.long()
    out["sparse_aggregate"] = dict(
        ms=device_ms(lambda: SA.sparse_aggregate(idx, vals, age)),
        plain_ms=device_ms(lambda: SA.sparse_aggregate_plain(idx, vals,
                                                             age)),
        bound_ms=ab, bound_by=aby,
        library_ms=device_ms(lambda: torch.zeros(d, device=G.device)
                             .index_add_(0, idx64, vals)))
    t = out["sparse_aggregate"]
    say(f"  real picks, sparse_aggregate NK={n * k} d={d}: {t['ms']:.4f} ms "
        f"(plain {t['plain_ms']:.4f}, index_add_ {t['library_ms']:.4f}, "
        f"bound {ab:.6f})")
    return out


def phase_cifar_slice(torch, dev, shards, test, profile: bool):
    """fig5 on the card through ``FederatedEngine("cnn")`` and the step
    driver: 2 rAge-k rounds at the paper's H 100 (round ms, ms per local
    step, peak memory), then 20 rAge-k rounds at H 10 and M 10 (the labels
    after each recluster and the (C, S) selection took), the kernels on
    real gradients, (``--profile``) 3 more rounds under the profiler, 4
    rounds with M 2 and DBSCAN eps 1.0, whose recluster joins all six
    clients (rounds 3-4 on the one-cluster path), and 10 rTop-k rounds at
    H 10; each round through ``drive``. Returns the launch counts summed
    over the runs and the real-gradient records."""
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.fl.engine import FederatedEngine
    from repro_torch.kernels import segmented_topk as ST

    say(f"cifar slice: fig5 at r {FIG5['r']}, k {FIG5['k']}, batch "
        f"{FIG5['batch_size']}, lr {FIG5['lr']}; cuts from the paper: H "
        f"{FIG5['H']} -> {FIG5_CUT['H']} and M {FIG5['M']} -> "
        f"{FIG5_CUT['M']} for the 20 rAge-k and 10 rTop-k rounds, 1,400 "
        f"rounds -> 20; 2 rounds at the paper's H {FIG5['H']}")
    cifar_repeat(torch, dev, shards, test)
    total = {}

    def add(launches):
        for key, v in launches.items():
            total[key] = total.get(key, 0) + v

    torch.cuda.reset_peak_memory_stats()
    eng = FederatedEngine("cnn", shards, test, RAgeKConfig(**FIG5), seed=0)
    launches, t_rounds, m = drive(eng, 2, ("rage_k", "segmented"))
    add(launches)
    peak = torch.cuda.max_memory_allocated()
    say(f"cifar slice: 2 rAge-k rounds at H {FIG5['H']} on "
        f"{torch.cuda.get_device_name(0)}: round ms "
        + ", ".join(f"{t * 1e3:.1f}" for t in t_rounds)
        + f" ({t_rounds[-1] * 1e3 / FIG5['H']:.3f} ms per local step in "
        f"round 2, the {FIG5['H']}-step draw included); losses mean "
        f"{float(m['losses'].mean()):.4f}; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}")
    del eng, m
    torch.cuda.empty_cache()

    hp = RAgeKConfig(**{**FIG5, **FIG5_CUT})
    eng = FederatedEngine("cnn", shards, test, hp, seed=0)
    t_all = []
    for first in range(1, 21, hp.M):
        cs = (eng._num_seg, min(eng._max_seg, eng.n))
        launches, t_rounds, m = drive(eng, hp.M, ("rage_k", "segmented"))
        add(launches)
        t_all += t_rounds
        labels = eng.cluster_of.tolist()
        say(f"cifar slice: rAge-k rounds {first}-{first + hp.M - 1} selected "
            f"on (C, S) = {cs}: median round "
            f"{statistics.median(t_rounds) * 1e3:.1f} ms, losses mean "
            f"{float(m['losses'].mean()):.4f}; recluster at round "
            f"{first + hp.M - 1}: labels {labels} ({_groups_matched(labels)}"
            f"), next (C, S) = ({eng._num_seg}, {eng._max_seg})")
    median = statistics.median(t_all[1:])
    acc = eng.eval_acc()
    say(f"cifar slice: 20 rAge-k rounds at H {hp.H}: median round "
        f"{median * 1e3:.2f} ms ({median * 1e3 / hp.H:.3f} ms per local "
        f"step), recluster {eng.recluster_s * 1e3:.1f} ms in all; acc "
        f"{acc:.4f}")
    real = cifar_real_times(torch, eng)
    if profile:
        phase_profile(torch, eng, median, rounds=3)
    del eng, m
    torch.cuda.empty_cache()

    # the one-cluster path: DBSCAN's eps 1.0 puts every client within
    # reach, so the round-2 recluster joins all six and rounds 3-4 select
    # them as one cluster, on segmented_age_topk's device-memory path
    one = FederatedEngine("cnn", shards, test, RAgeKConfig(
        **{**FIG5, **FIG5_CUT, "M": 2, "eps": 1.0}), seed=0)
    add(drive(one, 2, ("rage_k", "segmented"))[0])
    cs = (one._num_seg, one._max_seg)
    if cs != (1, one.n):
        raise AssertionError(f"eps 1.0 clustered {one.cluster_of.tolist()}")
    launches, t_rounds, m = drive(one, 2, ("rage_k", "segmented"))
    add(launches)
    say(f"cifar slice: one cluster (M 2, eps 1.0): labels "
        f"{one.cluster_of.tolist()} after round 2, rounds 3-4 selected on "
        f"(C, S) = {cs}, the {ST.layout(cs[1], hp.r, hp.k)['path']} path of "
        f"segmented_age_topk: median round "
        f"{statistics.median(t_rounds) * 1e3:.1f} ms, losses mean "
        f"{float(m['losses'].mean()):.4f}, launches {launches}")
    del one, m

    rtop = FederatedEngine("cnn", shards, test,
                           RAgeKConfig(**{**FIG5, **FIG5_CUT},
                                       method="rtop_k"), seed=0)
    launches, t_rounds, m = drive(rtop, 10, ("rtop_k", "segmented"))
    add(launches)
    if rtop.cluster_of.tolist() != list(range(rtop.n)):
        raise AssertionError(f"cnn rtop_k reclustered: "
                             f"{rtop.cluster_of.tolist()}")
    say(f"cifar slice: 10 rTop-k rounds at H {hp.H}: median round "
        f"{statistics.median(t_rounds[1:]) * 1e3:.2f} ms, losses mean "
        f"{float(m['losses'].mean()):.4f}, acc {rtop.eval_acc():.4f}; "
        f"launches {launches}")
    say(f"cifar slice: kernel launches {total}")
    return total, real


# the chunked driver (run_scanned), fig3: (method, selection, rounds), each
# run bitwise against the step driver from the same seed
CHUNKED_FIG3 = [("rage_k", "segmented", 20), ("rtop_k", "segmented", 20),
                ("cafe", "segmented", 5), ("top_k", "segmented", 5),
                ("random_k", "segmented", 5), ("dense", "segmented", 5),
                ("rage_k", "scan", 5)]
# fig5 chunked: 10 rAge-k rounds at H 10 and M 5 (one recluster inside, one
# at the end); the bitwise comparison at H 10 and M 2 (reclusters at rounds
# 2 and 4) under device.deterministic()
FIG5_CHUNK = dict(H=10, M=5)
FIG5_DET = dict(H=10, M=2)
# the rates in turns: fig3 windows of 20 rounds (M 20: one recluster at
# each window's end, both drivers), three of each driver after two warm-up
# windows (rAge-k's graphs for the singletons and the label pairs are
# then captured); fig5 windows of 10 rounds at H 10 with M past the
# window (no capture inside it), after a warm-up round
RATE_FIG3 = (20, 3)
RATE_FIG5 = dict(H=10, M=1000)
# the kernels of the port's library, by device name: at fig3 each C entry
# enqueues one of them
LIB_KERNELS = {"block_counts_kernel", "row_sum_kernel", "report_kernel",
               "emit_kernel", "segmented_age_topk_kernel", "fill_keys_kernel",
               "walk_kernel", "run_kernel", "merge_kernel",
               "accumulate_kernel", "maghist_blocks_kernel"}


def same_run(torch, ea, ra, eb, rb) -> list:
    """What differs, bitwise, between two engines' runs: the FLResult
    columns and every buffer of the engine state (the error-feedback
    memory too). Empty when equal."""
    import numpy as np
    from repro_torch.fl import client as C

    bad = [key for key in ("rounds", "loss", "acc", "uplink_bytes",
                           "n_active", "aoi_mean", "aoi_peak", "age_mean",
                           "age_peak", "n_quarantined", "n_crashed",
                           "n_dropped")
           if not np.array_equal(getattr(ra, key), getattr(rb, key),
                                 equal_nan=key == "loss")]
    if len(ra.requested) != len(rb.requested) or not all(
            (a is None and b is None) or np.array_equal(a, b)
            for a, b in zip(ra.requested, rb.requested)):
        bad.append("requested")
    if len(ra.cluster_labels) != len(rb.cluster_labels) or not all(
            np.array_equal(a, b)
            for a, b in zip(ra.cluster_labels, rb.cluster_labels)):
        bad.append("cluster_labels")

    def state(e):
        return {"g_params": e.g_params,
                **{f"g_opt.{i}": t for i, t in enumerate(e.g_opt_state)},
                **{f"opt_s.{i}": t for i, t in enumerate(e.opt_s)},
                **{f"bn.{i}": t
                   for i, t in enumerate(C.tree_leaves(e.state_s))},
                **{k: t for k, t in e.age._asdict().items()
                   if t is not None},
                **e.samp._asdict(), **e.sched._asdict()}
    sa, sb = state(ea), state(eb)
    bad += [k for k in sa if not torch.equal(sa[k], sb[k])]
    if (ea.ef_mem is None) != (eb.ef_mem is None) or (
            ea.ef_mem is not None and not torch.equal(ea.ef_mem, eb.ef_mem)):
        bad.append("ef_mem")
    return bad


def drive_chunked(torch, eng, rounds: int, path, eval_every: int,
                  driver: str = "run_scanned"):
    """``eng.run_scanned(rounds)`` (or ``driver``) with every launch count
    set to 0 just before: the counts read just after must be ``rounds``
    times the kernels of ``PER_ROUND[path]`` (eager rounds counted as they
    launch, replays by their graph's tally), and each graph's tally
    exactly one round's kernels. Returns (counts, result, host seconds)."""
    import numpy as np
    from repro_torch.kernels import build

    want = {k: PER_ROUND[path].get(k, 0) for k in build.LAUNCHES}
    build.reset_launches()
    t0 = time.perf_counter()
    res = getattr(eng, driver)(rounds, eval_every=eval_every)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    if launches != {k: rounds * v for k, v in want.items()}:
        raise AssertionError(f"{path} chunked: {rounds} rounds launched "
                             f"{launches}, expected {want} a round")
    for key, (_, tally, _) in eng._graphs.items():
        if tally != want:
            raise AssertionError(f"{path} graph {key}: a replay launches "
                                 f"{tally}, expected {want}")
    if not np.isfinite(res.loss).all():
        raise AssertionError(f"{path} chunked: non-finite losses")
    return launches, res, dt


def sync_free_chunk(torch, eng, rounds: int):
    """``rounds`` replays of ``eng``'s graph for its current packing bounds
    under ``torch.cuda.set_sync_debug_mode("error")``: a chunk's replays
    and metric stacks make no host sync (the counterpart of the
    reference's ``test_scanned_chunk_is_transfer_free``). The engine is
    left without its bookkeeping: call it last."""
    if eng._graph_key() not in eng._graphs:
        eng.run_scanned(1, eval_every=1)            # captures (it syncs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fs, ints = eng._chunk(rounds)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # losses are NaN outside a partial round: each round needs a finite
    # one, and nothing may be infinite
    if (fs.shape[0] != rounds or torch.isinf(fs).any()
            or not fs[:, :eng.n].isfinite().any(dim=1).all()
            or not fs[:, eng.n:].isfinite().all()):
        raise AssertionError("a replayed chunk gave non-finite metrics")


def tally_against_profiler(torch, eng, rounds: int = 10) -> int:
    """The library's kernels that ``torch.profiler`` sees in ``rounds``
    replays of ``eng``'s graph against the graph's tally times
    ``rounds`` (at fig3 each C entry enqueues one kernel). Returns the
    count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if eng._graph_key() not in eng._graphs:
        eng.run_scanned(1, eval_every=1)
    tally = eng._graphs[eng._graph_key()][1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng._chunk(rounds)
        torch.cuda.synchronize()
    seen = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and kernel_name(e.name) in LIB_KERNELS)
    if seen != rounds * sum(tally.values()):
        raise AssertionError(f"the profiler saw {seen} of the library's "
                             f"kernels in {rounds} replays; the tally says "
                             f"{rounds} x {tally}")
    return seen


def phase_chunked(torch, shards, test):
    """fig3 through ``run_scanned``: each ``CHUNKED_FIG3`` path chunked
    against ``run`` from the same seed, bitwise (FLResult and engine
    state), every launch by ``drive_chunked``; the rAge-k run's five label
    pairs at round 20 from the recluster worker. Then, on the rAge-k and
    rTop-k engines, a chunk of replays under the sync check and the tally
    against the profiler. Returns the chunked runs' launch counts."""
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.fl.engine import FederatedEngine

    total = {}
    for method, selection, rounds in CHUNKED_FIG3:
        hp = RAgeKConfig(**FIG3, method=method)
        step = FederatedEngine("mlp", shards, test, hp, seed=0,
                               selection=selection)
        t0 = time.perf_counter()
        rs = step.run(rounds, eval_every=rounds)
        ts = time.perf_counter() - t0
        eng = FederatedEngine("mlp", shards, test, hp, seed=0,
                              selection=selection)
        launches, rc, tc = drive_chunked(torch, eng, rounds,
                                         (method, selection), rounds)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        name = f"{method}/{selection}"
        bad = same_run(torch, step, rs, eng, rc)
        if bad:
            raise AssertionError(f"chunked {name}: differs from the step "
                                 f"driver in {bad}")
        labels = rc.cluster_labels[-1].tolist()
        if method == "rage_k" and rounds == 20 and labels != PAIRS:
            raise AssertionError(f"chunked rage_k: clusters {labels} at "
                                 f"round 20, expected {PAIRS}")
        say(f"chunked: fig3 {name}, {rounds} rounds: bitwise the step "
            f"driver (losses, picks, ages, counts, labels, params, every "
            f"state buffer); graphs {sorted(eng._graphs, key=str)}, "
            f"labels {labels}; {tc * 1e3:.1f} ms (captures included) "
            f"against stepwise {ts * 1e3:.1f} ms; launches {launches}")
        if (method, selection) in (("rage_k", "segmented"),
                                   ("rtop_k", "segmented")):
            seen = tally_against_profiler(torch, eng)
            sync_free_chunk(torch, eng, 5)
            say(f"chunked: {name}: 10 replays, the profiler's count of "
                f"the library's kernels {seen} == the tally; 5 replays "
                f"under set_sync_debug_mode('error'): no host sync")
        eng.close()
        step.close()
    return total


def profile_window(torch, fn, rounds: int) -> dict:
    """``fn`` (``rounds`` rounds) under ``torch.profiler``: host ms, device
    busy ms (``busy_union_us``), ``cudaLaunchKernel`` and
    ``cudaGraphLaunch`` calls, each per round."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    calls = {e.key: e.count for e in prof.key_averages()
             if e.key in ("cudaLaunchKernel", "cudaGraphLaunch")}
    return dict(ms=wall * 1e3 / rounds,
                busy_ms=busy_union_us(prof) / rounds / 1e3,
                launch_kernel=calls.get("cudaLaunchKernel", 0) / rounds,
                graph_launch=calls.get("cudaGraphLaunch", 0) / rounds)


def _rates(torch, engines: dict, rounds: int, order: str, label: str,
           profile_rounds: int = 0):
    """Windows of ``rounds`` rounds (an eval at each window's end) of the
    two engines in ``order`` ("S" the step driver, "C" the chunked one),
    host clock after a sync; with ``profile_rounds``, one more window of
    that many rounds of each under the profiler."""
    def drive(v, n):
        eng = engines[v]
        return (eng.run if v == "S" else eng.run_scanned)(n, eval_every=n)

    times = {"S": [], "C": []}
    for v in order:
        graphs = len(engines[v]._graphs)
        t0 = time.perf_counter()
        drive(v, rounds)
        torch.cuda.synchronize()
        times[v].append((time.perf_counter() - t0) * 1e3 / rounds)
        if len(engines[v]._graphs) != graphs:
            say(f"  ({label}: a capture fell inside a {v} window)")
    say(f"rates: {label}, windows of {rounds} rounds in turns {order}: "
        f"step driver " + ", ".join(f"{t:.3f}" for t in times["S"])
        + " ms a round; chunked " + ", ".join(f"{t:.3f}" for t in times["C"])
        + f" ms a round (medians {statistics.median(times['S']):.3f} / "
        f"{statistics.median(times['C']):.3f})")
    for v in "SC" if profile_rounds else "":
        p = profile_window(torch, lambda: drive(v, profile_rounds),
                           profile_rounds)
        say(f"  profiled {label} {'step' if v == 'S' else 'chunked'}, "
            f"{profile_rounds} rounds: {p['ms']:.3f} ms a round, device busy "
            f"{p['busy_ms']:.3f} ms ({100 * p['busy_ms'] / p['ms']:.1f}%), "
            f"cudaLaunchKernel {p['launch_kernel']:.1f} and cudaGraphLaunch "
            f"{p['graph_launch']:.1f} a round")
    return times


def phase_rates_fig3(torch, shards, test, profile: bool):
    """fig3 rAge-k and rTop-k, the step driver against the chunked one in
    turns (``RATE_FIG3``), after two warm-up windows of each."""
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.fl.engine import FederatedEngine

    rounds, turns = RATE_FIG3
    for method in ("rage_k", "rtop_k"):
        hp = RAgeKConfig(**FIG3, method=method)
        engines = {v: FederatedEngine("mlp", shards, test, hp, seed=0)
                   for v in "SC"}
        engines["S"].run(2 * rounds, eval_every=rounds)
        engines["C"].run_scanned(2 * rounds, eval_every=rounds)
        _rates(torch, engines, rounds, "SCCSSC"[:2 * turns],
               f"fig3 {method}", rounds if profile else 0)
        for eng in engines.values():
            eng.close()


def phase_cifar_chunked(torch, shards, test, profile: bool):
    """fig5 through ``run_scanned``: 2 rAge-k rounds at the paper's H 100
    (the second a replay of the whole round), then 10 at H 10, M 5 on
    cuDNN's default algorithms (capture time and the graphs' pool size;
    the labels at each recluster); the draw's cost at H 100; 4 rounds
    chunked against 4 stepwise at H 10, M 2 under
    ``device.deterministic()``, bitwise; 4 rounds at M 2, eps 1.0, whose
    rounds 3-4 replay the (1, 6) one-cluster graph; the rates at H 10 in
    turns. Returns the chunked runs' launch counts."""
    import gc

    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.device import deterministic
    from repro_torch.fl.engine import FederatedEngine

    total = {}
    path = ("rage_k", "segmented")

    def add(launches):
        for key, v in launches.items():
            total[key] = total.get(key, 0) + v

    def timed_captures(eng):
        spans = []
        capture = eng._graphs._capture

        def timed(body, key):
            t0 = time.perf_counter()
            out = capture(body, key)
            torch.cuda.synchronize()
            spans.append((key, time.perf_counter() - t0))
            return out
        eng._graphs._capture = timed
        return spans

    def pool_bytes():
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", (0, 0))) != (0, 0))

    # the paper's H 100: round 1 eager, then its capture; round 2 a replay
    eng = FederatedEngine("cnn", shards, test, RAgeKConfig(**FIG5), seed=0)
    spans = timed_captures(eng)
    torch.cuda.reset_peak_memory_stats()
    launches, res, dt = drive_chunked(torch, eng, 2, path, 2)
    add(launches)
    say(f"cifar chunked: 2 rAge-k rounds at the paper's H {FIG5['H']}: "
        f"round 1 and the capture {spans[0][1]:.2f} s, round 2 (a replay of "
        f"{FIG5['H']} local steps) and the eval {dt - spans[0][1]:.2f} s; "
        f"graphs' pool {pool_bytes() / 2**30:.2f} GiB, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses "
        f"{res.loss}; launches {launches}")
    eng.close()
    del eng, res
    gc.collect()
    torch.cuda.empty_cache()

    hp = RAgeKConfig(**{**FIG5, **FIG5_CHUNK})
    eng = FederatedEngine("cnn", shards, test, hp, seed=0)
    spans = timed_captures(eng)
    torch.cuda.reset_peak_memory_stats()
    launches, res, dt = drive_chunked(torch, eng, 10, path, hp.M)
    add(launches)
    peak = torch.cuda.max_memory_allocated()
    pool = pool_bytes()
    replay_ms = ((dt - sum(t for _, t in spans)) * 1e3
                 / (10 - len(spans)))
    say(f"cifar chunked: 10 rAge-k rounds at H {hp.H}, M {hp.M} on "
        f"cuDNN's default algorithms: {dt:.2f} s ({replay_ms:.1f} ms a "
        f"replayed round, evals and reclusters included; the first round of "
        f"each key eager, then its capture: "
        + ", ".join(f"{k} {t:.2f} s" for k, t in spans)
        + f"); labels {[l.tolist() for l in res.cluster_labels]} at rounds "
        f"{res.rounds}; graphs' pool {pool / 2**30:.2f} GiB, peak device "
        f"memory {peak / 2**30:.2f} GiB; losses {res.loss}; launches "
        f"{launches}")
    store = eng._store
    h = FIG5["H"]
    draw_ms = device_ms(lambda: store.draw(eng._data, eng.samp, h), reps=5,
                        warmup=1)
    # the permutations a draw of H steps hashes and sorts: W a row
    W = (h - 1) // store._epoch_batches + 1
    rows = torch.arange(store.n, device=store.device)
    ahead = eng.samp.epoch.unsqueeze(1) + torch.arange(
        1, W + 1, device=store.device)
    perm_ms = device_ms(lambda: store._perm(rows, store.data[2], ahead))
    say(f"cifar chunked: the draw at H {h}: {draw_ms:.3f} ms on the device, "
        f"of which its {W} permutations a row of (6, {store.capacity}) "
        f"{perm_ms:.4f} ms")
    eng.close()
    del eng, res
    gc.collect()
    torch.cuda.empty_cache()

    with deterministic():
        hp = RAgeKConfig(**{**FIG5, **FIG5_DET})
        step = FederatedEngine("cnn", shards, test, hp, seed=0)
        rs = step.run(4, eval_every=2)
        eng = FederatedEngine("cnn", shards, test, hp, seed=0)
        launches, rc, dt = drive_chunked(torch, eng, 4, path, 2)
        add(launches)
        bad = same_run(torch, step, rs, eng, rc)
    if bad:
        raise AssertionError(f"cifar chunked under deterministic(): differs "
                             f"from the step driver in {bad}")
    say(f"cifar chunked: 4 rounds at H {hp.H}, M {hp.M} under "
        f"device.deterministic(): bitwise the step driver (losses, picks, "
        f"ages, counts, labels {[l.tolist() for l in rc.cluster_labels]}, "
        f"params, BatchNorm state, every buffer); graphs "
        f"{sorted(eng._graphs, key=str)}")
    for e in (eng, step):
        e.close()
    del eng, step
    gc.collect()
    torch.cuda.empty_cache()

    one = FederatedEngine("cnn", shards, test, RAgeKConfig(
        **{**FIG5, **FIG5_CUT, "M": 2, "eps": 1.0}), seed=0)
    launches, res, dt = drive_chunked(torch, one, 4, path, 2)
    add(launches)
    if (one.n, 1, one.n) not in one._graphs:        # (rows, C, S)
        raise AssertionError(f"eps 1.0 chunked: graphs {list(one._graphs)}, "
                             f"labels {one.cluster_of.tolist()}")
    say(f"cifar chunked: one cluster (M 2, eps 1.0): graphs "
        f"{sorted(one._graphs, key=str)}, rounds 3-4 on (1, 6) (round 4 a "
        f"replay), labels {[l.tolist() for l in res.cluster_labels]}; "
        f"launches {launches}")
    one.close()
    del one
    gc.collect()
    torch.cuda.empty_cache()

    hp = RAgeKConfig(**{**FIG5, **RATE_FIG5})
    engines = {v: FederatedEngine("cnn", shards, test, hp, seed=0)
               for v in "SC"}
    engines["S"].run(1, eval_every=1)
    engines["C"].run_scanned(1, eval_every=1)
    _rates(torch, engines, 10, "SC", f"fig5 H {hp.H}", 3 if profile else 0)
    for e in engines.values():
        e.close()
    return total


# ---------------------------------------------------------------------------
# the participation and compute planes and error feedback
# ---------------------------------------------------------------------------

# the three FL kernels on a partial round's inputs: the report on the m = 2
# gathered rows at fig3 and fig5; the selection on partial packings (fig3
# after the first recluster, fig5 after its first); the aggregation with
# half of the clients' rows at the sentinel d
PARTIAL_REPORT = [(2, 39_760, 75), (2, 2_515_338, 2500)]
PARTIAL_SEG = [(5, 2, 75, 10), (3, 2, 2500, 100)]
PARTIAL_SA = [(10, 10, 39_760), (6, 100, 2_515_338)]
# the fig3 participation slice: 20 rounds of each at the paper's
# hyper-parameters (schedule, participation m, deadline s, compute)
PARTIAL_FIG3 = [("uniform", 2, 0.0, "gathered"), ("aoi", 2, 0.0, "gathered"),
                ("deadline", 0, 1.0, "masked")]
# benchmarks/ablation.py's rAge-k with error feedback (full participation)
ABLATION_EF = dict(r=75, k=10, H=4, M=20, lr=2e-3, batch_size=64)
# benchmarks/engine_bench.py::_active_compute: 32 clients of 100 samples,
# rAge-k r 75, k 10, H 4, batch 32, lr 2e-3, uniform m of {32, 8, 2}
COMPUTE_PLANE = dict(r=75, k=10, H=4, M=1000, lr=2e-3, batch_size=32)
COMPUTE_M = (32, 8, 2)
# fig5 partial: uniform m 2 of the 6 clients at H 10 (M past the run)
FIG5_PARTIAL = dict(H=10, M=1000, schedule="uniform", participation_m=2)


def partial_kernels_check(torch, dev, gen) -> dict:
    """The three FL kernels on a partial round's inputs against their
    plain versions: the report on the m gathered rows (``PARTIAL_REPORT``)
    card == CPU exactly, on rows with the ``SPECIAL`` values and on
    ``torch.randn`` rows, beside ``torch.topk``; ``segmented_age_topk`` on
    partial packings (``segment_pack`` with an active mask; cluster 0 has
    no active member, so its slots are all invalid and read the clipped
    row N - 1) exactly, with and without ``disjoint``, int64 and int32
    candidates; ``sparse_aggregate`` with half of the rows at the sentinel
    d and zero values, one row's values halved (a stale arrival), bitwise
    the upload-order sum. Device times at each shape beside the bound.
    Returns {kernel name: [records]}."""
    from repro_torch.core.strategies import segment_pack
    from repro_torch.kernels import ops
    from repro_torch.kernels import report as RP
    from repro_torch.kernels import segmented_topk as ST
    from repro_torch.kernels import sparse_aggregate as SA

    out = {"threshold_topk_batch": [], "segmented_age_topk": [],
           "sparse_aggregate": []}
    for n, d, r in PARTIAL_REPORT:
        for G in (grads(torch, n, d, gen, dev),
                  torch.randn((n, d), generator=gen, device=dev)):
            if not torch.equal(ops.threshold_topk_batch(G, r).cpu(),
                               ops.threshold_topk_batch(G.cpu(), r)):
                raise AssertionError(f"the report differs on gathered rows "
                                     f"{(n, d)}, r {r}")
        b, by = bound(4 * n * d + 4 * n * r, n * d)
        t = dict(n=n, d=d, r=r,
                 ms=device_ms(lambda: ops.threshold_topk_batch(G, r)),
                 plain_ms=device_ms(
                     lambda: RP.threshold_topk_batch_plain(G, r)),
                 bound_ms=b, bound_by=by,
                 library_ms=device_ms(lambda: torch.topk(G.abs(), r, dim=1)))
        say(f"  partial: threshold_topk_batch on the m={n} gathered rows "
            f"d={d} r={r}: kernels {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f}, torch.topk {t['library_ms']:.4f}, bound "
            f"{b:.6f} ({by})")
        out["threshold_topk_batch"].append(t)
    for C, S, r, k in PARTIAL_SEG:
        n = C * S
        cluster_of = torch.arange(n, device=dev) // S
        active = torch.rand(n, generator=gen, device=dev) < 0.5
        active[:S] = False
        active[S] = True
        members = segment_pack(cluster_of, C, S, active)
        valid = members < n
        cands = torch.stack([torch.randperm(3 * r, generator=gen,
                                            device=dev)[:r]
                             for _ in range(n)])
        cand = cands[members.clamp(max=n - 1).long()]
        age = torch.randint(0, 4, (C, S, r), generator=gen,
                            device=dev).int()
        for c in (cand, cand.int()):
            for disjoint in (True, False):
                got = ST.segmented_age_topk(c, age, valid, k,
                                            disjoint=disjoint)
                want = ST.segmented_age_topk_plain(c, age, valid, k,
                                                   disjoint=disjoint)
                if not torch.equal(got, want):
                    raise AssertionError(f"segmented_age_topk differs on a "
                                         f"partial packing {(C, S, r, k)}")
        b, by = bound(4 * (2 * C * S * r + C * S + C * S * k),
                      C * S * k * r)
        t = dict(C=C, S=S, r=r, k=k, valid=int(valid.sum()),
                 ms=device_ms(lambda: ST.segmented_age_topk(cand, age, valid,
                                                            k)),
                 plain_ms=device_ms(lambda: ST.segmented_age_topk_plain(
                     cand, age, valid, k)),
                 bound_ms=b, bound_by=by, library_ms=None)
        say(f"  partial: segmented_age_topk C={C} S={S} r={r} k={k} with "
            f"{t['valid']} valid members (cluster 0 none): kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, bound {b:.7f} "
            f"({by})")
        out["segmented_age_topk"].append(t)
    for n, k, d in PARTIAL_SA:
        idx = torch.stack([torch.randperm(d, generator=gen, device=dev)[:k]
                           for _ in range(n)]).int()
        vals = torch.randn((n, k), generator=gen, device=dev)
        vals[1] *= 0.5
        idx[n // 2:] = d
        vals[n // 2:] = 0.0
        idx, vals = idx.reshape(-1), vals.reshape(-1)
        age = torch.randint(0, 30, (d,), generator=gen, device=dev).int()
        dense, new_age = SA.sparse_aggregate(idx, vals, age)
        if not (torch.equal(dense.cpu(),
                            _upload_order_sum(torch, idx, vals, d))
                and torch.equal(new_age,
                                SA.sparse_aggregate_plain(idx, vals,
                                                          age)[1])):
            raise AssertionError(f"sparse_aggregate differs on sentinel rows "
                                 f"{(n, k, d)}")
        idx64 = idx.long()
        b, by = bound(8 * n * k + 12 * d, n * k)
        t = dict(nk=n * k, d=d, sentinel=n // 2 * k,
                 ms=device_ms(lambda: SA.sparse_aggregate(idx, vals, age)),
                 plain_ms=device_ms(
                     lambda: SA.sparse_aggregate_plain(idx, vals, age)),
                 bound_ms=b, bound_by=by,
                 library_ms=device_ms(lambda: torch.zeros(
                     d + 1, device=dev).index_add_(
                     0, idx64.clamp(max=d), vals)))
        say(f"  partial: sparse_aggregate NK={n * k} ({n // 2} of {n} rows "
            f"at the sentinel) d={d}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f}, index_add_ {t['library_ms']:.4f}, bound "
            f"{b:.6f} ({by})")
        out["sparse_aggregate"].append(t)
    return out


def _plan_to(plan, dev):
    from repro_torch.fl.schedule import RoundPlan
    return RoundPlan(*(t.to(dev) for t in plan[:3]), plan.m)


def _partial_round(torch, card, cpu, plan):
    """One round of ``card`` and ``cpu`` from the same batches and the
    handed-in ``plan`` (gathered: the active rows, ``draw_gathered``).
    Returns the two rounds' tensors."""
    act_idx = (card._compact(plan.active)
               if card._compute == "gathered" else None)
    if act_idx is not None:
        bx, by, _ = card._store.draw_gathered(card._data, card.samp,
                                              card.hp.H, act_idx)
    else:
        bx, by, _ = card._store.draw(card._data, card.samp, card.hp.H)
    mc = card._round_impl(bx, by, plan)
    mh = cpu._round_impl(bx.cpu(), by.cpu(), _plan_to(plan, "cpu"))
    torch.cuda.synchronize()
    return mc, mh


def phase_partial_parity(torch, dev, shards, test):
    """One fig3 round on the card and on the CPU from the same params,
    batches and plan (handed to both): a uniform m 2 plan (the card's
    ``UniformM`` at round 0) and a deadline plan (the card's ``Deadline``
    at round 3), each gathered and masked, for rAge-k (segmented and
    scan), rTop-k, CAFe and dense; and rAge-k with error feedback.
    Indices, ages and request counts exactly (rTop-k: the reports equal);
    losses (NaN outside the round), the aggregate, the new params and the
    ef memory within ``phase_parity``'s rtol=1e-4, atol=1e-6."""
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.core.strategies import topr_candidates
    from repro_torch.fl.engine import FederatedEngine
    from repro_torch.fl.schedule import SchedState, make_scheduler

    tol = dict(rtol=1e-4, atol=1e-6)
    n = len(shards)
    plans = {}
    for name, schedule, rnd in (("uniform m 2", "uniform", 0),
                                ("deadline 1.0", "deadline", 3)):
        sched = make_scheduler(schedule, n, participation_m=2,
                               deadline_s=1.0, seed=41, device=dev)
        st = SchedState.create(n, 23, dev)._replace(
            rnd=torch.tensor(rnd, dtype=torch.int32, device=dev))
        plans[name] = (schedule, sched.plan(st))
    cases = [(m, sel, name, compute, False)
             for name in plans for compute in ("gathered", "masked")
             for m, sel in (("rage_k", "segmented"), ("rage_k", "scan"),
                            ("rtop_k", "segmented"), ("cafe", "segmented"),
                            ("dense", "segmented"))]
    cases += [("rage_k", "segmented", "uniform m 2", "gathered", True)]
    for method, selection, pname, compute, ef in cases:
        schedule, plan = plans[pname]
        hp = RAgeKConfig(**FIG3, method=method, schedule=schedule,
                         participation_m=2, deadline_s=1.0)
        card, cpu = (FederatedEngine("mlp", shards, test, hp, seed=0,
                                     device=where, selection=selection,
                                     compute=compute, ef=ef)
                     for where in (dev, "cpu"))
        mc, mh = _partial_round(torch, card, cpu, plan)
        name = (f"{method}/{selection} {pname} {compute}"
                + (" ef" if ef else ""))
        torch.testing.assert_close(mc["losses"].cpu(), mh["losses"],
                                   equal_nan=True, **tol)
        if method == "rtop_k":
            reports = [topr_candidates(m["G"], hp.r, hp.candidates).cpu()
                       for m in (mc, mh)]
            if not torch.equal(*reports):
                raise AssertionError(f"{name}: candidate reports differ")
        elif method == "dense":
            if mc["idx"] is not None or mh["idx"] is not None:
                raise AssertionError(f"{name}: dense requested indices")
        elif not torch.equal(mc["idx"].cpu(), mh["idx"]):
            raise AssertionError(f"{name}: requested indices differ")
        if method != "rtop_k":
            torch.testing.assert_close(mc["g_sum"].cpu(), mh["g_sum"], **tol)
            torch.testing.assert_close(card.g_params.cpu(), cpu.g_params,
                                       **tol)
        if ef:
            torch.testing.assert_close(card.ef_mem.cpu(), cpu.ef_mem, **tol)
        if not (torch.equal(card.age.cluster_age.cpu(), cpu.age.cluster_age)
                and torch.equal(card.age.freq.cpu(), cpu.age.freq)):
            raise AssertionError(f"{name}: ages or request counts differ")
        err = float((mc["g_sum"].cpu() - mh["g_sum"]).abs().max())
        say(f"partial parity: one fig3 {name} round card == CPU "
            f"({int(plan.active.sum())} active, "
            f"{int((plan.staleness > 0).sum())} stale; "
            + ("reports equal" if method == "rtop_k"
               else "indices, ages, counts exact")
            + f"; max |g_sum diff| {err:.3e})")


def _deadline_discipline(torch, eng, rounds: int, n_active) -> str:
    """The deadline's staleness discipline over ``rounds`` rounds, from
    the engine's scheduler recomputing each round's times: a client late
    at t - 1 arrives at t, fresh if on time, else stale at weight
    ``discount``; none stale at round 0; the run's participant counts
    those of the plans. Returns a summary."""
    sched, st = eng._scheduler, eng.sched
    late_prev = None
    stale_total = 0
    for t in range(rounds):
        rnd = torch.tensor(t, dtype=torch.int32, device=eng.device)
        plan = sched.plan(st._replace(rnd=rnd))
        late = sched._late(st.seed, rnd)
        stale = plan.staleness > 0
        want_stale = (late_prev & late if late_prev is not None
                      else torch.zeros_like(late))
        if not (torch.equal(stale, want_stale)
                and torch.equal(plan.active, ~late | want_stale)
                and bool((plan.weight[stale] == sched.discount).all())
                and bool((plan.weight[~stale] == 1.0).all())
                and int(plan.active.sum()) == n_active[t]):
            raise AssertionError(f"deadline round {t + 1}: staleness "
                                 f"discipline broken")
        stale_total += int(stale.sum())
        late_prev = late
    return (f"{stale_total} stale arrivals over {rounds} rounds, each late "
            f"twice running, at weight {sched.discount}")


def phase_partial_slice(torch, shards, test):
    """The participation plane at fig3's paper hyper-parameters
    (``PARTIAL_FIG3``): 20 rAge-k rounds each under uniform m 2
    (gathered), aoi m 2 (gathered) and deadline 1.0 (masked), through
    ``run`` and ``run_scanned``, bitwise equal (FLResult, every state
    buffer), every round launching exactly rAge-k's kernels (replays by
    their graph's tally); n_active 2 every round under uniform and aoi,
    the aoi peak at most ceil(N/m) = 5, the deadline's staleness
    discipline; a chunk of replays with no host sync. Then the
    ablation's rAge-k with error feedback (``ABLATION_EF``, full
    participation), 20 rounds each way, bitwise. Then the rates of the
    uniform and deadline runs, the two drivers in turns as
    ``phase_rates_fig3`` takes them. Returns the launch counts of the
    checked runs."""
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.fl.engine import FederatedEngine

    total = {}
    path = ("rage_k", "segmented")
    runs = [(f"{s} m {m}" if m else f"{s} {dl}",
             RAgeKConfig(**FIG3, schedule=s, participation_m=m,
                         deadline_s=dl), {"compute": c})
            for s, m, dl, c in PARTIAL_FIG3]
    runs.append(("ablation ef", RAgeKConfig(**ABLATION_EF), {"ef": True}))
    for name, hp, kw in runs:
        out = []
        for driver in ("run", "run_scanned"):
            eng = FederatedEngine("mlp", shards, test, hp, seed=0, **kw)
            launches, res, dt = drive_chunked(torch, eng, 20, path, 20,
                                              driver=driver)
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            out.append((eng, res, dt))
        (es, rs, ts), (ec, rc, tc) = out
        bad = same_run(torch, es, rs, ec, rc)
        if bad:
            raise AssertionError(f"partial {name}: run_scanned differs from "
                                 f"run in {bad}")
        extra = ""
        if hp.schedule in ("uniform", "aoi") and rs.n_active != [2] * 20:
            raise AssertionError(f"partial {name}: n_active {rs.n_active}")
        if hp.schedule == "aoi" and max(rs.aoi_peak) > 5:
            raise AssertionError(f"partial {name}: aoi peak "
                                 f"{max(rs.aoi_peak)} > ceil(N/m) = 5")
        if hp.schedule == "deadline":
            extra = "; " + _deadline_discipline(torch, es, 20, rs.n_active)
        sync_free_chunk(torch, ec, 5)
        say(f"partial slice: fig3 rage_k {name} ({es._compute}), 20 rounds: "
            f"run_scanned == run bitwise (losses, picks, ages, counts, "
            f"labels, params, ef memory, every state buffer); n_active "
            f"{rs.n_active}; aoi peak {max(rs.aoi_peak)}, mean "
            f"{statistics.mean(rs.aoi_mean):.2f}; labels at round 20 "
            f"{rs.cluster_labels[-1].tolist()}; loss {rs.loss[-1]:.4f}, "
            f"acc {rs.acc[-1]:.4f}; {ts * 1e3:.1f} ms stepped, "
            f"{tc * 1e3:.1f} ms chunked (captures included); graphs "
            f"{sorted(ec._graphs, key=str)}; 5 replays under "
            f"set_sync_debug_mode('error'): no host sync{extra}")
        for e in (es, ec):
            e.close()
    # the rates of the partial rounds, both drivers in turns
    rounds, turns = RATE_FIG3
    for name, hp, kw in runs[::2]:
        engines = {v: FederatedEngine("mlp", shards, test, hp, seed=0, **kw)
                   for v in "SC"}
        engines["S"].run(2 * rounds, eval_every=rounds)
        engines["C"].run_scanned(2 * rounds, eval_every=rounds)
        _rates(torch, engines, rounds, "SCCSSC"[:2 * turns],
               f"fig3 rage_k {name} ({engines['C']._compute})")
        for e in engines.values():
            e.close()
    return total


def phase_compute_plane(torch):
    """``engine_bench._active_compute``'s setting on the card: 32 clients
    of 100 samples (``COMPUTE_PLANE``), uniform m of ``COMPUTE_M``, each
    gathered and masked, through ``run_scanned`` in windows of 20 rounds,
    the variants in turns (the order, then reversed) after a warm-up
    window, then one profiled window each (device busy ms a round). Then
    m 8 gathered against masked for 5 rounds from the same seed: bitwise
    or the largest differences, printed. Returns the launch counts."""
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.data.synthetic import mnist_like
    from repro_torch.fl.engine import FederatedEngine
    from repro_torch.kernels import build

    n, per, rounds = 32, 100, 20
    (x, y), test = mnist_like(n_train=n * per, n_test=500, seed=0)
    shards = [(x[i * per:(i + 1) * per], y[i * per:(i + 1) * per])
              for i in range(n)]

    def make(m, compute):
        hp = RAgeKConfig(**COMPUTE_PLANE, schedule="uniform",
                         participation_m=m)
        return FederatedEngine("mlp", shards, test, hp, seed=0,
                               compute=compute)
    engines = {f"m {m} {c}": make(m, c) for m in COMPUTE_M
               for c in ("masked", "gathered")}
    build.reset_launches()
    for eng in engines.values():
        eng.run_scanned(rounds, eval_every=rounds)
    order = list(engines) + list(reversed(engines))
    times = {k: [] for k in engines}
    for key in order:
        t0 = time.perf_counter()
        engines[key].run_scanned(rounds, eval_every=rounds)
        torch.cuda.synchronize()
        times[key].append((time.perf_counter() - t0) * 1e3 / rounds)
    for key, eng in engines.items():
        p = profile_window(torch, lambda: eng.run_scanned(
            rounds, eval_every=rounds), rounds)
        say(f"compute plane: 32 clients, {key}: "
            + ", ".join(f"{t:.3f}" for t in times[key])
            + f" ms a round (windows of {rounds}, in turns); profiled "
            f"{p['ms']:.3f} ms a round, device busy {p['busy_ms']:.3f} ms "
            f"({100 * p['busy_ms'] / p['ms']:.1f}%)")
    launches = dict(build.LAUNCHES)
    runs = len(engines) * 4 * rounds
    if launches["segmented_age_topk"] != runs:
        raise AssertionError(f"compute plane: {launches} in {runs} rounds")
    for eng in engines.values():
        eng.close()
    pair = [make(8, c) for c in ("gathered", "masked")]
    res = [e.run_scanned(5, eval_every=5) for e in pair]
    bad = same_run(torch, pair[0], res[0], pair[1], res[1])
    diff = float((pair[0].g_params - pair[1].g_params).abs().max())
    say(f"compute plane: m 8 gathered against masked, 5 rounds from one "
        f"seed: " + ("bitwise equal" if not bad else
                     f"differ in {bad}; max |g_params diff| {diff:.3e}"))
    for e in pair:
        e.close()
    return launches


def phase_fig5_partial(torch, dev, shards, test):
    """fig5 under uniform m 2 (``FIG5_PARTIAL``: Network-2 at full width,
    6 clients, r 2,500, k 100, batch 256, H 10): gathered and masked
    through ``run_scanned``, a warm-up round each (eager, then the
    capture), then windows of 5 rounds in turns, gathered, masked,
    masked, gathered: ms a round and a local step; a profiled window of
    2 rounds each (device busy share). Then one gathered round at batch
    32, H 1 from the card's round-0 plan on the card (its batches from
    ``draw_gathered``, checked equal to ``draw``'s rows) against the
    masked round from the same plan, params, BatchNorm state and full
    batches, on the CPU and on the card: floats within rtol=1e-4,
    atol=1e-6 (a client whose ReLU inputs change sign on the card held to
    the CPU's gradient under the card's branches, as in cifar parity),
    integers exactly; and rAge-k with
    error feedback, gathered, 4 rounds chunked against 4 stepwise at M 2
    under ``device.deterministic()``, bitwise. Returns the launch
    counts."""
    import gc

    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.device import deterministic
    from repro_torch.fl import client as C
    from repro_torch.fl.engine import FederatedEngine
    from repro_torch.kernels import build

    total = {}

    def add(launches):
        for key, v in launches.items():
            total[key] = total.get(key, 0) + v

    hp = RAgeKConfig(**{**FIG5, **FIG5_PARTIAL})
    engines = {c: FederatedEngine("cnn", shards, test, hp, seed=0,
                                  compute=c) for c in ("gathered", "masked")}
    build.reset_launches()
    for eng in engines.values():
        eng.run_scanned(1, eval_every=1)
    times = {c: [] for c in engines}
    for c in ("gathered", "masked", "masked", "gathered"):
        t0 = time.perf_counter()
        engines[c].run_scanned(5, eval_every=5)
        torch.cuda.synchronize()
        times[c].append((time.perf_counter() - t0) * 1e3 / 5)
    for c, eng in engines.items():
        p = profile_window(torch, lambda: eng.run_scanned(2, eval_every=2), 2)
        ms = statistics.mean(times[c])
        say(f"fig5 partial: uniform m 2 {c}, H {hp.H}: "
            + ", ".join(f"{t:.1f}" for t in times[c])
            + f" ms a round (windows of 5), {ms / hp.H:.2f} ms a local "
            f"step; profiled 2 rounds: {p['ms']:.1f} ms a round, device busy "
            f"{p['busy_ms']:.1f} ms ({100 * p['busy_ms'] / p['ms']:.1f}%); "
            f"graphs {sorted(eng._graphs, key=str)}")
    launches = dict(build.LAUNCHES)
    if launches["segmented_age_topk"] != 2 * 13:
        raise AssertionError(f"fig5 partial: {launches} in 26 rounds")
    add(launches)
    for eng in engines.values():
        eng.close()
    del engines, eng
    gc.collect()
    torch.cuda.empty_cache()

    # one gathered round on the card at batch 32, H 1 against the CPU's
    # masked round restricted to the active rows (the CPU's own grouped
    # convolution at one or two groups is not its six-group result within
    # the tolerance; printed), and against the card's masked round
    hp = RAgeKConfig(**{**FIG5, **FIG5_PARTIAL, **FIG5_PARITY})
    card, card_m = (FederatedEngine("cnn", shards, test, hp, seed=0,
                                    compute=c) for c in ("gathered", "masked"))
    cpu_m, cpu_g = (FederatedEngine("cnn", shards, test, hp, seed=0,
                                    device="cpu", compute=c)
                    for c in ("masked", "gathered"))
    plan = card._scheduler.plan(card.sched)
    plan_h = _plan_to(plan, "cpu")
    act = plan.active.nonzero().flatten()
    bx, by, _ = card._store.draw(card._data, card.samp, hp.H)
    gx, gy, _ = card._store.draw_gathered(card._data, card.samp, hp.H,
                                          card._compact(plan.active))
    if not (torch.equal(gx, bx[act]) and torch.equal(gy, by[act])):
        raise AssertionError("fig5 partial: draw_gathered is not draw's rows")
    # the branches of the card's masked pass and the CPU's (all six
    # clients, one layout): a client whose ReLU inputs change sign is held
    # to the CPU's gradient under the card's branches (as cifar parity)
    card_br = branch_grad(torch, card_m, bx, by)[0]
    flips, flipped = flipped_clients(
        card_br, branch_grad(torch, cpu_m, bx.cpu(), by.cpu())[0],
        len(shards))
    forced = (branch_grad(torch, cpu_m, bx.cpu(), by.cpu(), card_br)[1]
              if flipped else None)
    t0 = time.perf_counter()
    mc = card._round_impl(gx, gy, plan)
    mm = card_m._round_impl(bx, by, plan)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    mh = cpu_m._round_impl(bx.cpu(), by.cpu(), plan_h)
    dt_h = time.perf_counter() - t0
    mg = cpu_g._round_impl(gx.cpu(), gy.cpu(), plan_h)
    tol = dict(rtol=1e-4, atol=1e-6)
    act_h = act.cpu()

    def floats(m, eng, rows):
        out = {"losses": m["losses"], "G": m["G"] if rows is None
               else m["G"][rows], "g_sum": m["g_sum"],
               "params": eng.g_params}
        for i, t in enumerate(C.tree_leaves(eng.state_s)):
            out[f"bn{i // 2}.{('mean', 'var')[i % 2]}"] = t
        return {k: v.cpu() for k, v in out.items()}

    def diffs(a, b):
        return {k: (float((a[k] - b[k]).nan_to_num().abs().max()),
                    int((~torch.isclose(a[k], b[k], equal_nan=True,
                                        **tol)).sum())) for k in a}

    fc = floats(mc, card, None)
    cpu_own = diffs(floats(mg, cpu_g, None), floats(mh, cpu_m, act_h))
    plain_G = float((fc["G"] - mh["G"][act_h]).abs().max())
    rows = sorted(flipped)
    if rows:
        mh = dict(mh, G=mh["G"].clone())
        mh["G"][rows] = forced[rows]
    against_cpu = diffs(fc, floats(mh, cpu_m, act_h))
    against_card = diffs(fc, floats(mm, card_m, act))
    say(f"fig5 partial parity: one gathered rage_k round (clients "
        f"{act.tolist()}, batch {hp.batch_size}, H {hp.H}) on the card "
        f"{dt:.2f} s with the masked one, the CPU's masked {dt_h:.2f} s; max "
        f"|diff| (elements past rtol 1e-4, atol 1e-6) against the CPU's "
        f"masked round: "
        + ", ".join(f"{k} {v:.3e} ({n})" for k, (v, n) in against_cpu.items())
        + "; against the card's masked round: "
        + ", ".join(f"{k} {v:.3e} ({n})" for k, (v, n)
                    in against_card.items())
        + f"; the CPU's own gathered round against its masked one (2 groups "
        f"against 6): G {cpu_own['G'][0]:.3e} ({cpu_own['G'][1]}); ReLU "
        f"inputs of another sign on the card, a ReLU call each: {flips}"
        + (f", so G's rows {rows} are the CPU's gradient under the card's "
           f"branches (against the CPU's own: max |diff| {plain_G:.3e})"
           if rows else ""))
    for k in fc:
        for want, eng in ((floats(mh, cpu_m, act_h), "the CPU's masked"),
                          (floats(mm, card_m, act), "the card's masked")):
            torch.testing.assert_close(
                fc[k], want[k], equal_nan=True, **tol,
                msg=lambda m: f"fig5 partial {k} against {eng} round: {m}")
    for m, a in ((mh, cpu_m), (mm, card_m)):
        if not (torch.equal(mc["idx"].cpu(), m["idx"].cpu())
                and torch.equal(card.age.cluster_age.cpu(),
                                a.age.cluster_age.cpu())
                and torch.equal(card.age.freq.cpu(), a.age.freq.cpu())):
            raise AssertionError("fig5 partial: picks, ages or counts differ")
    del card, card_m, cpu_m, cpu_g, mc, mm, mh, mg
    gc.collect()
    torch.cuda.empty_cache()

    with deterministic():
        hp = RAgeKConfig(**{**FIG5, **FIG5_PARTIAL, **FIG5_DET})
        step = FederatedEngine("cnn", shards, test, hp, seed=0, ef=True)
        rs = step.run(4, eval_every=2)
        eng = FederatedEngine("cnn", shards, test, hp, seed=0, ef=True)
        launches, rc, dt = drive_chunked(torch, eng, 4,
                                         ("rage_k", "segmented"), 2)
        add(launches)
        bad = same_run(torch, step, rs, eng, rc)
    if bad:
        raise AssertionError(f"fig5 partial ef under deterministic(): "
                             f"chunked differs from stepwise in {bad}")
    say(f"fig5 partial: rage_k ef=True uniform m 2 gathered, 4 rounds at H "
        f"{hp.H}, M {hp.M} under device.deterministic(): chunked == stepwise "
        f"bitwise (losses, picks, ages, counts, labels "
        f"{[l.tolist() for l in rc.cluster_labels]}, params, BatchNorm "
        f"state, ef memory); n_active {rc.n_active}; graphs "
        f"{sorted(eng._graphs, key=str)}")
    for e in (eng, step):
        e.close()
    return total


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


def _da_cut(q, k, v, clen):
    """The tile and splits ``choose_splits`` takes for this launch."""
    from repro_torch.kernels import decode_attention as DA
    DA.decode_attention(q, k, v, clen)
    c = dict(DA.LAST_CUT)
    return c, f"{c['splits']} splits of {c['tile_bytes'] // 1024} KB tiles"


def _da_check(torch, q, k, v, clen, tol, splits=None):
    """The kernel (with ``splits`` forced, or as ``choose_splits`` cuts)
    against its plain version within ``_da_close``, bitwise repeatable,
    zeros at cache_len 0. Returns (max |error|, the atol used)."""
    from repro_torch.kernels import decode_attention as DA

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


def _da_times(torch, q, k, v, clen, tol) -> dict:
    """Device times of the kernel, its plain version and SDPA (itself held
    to the plain version first) beside the bound."""
    from repro_torch.kernels import decode_attention as DA

    B, H, D = q.shape
    G = k.shape[2]
    b, by = _da_bound(B, H, G, D, min(clen, k.shape[1]), q.element_size())
    _da_close(torch, _sdpa(torch, q, k, v, clen),
              DA.decode_attention_plain(q, k, v, clen), tol)
    return dict(ms=device_ms(lambda: DA.decode_attention(q, k, v, clen)),
                plain_ms=device_ms(
                    lambda: DA.decode_attention_plain(q, k, v, clen)),
                bound_ms=b, bound_by=by,
                library_ms=device_ms(lambda: _sdpa(torch, q, k, v, clen)))


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

    def inputs(B, H, G, D, S, dtype):
        return (torch.randn((B, H, D), generator=gen, device=dev).to(dtype),
                torch.randn((B, S, G, D), generator=gen, device=dev).to(dtype),
                torch.randn((B, S, G, D), generator=gen, device=dev).to(dtype))

    for dtype, tol in DA_TOL.items():
        for H, G, D, S in DA_SWEEP:
            q, k, v = inputs(2, H, G, D, S, getattr(torch, dtype))
            err = max(_da_check(torch, q, k, v, clen, tol, splits)[0]
                      for clen in (0, 1, S - 13, S)
                      for splits in (None, 1, 2, 3, 7))
            t = _da_times(torch, q, k, v, S, tol)
            say(f"  decode_attention B=2 H={H} G={G} D={D} S={S} {dtype}: "
                f"max_abs_err {err:.3e} (rtol {tol}); at cache_len S "
                f"{_da_cut(q, k, v, S)[1]}, kernel "
                f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, sdpa "
                f"{t['library_ms']:.4f}, bound {t['bound_ms']:.6f} "
                f"({t['bound_by']})")
    B, H, G, D, S = DA_SERVE
    q, k, v = inputs(B, H, G, D, S, torch.bfloat16)
    err, atol = _da_check(torch, q, k, v, S, DA_TOL["bfloat16"])
    t = _da_times(torch, q, k, v, S, DA_TOL["bfloat16"])
    say(f"  decode_attention serve B={B} H={H} G={G} D={D} S={S} bfloat16: "
        f"max_abs_err {err:.3e} (atol {atol:.2e}); "
        f"{_da_cut(q, k, v, S)[1]}, kernel {t['ms']:.4f} ms, "
        f"plain {t['plain_ms']:.4f}, sdpa {t['library_ms']:.4f}, bound "
        f"{t['bound_ms']:.6f} ({t['bound_by']})")
    B, H, G, D, S = DA_MAIN
    q, k, v = inputs(B, H, G, D, S, torch.bfloat16)
    errs = [_da_check(torch, q, k, v, clen, DA_TOL["bfloat16"])
            for clen in (0, 1, S - 13, S)]
    err = max(e for e, _ in errs)
    t = _da_times(torch, q, k, v, S, DA_TOL["bfloat16"])
    main_cut, cut_text = _da_cut(q, k, v, S)
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


def decode_parity(torch, dev, cfg, cache_tol: float = 1e-5) -> float:
    """``cfg`` (float32) from CPU-drawn seed-0 parameters: 8 prompt and 4
    generated decode steps on the card and on the CPU, both fed the CPU's
    tokens. Logits within rtol=atol=1e-4 and every cache within
    ``cache_tol`` (cuBLAS and the CPU's BLAS sum the float32 products in
    other orders; TF32 off), the greedy tokens equal. Returns the largest
    |logit diff|."""
    from repro_torch.models import transformer as T

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
            raise AssertionError(f"{cfg.name} parity: greedy tokens differ "
                                 f"at step {t}")
        err = max(err, float((lg.cpu() - lc).abs().max()))
    for name in caches[0]:
        torch.testing.assert_close(caches[1][name].cpu(), caches[0][name],
                                   rtol=cache_tol, atol=cache_tol)
    return err


def phase_lm_parity(torch, dev):
    """internlm2-1.8b at full width with 2 layers in float32 through
    ``decode_parity``: 12 decode steps card == CPU."""
    from repro_torch.configs import get_config

    cfg = get_config(ARCH).replace(n_layers=2, dtype="float32")
    t0 = time.perf_counter()
    err = decode_parity(torch, dev, cfg)
    say(f"LM parity: {cfg.name} d={cfg.d_model} H={cfg.n_heads} "
        f"G={cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size}, "
        f"{cfg.n_layers} layers, float32: 12 decode steps card == "
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


def attention_layers(cfg) -> int:
    """``decode_attention`` launches a decode step: one per GQA layer, one
    per application of the hybrid's shared block, two per audio decoder
    layer (self and cross attention), none under MLA or in an
    attention-free SSM."""
    if cfg.use_mla or cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "audio":
        return 2 * cfg.n_layers
    return cfg.n_layers


def serve_arch(torch, dev, cfg) -> tuple:
    """``cfg`` in bfloat16 with random weights from seed 0 on the card,
    served through ``launch.serve.generate`` (batch 8, prompt 128, 32
    generated tokens): finite logits of the right shape;
    ``decode_attention`` ``attention_layers(cfg)`` times a step and no
    other kernel. Prints and returns (a record: prefill s, decode
    tokens/s, ms a step, the allocator's peak, the cache's bytes, the
    launches; the parameters, the prompts and the ``Generation``)."""
    from repro_torch.kernels import build
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T

    B, P, GEN = 8, 128, 32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = T.init(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device=dev)
    n_params = sum(w.numel() for w in _leaves(params))
    build.reset_launches()
    out = generate(params, cfg, prompts, GEN)
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    per_step = attention_layers(cfg)
    want = {k: (per_step * (P + GEN) if k == "decode_attention" else 0)
            for k in launches}
    if launches != want:
        raise AssertionError(f"serve {cfg.name}: kernel launches "
                             f"{launches}, expected {want}")
    if not out.finite or out.logits.shape != (B, cfg.padded_vocab):
        raise AssertionError(f"serve {cfg.name}: non-finite logits or a "
                             f"wrong shape")
    cache = T.init_cache(cfg, B, P + GEN, device="meta")
    cache_bytes = sum(c.numel() * c.element_size() for c in cache.values())
    rec = dict(arch=cfg.name, n_layers=cfg.n_layers, params=n_params,
               init_s=init_s, prefill_s=out.prefill_s,
               decode_tok_s=B * GEN / out.decode_s,
               ms_per_step=out.decode_s / GEN * 1e3, peak_bytes=peak,
               cache_bytes=cache_bytes, launches=launches)
    say(f"serve {cfg.name}: {cfg.n_layers} layers d={cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params bfloat16 (init {init_s:.1f} s) on "
        f"{torch.cuda.get_device_name(0)}, batch {B}, prompt {P}, {GEN} "
        f"tokens: prefill (by {P} decode steps) {out.prefill_s:.3f} s, "
        f"decode {rec['decode_tok_s']:.1f} tokens/s over the batch "
        f"({rec['ms_per_step']:.2f} ms a step), peak {peak / 2**30:.3f} "
        f"GiB, cache {cache_bytes / 2**20:.1f} MiB ({'/'.join(cache)}), "
        f"launches { {k: v for k, v in launches.items() if v} } "
        f"({per_step} decode_attention a step); first row "
        f"{out.tokens[0].tolist()}")
    return rec, params, prompts, out


def phase_serve(torch, dev, profile: bool):
    """internlm2-1.8b at full width and depth through ``serve_arch``.
    Returns the launch counts of the run."""
    from repro_torch.configs import get_config

    cfg = get_config(ARCH)
    rec, params, prompts, _ = serve_arch(torch, dev, cfg)
    if profile:
        profile_decode(torch, dev, params, cfg, prompts)
    return rec["launches"]


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def profile_decode(torch, dev, params, cfg, prompts, steps: int = 8):
    """``--profile``: ``steps`` decode steps of the serve configuration
    after a 128-token prompt, under ``torch.profiler``: host ms and device
    busy ms per step, the device's idle share, the top kernels (see
    ``profile_steps``, whose record it returns)."""
    from repro_torch.models import transformer as T

    B, P = prompts.shape
    cache = T.init_cache(cfg, B, P + steps, device=dev)
    for t in range(P):
        _, cache = T.decode_step(params, cfg, {"token": prompts[:, t]},
                                 cache, t)
    tok = prompts[:, -1]

    def run():
        for t in range(P, P + steps):
            T.decode_step(params, cfg, {"token": tok}, cache, t)
    return profile_steps(torch, run, steps)


def profile_steps(torch, run, steps: int) -> dict:
    """``run`` (``steps`` decode steps) under ``torch.profiler``: prints
    host ms and device busy ms per step, the device's idle share, the top
    device kernels and host rows; returns ms, busy ms and
    ``cudaLaunchKernel`` calls a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
    return dict(ms=wall, busy_ms=busy, launch_calls=sum(
        e.count for e in host if e.key == "cudaLaunchKernel") / steps)


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


# fig3 under the hierarchical layout: M 5, so that the reclusters at rounds
# 5 and 10 both change the live cluster count; rage_k runs 15 rounds (three
# boundaries), the other paths 5
HIER_FIG3 = dict(FIG3, M=5)
HIER_PATHS = [("rage_k", "segmented", 15), ("rage_k", "scan", 10),
              ("rtop_k", "segmented", 5), ("cafe", "segmented", 5),
              ("top_k", "segmented", 5), ("random_k", "segmented", 5),
              ("dense", "segmented", 5)]
# engine_bench's age-memory setting: N grouped shards of 8 samples in 4
# label groups, r 16, k 4, H 1, M 3, batch 8, lr 2e-3
AGE_BENCH = dict(r=16, k=4, H=1, M=3, lr=2e-3, batch_size=8)
AGE_BENCH_N = (64, 256, 1024)
# resume: fig3 at HIER_FIG3 for 20 rounds, saved every 5, resumed at 10
RESUME_FIG3 = (20, 5, 10)


def layouts_differ(torch, ea, ra, eb, rb) -> list:
    """What differs, bitwise, between a dense run and a hierarchical one:
    the FLResult columns, the frequency matrix, the labels, the params
    and the live age rows. Empty when equal."""
    import numpy as np

    bad = [key for key in ("rounds", "loss", "acc", "uplink_bytes",
                           "n_active", "aoi_mean", "aoi_peak", "age_mean",
                           "age_peak") if getattr(ra, key) != getattr(rb, key)]
    if not all((a is None and b is None) or np.array_equal(a, b)
               for a, b in zip(ra.requested, rb.requested, strict=True)):
        bad.append("requested")
    if not all(np.array_equal(a, b) for a, b in
               zip(ra.cluster_labels, rb.cluster_labels, strict=True)):
        bad.append("cluster_labels")
    if not np.array_equal(ea.freq_matrix, eb.freq_matrix):
        bad.append("freq_matrix")
    if not torch.equal(ea.g_params, eb.g_params):
        bad.append("g_params")
    live = int(ea.cluster_of.max()) + 1
    if not torch.equal(ea.age.cluster_age[:live], eb.age.cluster_age[:live]):
        bad.append("cluster_age")
    return bad


def phase_hier_fig3(torch, dev, shards, test):
    """The hierarchical age layout at fig3 (``HIER_FIG3``): each of
    ``HIER_PATHS`` dense and hierarchical from one seed, through ``run``
    and ``run_scanned``, bitwise equal (losses, picks, labels, the
    frequency matrix, params, the live age rows), every round launching
    exactly its method's kernels (``drive_chunked``); the rAge-k run's
    cluster count at each boundary, the age rows following it; a
    hierarchical chunk of replays with no host sync. Then one
    hierarchical round card == CPU from the same params and batches
    (picks, ages, the log ring, ``upload_cost`` exactly), and uniform m 2
    (gathered) likewise. Returns the hierarchical runs' launch counts."""
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.fl.engine import FederatedEngine

    total = {}
    cases = [(m, s, r, {}) for m, s, r in HIER_PATHS]
    cases.append(("rage_k", "segmented", 15,
                  {"schedule": "uniform", "participation_m": 2}))
    for method, selection, rounds, part in cases:
        name = f"{method}/{selection}" + (" uniform m 2" if part else "")
        for driver in ("run", "run_scanned"):
            out = {}
            for layout in ("dense", "hierarchical"):
                hp = RAgeKConfig(**HIER_FIG3, method=method,
                                 age_layout=layout, **part)
                eng = FederatedEngine("mlp", shards, test, hp, seed=0,
                                      selection=selection)
                launches, res, dt = drive_chunked(
                    torch, eng, rounds, (method, selection), 5,
                    driver=driver)
                if layout == "hierarchical":
                    for k, v in launches.items():
                        total[k] = total.get(k, 0) + v
                out[layout] = (eng, res, dt)
            (ed, rd, td), (eh, rh, th) = out["dense"], out["hierarchical"]
            bad = layouts_differ(torch, ed, rd, eh, rh)
            if bad:
                raise AssertionError(f"hier fig3 {name} {driver}: the "
                                     f"layouts differ in {bad}")
            counts = [int(c.max()) + 1 for c in rh.cluster_labels]
            rows = eh.age.cluster_age.shape[0]
            extra = ""
            if method == "rage_k":
                if rows != counts[-1] or (not part and (
                        counts[0] == eh.n or counts[1] == counts[0])):
                    raise AssertionError(
                        f"hier fig3 {name}: cluster counts {counts}, age "
                        f"rows {rows}; two boundaries must change C")
                extra = (f"; log_ptr {int(eh.age.log_ptr)}, drained "
                         f"{eh.pull_bytes['clustering_input']} B against "
                         f"dense {ed.pull_bytes['clustering_input']} B")
            if driver == "run_scanned" and selection == "segmented" and (
                    method == "rage_k"):
                sync_free_chunk(torch, eh, 5)
                extra += "; 5 replays under set_sync_debug_mode('error')"
            say(f"hier fig3: {name} {driver}, {rounds} rounds: hierarchical "
                f"== dense bitwise (losses, picks, labels, freq_matrix, "
                f"params, live age rows); C after each eval {counts}, age "
                f"rows {rows}, device bytes {eh.age.device_bytes} against "
                f"{ed.age.device_bytes}; {th * 1e3:.1f} ms against "
                f"{td * 1e3:.1f} (captures included){extra}")
            for e in (ed, eh):
                e.close()
    # one hierarchical round card == CPU, full and uniform m 2
    tol = dict(rtol=1e-4, atol=1e-6)
    for part in ({}, {"schedule": "uniform", "participation_m": 2}):
        hp = RAgeKConfig(**HIER_FIG3, age_layout="hierarchical", **part)
        card, cpu = (FederatedEngine("mlp", shards, test, hp, seed=0,
                                     device=where) for where in (dev, "cpu"))
        plan = card._scheduler.plan(card.sched)
        act_idx = (card._compact(plan.active)
                   if card._compute == "gathered" else None)
        if act_idx is None:
            bx, by, _ = card._store.draw(card._data, card.samp, hp.H)
        else:
            bx, by, _ = card._store.draw_gathered(card._data, card.samp,
                                                  hp.H, act_idx)
        mc = card._round_impl(bx, by, plan, act_idx)
        mh = cpu._round_impl(bx.cpu(), by.cpu(), _plan_to(plan, "cpu"),
                             None if act_idx is None else act_idx.cpu())
        torch.cuda.synchronize()
        torch.testing.assert_close(mc["losses"].cpu(), mh["losses"],
                                   equal_nan=True, **tol)
        torch.testing.assert_close(card.g_params.cpu(), cpu.g_params, **tol)
        for field in ("cluster_age", "cluster_of", "upload_cost", "log_idx",
                      "log_mem", "log_ptr"):
            if not torch.equal(getattr(card.age, field).cpu(),
                               getattr(cpu.age, field)):
                raise AssertionError(f"hier parity {part}: {field} differs")
        if not torch.equal(mc["idx"].cpu(), mh["idx"]):
            raise AssertionError(f"hier parity {part}: picks differ")
        say(f"hier parity: one fig3 hierarchical rage_k round "
            f"{part or 'full'} ({card._compute}) card == CPU (picks, ages, "
            f"log ring and pointer, upload_cost exact)")
    return total


def age_bench_shards(n: int):
    """engine_bench's grouped shards: 8 samples a client in 4 label groups
    whose features are offset by the label, so DBSCAN merges."""
    import numpy as np
    rng = np.random.default_rng(0)
    shards = []
    for i in range(n):
        lab = i % 4
        x = rng.normal(size=(8, 28 * 28)).astype(np.float32) + lab
        shards.append((x, np.full((8,), lab, np.int64)))
    xte = rng.normal(size=(64, 28 * 28)).astype(np.float32)
    yte = rng.integers(0, 10, size=(64,)).astype(np.int64)
    return shards, (xte, yte)


def boundary_wall(torch, eng) -> dict:
    """One recluster boundary of ``eng``, driven by hand after M chunked
    rounds, each part on the host's clock: the log's drain, the DBSCAN
    and merge, the apply (the new rows uploaded), and the first round
    after it (a capture where the age rows changed) against a replay."""
    walls = {}
    t0 = time.perf_counter()
    eng._drain_freq_log()
    walls["drain_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    (new_ca, labels), _ = eng._recluster_work()()
    walls["dbscan_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    eng._apply_recluster(new_ca, labels)
    torch.cuda.synchronize()
    walls["apply_ms"] = (time.perf_counter() - t0) * 1e3
    walls["allocated"] = torch.cuda.memory_allocated()
    walls["graphs_after_apply"] = len(eng._graphs)
    for key in ("next_round_ms", "replay_ms"):
        t0 = time.perf_counter()
        eng._chunk(1)
        torch.cuda.synchronize()
        walls[key] = (time.perf_counter() - t0) * 1e3
    return walls


def phase_age_memory(torch, dev):
    """The age plane at engine_bench's sizes (``AGE_BENCH``, N in
    ``AGE_BENCH_N``, nothing cut): ``device_bytes`` dense and hierarchical
    at init and after the first compaction (the C reached), the
    allocator's bytes before and after it (no N-row age buffer left), the
    boundary's device->host bytes against ``clustering_input_bytes``, and
    its wall (drain, DBSCAN, apply, the recapture) both ways. At N 256
    and 1,024 the chunked ms a round, both layouts in turns after their
    compaction; at N 1,024 ``segmented_age_topk`` at the packing reached,
    kernel against plain. Returns (launch counts, the selection's record
    at N 1,024)."""
    import numpy as np

    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.core.compression import clustering_input_bytes
    from repro_torch.fl.engine import FederatedEngine
    from repro_torch.kernels import build
    from repro_torch.kernels import segmented_topk as ST

    total, seg_rec = {}, None
    for n in AGE_BENCH_N:
        shards, test = age_bench_shards(n)
        engines = {}
        for layout in ("dense", "hierarchical"):
            hp = RAgeKConfig(**AGE_BENCH, age_layout=layout)
            torch.cuda.synchronize()
            eng = FederatedEngine("mlp", shards, test, hp, seed=0)
            init_b = eng.age.device_bytes
            build.reset_launches()
            eng._chunk(hp.M)                      # rounds 1-3, captured
            torch.cuda.synchronize()
            launches = dict(build.LAUNCHES)
            if launches != {k: hp.M * PER_ROUND[("rage_k", "segmented")]
                            .get(k, 0) for k in launches}:
                raise AssertionError(f"age memory N {n} {layout}: "
                                     f"{launches} in {hp.M} rounds")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            eng.round_idx = hp.M
            before = torch.cuda.memory_allocated()
            walls = boundary_wall(torch, eng)
            after = walls["allocated"]
            c = int(eng.cluster_of.max()) + 1
            rows = eng.age.cluster_age.shape[0]
            if any(key[0] != rows for key in eng._graphs):
                raise AssertionError(f"age memory N {n} {layout}: a graph "
                                     f"of another row count survived: "
                                     f"{list(eng._graphs)}")
            want = clustering_input_bytes(eng.d, n, k=hp.k, M=hp.M,
                                          layout=layout)
            got = eng.pull_bytes["clustering_input"]
            if got != want:
                raise AssertionError(f"age memory N {n} {layout}: pulled "
                                     f"{got} B, clustering_input_bytes "
                                     f"{want}")
            if layout == "hierarchical" and not (rows == c < n):
                raise AssertionError(f"age memory N {n}: {rows} age rows "
                                     f"for C {c}")
            say(f"age memory: N {n} {layout}: device_bytes {init_b} at init, "
                f"{eng.age.device_bytes} after the first compaction (C {c}, "
                f"age rows {rows}, {eng.age.device_bytes / init_b:.4f} of "
                f"init); allocated {before} -> {after} B across the apply "
                f"(graphs left {walls['graphs_after_apply']}); its pull: "
                f"clustering input {got} B "
                f"(== clustering_input_bytes), age rows "
                f"{eng.pull_bytes['age_rows']} B; wall: drain "
                f"{walls['drain_ms']:.3f} ms, DBSCAN+merge "
                f"{walls['dbscan_ms']:.3f}, apply {walls['apply_ms']:.3f}, "
                f"next round {walls['next_round_ms']:.3f} (capture "
                f"{'yes' if rows != n else 'no'}), a replay "
                f"{walls['replay_ms']:.3f}")
            engines[layout] = eng
        if n >= 256:
            rounds = 20
            times = {k: [] for k in engines}
            for key in ("dense", "hierarchical", "hierarchical", "dense"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engines[key]._chunk(rounds)
                torch.cuda.synchronize()
                times[key].append((time.perf_counter() - t0) * 1e3 / rounds)
            say(f"age memory: N {n} chunked ms a round after the "
                f"compaction, in turns: " + "; ".join(
                    f"{k} " + ", ".join(f"{t:.3f}" for t in v)
                    for k, v in times.items()))
        if n == AGE_BENCH_N[-1]:
            eng = engines["hierarchical"]
            C, S = eng._num_seg, eng._max_seg
            r, k = AGE_BENCH["r"], AGE_BENCH["k"]
            gen = torch.Generator(device=dev).manual_seed(5)
            cand = torch.randint(0, eng.d, (C, S, r), generator=gen,
                                 device=dev, dtype=torch.int32)
            age = torch.randint(0, 4, (C, S, r), generator=gen, device=dev,
                                dtype=torch.int32)
            sizes = torch.from_numpy(np.bincount(eng.cluster_of)).to(dev)
            valid = torch.arange(S, device=dev) < sizes.unsqueeze(1)
            got = ST.segmented_age_topk(cand, age, valid, k)
            want = ST.segmented_age_topk_plain(cand, age, valid, k)
            if not torch.equal(got, want):
                raise AssertionError(f"segmented_age_topk at ({C}, {S}): "
                                     f"kernel != plain")
            b, by = bound(4 * (2 * C * S * r + C * S + C * S * k),
                          C * S * k * r)
            seg_rec = dict(N=n, C=C, S=S, r=r, k=k, path=ST.layout(
                S, r, k)["path"], ms=device_ms(
                lambda: ST.segmented_age_topk(cand, age, valid, k)),
                plain_ms=device_ms(lambda: ST.segmented_age_topk_plain(
                    cand, age, valid, k), reps=3, warmup=1),
                bound_ms=b, bound_by=by)
            say(f"age memory: segmented_age_topk at N {n}'s packing (C "
                f"{C}, S {S}, r {r}, k {k}, path {seg_rec['path']}): kernel "
                f"== plain; kernel {seg_rec['ms']:.4f} ms, plain "
                f"{seg_rec['plain_ms']:.4f}, bound {b:.7f} ({by})")
        for e in engines.values():
            e.close()
        del engines
        torch.cuda.empty_cache()
    return total, seg_rec


def phase_fig5_hier(torch, shards, test):
    """fig5 at BENCH_FULL widths under the hierarchical layout: 20 rAge-k
    rounds at H 10, M 10 (``FIG5_CUT``) through ``run_scanned``, dense and
    hierarchical from one seed: the labels at each recluster equal, the
    boundary's pull (the (N, d) counts against the log's bytes, and the
    age rows), its wall both ways, the captures, and every round's
    launches. Returns the hierarchical run's launch counts."""
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.core.compression import clustering_input_bytes
    from repro_torch.fl.engine import FederatedEngine

    out, launches = {}, None
    for layout in ("dense", "hierarchical"):
        hp = RAgeKConfig(**{**FIG5, **FIG5_CUT}, age_layout=layout)
        eng = FederatedEngine("cnn", shards, test, hp, seed=0)
        counts, res, dt = drive_chunked(torch, eng, 20, ("rage_k",
                                                         "segmented"), 10)
        if layout == "hierarchical":
            launches = counts
        out[layout] = (eng, res, dt)
        want = 2 * clustering_input_bytes(eng.d, eng.n, k=hp.k, M=hp.M,
                                          layout=layout)
        say(f"fig5 hier: {layout}, 20 rounds at H 10, M 10 chunked: "
            f"{dt:.2f} s; labels {[c.tolist() for c in res.cluster_labels]}; "
            f"age rows {eng.age.cluster_age.shape[0]}, device_bytes "
            f"{eng.age.device_bytes}; the two boundaries pulled "
            f"clustering input {eng.pull_bytes['clustering_input']} B "
            f"(clustering_input_bytes x 2 = {want}) and age rows "
            f"{eng.pull_bytes['age_rows']} B; recluster {eng.recluster_s:.3f}"
            f" s on the worker, {eng.recluster_wait_s:.3f} s waited; "
            f"captures {eng._graphs.capture_s:.3f} s, graphs "
            f"{sorted(eng._graphs, key=str)}")
        if eng.pull_bytes["clustering_input"] != want:
            raise AssertionError(f"fig5 hier {layout}: boundary pull")
    (ed, rd, _), (eh, rh, _) = out["dense"], out["hierarchical"]
    for a, b in zip(rd.cluster_labels, rh.cluster_labels, strict=True):
        if a.tolist() != b.tolist():
            raise AssertionError(f"fig5 hier: labels {b.tolist()} against "
                                 f"dense {a.tolist()}")
    same = rd.loss == rh.loss and all(
        (a == b).all() for a, b in zip(rd.requested, rh.requested))
    say(f"fig5 hier: labels equal at every recluster; losses and picks "
        f"{'bitwise equal' if same else 'not bitwise (cuDNN defaults)'}")
    for e in (ed, eh):
        e.close()
    return launches


def _resumed(torch, make, path, step, driver, rounds, eval_every):
    """A fresh engine from ``make()`` resumed from ``path`` at ``step`` and
    driven ``rounds`` more by ``driver``: (engine, FLResult)."""
    eng = make()
    prior = eng.load_state(path, step=step)
    res = getattr(eng, driver)(rounds, eval_every=eval_every, result=prior)
    torch.cuda.synchronize()
    return eng, res


def phase_resume(torch, shards, test, scratch):
    """Checkpoint and resume at fig3 (``HIER_FIG3``): rAge-k dense and
    hierarchical and rTop-k, 20 rounds chunked saving every 5 through the
    async writer, then fresh engines resumed at round 10 through each
    driver (rTop-k chunked), bitwise the uninterrupted run (FLResult,
    every state buffer). Then the bytes on disk, the blocking time of a
    save (async and blocking), and fig3 rAge-k's rate chunked with no
    checkpoint, with the async writer and with the blocking one at
    ``ckpt_every`` 4 and 20, in turns (a second save joins the write in
    flight, so where writes outlast four rounds the async writer paces
    the run as the blocking one does). Returns the resumed runs' launch
    counts."""
    from repro_torch.checkpoint import AsyncCheckpointer
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.fl.engine import FederatedEngine
    from repro_torch.kernels import build

    rounds, every, at = RESUME_FIG3
    total = {}
    for method, layout, drivers in (
            ("rage_k", "dense", ("run", "run_scanned")),
            ("rage_k", "hierarchical", ("run", "run_scanned")),
            ("rtop_k", "dense", ("run_scanned",))):
        hp = RAgeKConfig(**HIER_FIG3, method=method, age_layout=layout)

        def make():
            return FederatedEngine("mlp", shards, test, hp, seed=0)
        path = os.path.join(scratch, f"fig3_{method}_{layout}")
        ref = make()
        with AsyncCheckpointer(path, keep=0) as ck:
            rr = ref.run_scanned(rounds, eval_every=every, checkpointer=ck,
                                 ckpt_every=every)
        for driver in drivers:
            build.reset_launches()
            eng, res = _resumed(torch, make, path, at, driver,
                                rounds - at, every)
            for k, v in build.LAUNCHES.items():
                total[k] = total.get(k, 0) + v
            bad = same_run(torch, ref, rr, eng, res)
            if not np_equal(ref.freq_matrix, eng.freq_matrix):
                bad.append("freq_matrix")
            if bad:
                raise AssertionError(f"resume fig3 {method} {layout} "
                                     f"{driver}: differs in {bad}")
            say(f"resume: fig3 {method} {layout}, saved every {every} "
                f"chunked, resumed at {at} by {driver}: bitwise the "
                f"uninterrupted {rounds} rounds (losses, picks, labels, "
                f"params, ages, every state buffer); labels "
                f"{res.cluster_labels[-1].tolist()}")
            eng.close()
        ref.close()
    # what a save costs
    hp = RAgeKConfig(**FIG3)
    eng = FederatedEngine("mlp", shards, test, hp, seed=0)
    eng.run_scanned(4, eval_every=4)
    for blocking in (False, True):
        path = os.path.join(scratch, f"fig3_save_{blocking}")
        with AsyncCheckpointer(path, keep=1, blocking=blocking) as ck:
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                eng.save_state(ck)
                ts.append((time.perf_counter() - t0) * 1e3)
                ck.wait()
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        say(f"resume: a fig3 save {'blocking' if blocking else 'async'}: "
            f"{size} B on disk; the caller blocked "
            + ", ".join(f"{t:.2f}" for t in ts) + " ms")
    eng.close()
    # the rate with a save every 4 and every 20 rounds, in turns
    every_of = {"none": 0, "async 4": 4, "blocking 4": 4, "async 20": 20,
                "blocking 20": 20}
    engines = {v: FederatedEngine("mlp", shards, test, hp, seed=0)
               for v in every_of}
    ckpts = {v: AsyncCheckpointer(os.path.join(scratch, f"rate_{i}"),
                                  keep=2, blocking=v.startswith("blocking"))
             for i, v in enumerate(every_of) if every_of[v]}
    for v, e in engines.items():
        e.run_scanned(24, eval_every=100)     # past the first recluster
    times = {v: [] for v in engines}
    for v in list(every_of) * 2 + list(reversed(every_of)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engines[v].run_scanned(20, eval_every=100, checkpointer=ckpts.get(v),
                               ckpt_every=every_of[v])
        if v in ckpts:
            ckpts[v].wait()
        torch.cuda.synchronize()
        times[v].append(20 / (time.perf_counter() - t0))
    say("resume: fig3 rage_k chunked, 20-round windows in turns, rounds/s "
        "with no save, and a save every 4 and every 20 rounds: " + "; ".join(
            f"{v} " + ", ".join(f"{t:.1f}" for t in ts)
            for v, ts in times.items()))
    for v in ckpts.values():
        v.close()
    for e in engines.values():
        e.close()
    return total


def np_equal(a, b) -> bool:
    import numpy as np
    return bool(np.array_equal(a, b))


def phase_fig5_resume(torch, shards, test, scratch):
    """fig5 hierarchical at H 10, M 2 (``FIG5_DET``) under
    ``device.deterministic()``: 8 rounds chunked saving at 4, a fresh
    engine resumed there for 4 more, bitwise the uninterrupted run; the
    bytes on disk and the caller's blocking time of one save. Returns the
    resumed run's launch counts."""
    from repro_torch.checkpoint import AsyncCheckpointer
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.device import deterministic
    from repro_torch.fl.engine import FederatedEngine
    from repro_torch.kernels import build

    hp = RAgeKConfig(**{**FIG5, **FIG5_DET}, age_layout="hierarchical")

    def make():
        return FederatedEngine("cnn", shards, test, hp, seed=0)
    path = os.path.join(scratch, "fig5_hier")
    with deterministic():
        ref = make()
        with AsyncCheckpointer(path, keep=0) as ck:
            rr = ref.run_scanned(8, eval_every=4, checkpointer=ck,
                                 ckpt_every=4)
        block_ms = {}
        for blocking in (False, True):
            with AsyncCheckpointer(path + f"_{blocking}", keep=1,
                                   blocking=blocking) as ck:
                t0 = time.perf_counter()
                ref.save_state(ck)
                block_ms[blocking] = (time.perf_counter() - t0) * 1e3
            shutil.rmtree(path + f"_{blocking}")
        build.reset_launches()
        eng, res = _resumed(torch, make, path, 4, "run_scanned", 4, 4)
        launches = dict(build.LAUNCHES)
    bad = same_run(torch, ref, rr, eng, res)
    if bad:
        raise AssertionError(f"fig5 resume: differs in {bad}")
    size = os.path.getsize(os.path.join(path, "ckpt_00000004.npz"))
    say(f"fig5 resume: hierarchical rage_k at H 10, M 2 under "
        f"deterministic(), resumed at round 4: bitwise the uninterrupted 8 "
        f"rounds; labels {res.cluster_labels[-1].tolist()}, age rows "
        f"{eng.age.cluster_age.shape[0]}; an entry is {size} B on disk; "
        f"a save blocked the caller {block_ms[False]:.1f} ms async (no "
        f"write in flight), {block_ms[True]:.1f} ms blocking")
    for e in (ref, eng):
        e.close()
    return launches


# ---------------------------------------------------------------------------
# 6n-6p: faults through the engine, and the async service
# ---------------------------------------------------------------------------

# the faulted fig3 runs: the reference's fault-plane tests' model
FAULTS_FIG3 = dict(p_nan=0.2, p_crash=0.1, p_drop=0.1, seed=9)
# the mask rates' model and its draws
FAULT_RATES = (dict(p_crash=0.1, p_nan=0.2, p_inf=0.05, p_byz=0.05,
                    p_drop=0.1, dark=(3,), seed=4), 1000)
# handed-in masks of the card == CPU round: crash, nan, inf, byz, drop,
# one lane in each label-pair cluster
FAULT_MASKS = ((2,), (5,), (7,), (1,), (8,))
# the async service at fig3: K 5, V 4 under hetero 1.0 (the reference's
# service benches' setting), 20 aggregations
ASYNC_FIG3 = dict(buffer_k=5, version_window=4, staleness_eta=0.5)
ASYNC_AGGS = 20
# the degenerate service's losses against the engine's: the card's
# one-row GEMM rounds otherwise than a row of the batched one
DEGENERATE_RTOL = 1e-3
# fig5's service: 2 aggregations at K 6, V 2, H 10
ASYNC_FIG5 = dict(H=10, buffer_k=6, version_window=2, staleness_eta=0.5)


def faulted_rows_check(torch, dev, gen):
    """The report (``threshold_topk_batch``, and ``threshold_topk``: the
    baselines', which reads the corrupted rows of rTop-k and CAFe) on the
    card against the CPU exactly, on the rows the fault lanes make: all
    NaN, all +inf, all -inf, Byzantine-scaled (1e8) gradients, and rows
    with a few NaN and inf lanes, at fig3 and at the CIFAR shape; at each
    ``SERVICE_REPORT`` each such row alone; two launches a call."""
    for n, d, r in REPORT_SHAPES + SERVICE_REPORT:
        g = torch.randn((6, d), generator=gen, device=dev)
        g[0] = float("nan")
        g[1] = float("inf")
        g[2] = -float("inf")
        g[3] *= 1e8
        g[4, torch.randperm(d, generator=gen, device=dev)[:5]] = float("nan")
        g[5, torch.randperm(d, generator=gen, device=dev)[:3]] = float("inf")
        for rows in ([g[:n]] if n > 1 else g.split(1)):
            report_exact(torch, rows, r)
            report_exact(torch, rows, r, baselines=True)
    say("  the report on faulted rows (all NaN, all +inf, all -inf, x1e8, "
        "a few NaN and inf lanes): card == CPU at fig3 and CIFAR, and each "
        "row alone at the service's (1, d), both report calls, two "
        "launches a call")


class _HandedMasks:
    """A FaultModel's ``round_masks`` returning fixed masks on its device
    (the round's other draws are the model's own)."""

    def __init__(self, model, masks):
        self.model, self.masks = model, masks

    def __getattr__(self, name):
        return getattr(self.model, name)

    def round_masks(self, key, rnd):
        return tuple(m.to(self.model.device) for m in self.masks)


def _fault_rates(torch, dev):
    """The lanes' rates over ``FAULT_RATES`` rounds (and as many
    dispatches) against their probabilities, within 5 sigma a lane, the
    dark client crashed every round."""
    from repro_torch.fl.faults import FaultModel

    kw, rounds = FAULT_RATES
    f = FaultModel(10, device=dev, **kw)
    t = torch.arange(rounds, device=dev)
    masks = [torch.stack(m) for m in zip(*(f.round_masks(77, r)
                                           for r in range(rounds)))]
    fates = f.dispatch_fate(77, torch.arange(10, device=dev).view(-1, 1),
                            t.view(1, -1))
    out = []
    for lane, m, fate in zip(("crash", "nan", "inf", "byz", "drop"), masks,
                             fates):
        p = kw.get(f"p_{lane}", 0.0)
        free = torch.ones(10, dtype=torch.bool)
        if lane == "crash":
            if not (m[:, 3].all() and fate[3].all()):
                raise AssertionError("the dark client missed a crash")
            free[3] = False
        rate = float(m[:, free.to(dev)].float().mean())
        drate = float(fate[free.to(dev)].float().mean())
        sd = (p * (1 - p) / (rounds * int(free.sum()))) ** 0.5
        if abs(rate - p) > 5 * sd or abs(drate - p) > 5 * sd:
            raise AssertionError(f"fault lane {lane}: rates {rate:.4f} "
                                 f"(rounds), {drate:.4f} (dispatches) "
                                 f"against p {p}")
        out.append(f"{lane} {rate:.4f}/{drate:.4f} (p {p})")
    say(f"faults: lane rates over {rounds} rounds / dispatches of 10 "
        f"clients (the dark client 3 aside): " + ", ".join(out)
        + "; client 3 crashed in every round and dispatch")


def phase_faults(torch, dev, shards, test, scratch):
    """6n: faults through ``FederatedEngine`` at fig3. The lanes' rates;
    one faulted round card == CPU from handed params, batches and masks
    (``FAULT_MASKS``), masked and gathered, dense and hierarchical; 20
    rAge-k rounds under ``FAULTS_FIG3`` stepped and chunked, bitwise
    (counters included), every round's launches the unfaulted round's,
    finite with the gate and NaN without; resume bitwise under faults; a
    faulted chunk with no host sync; the chunked rate with and without
    faults in turns. Returns the runs' launch counts."""
    import numpy as np
    from repro_torch.checkpoint import AsyncCheckpointer
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.fl.engine import FederatedEngine
    from repro_torch.fl.faults import FaultModel
    from repro_torch.kernels import build

    _fault_rates(torch, dev)
    tol = dict(rtol=1e-4, atol=1e-6)
    masks = [torch.tensor([i in ids for i in range(10)])
             for ids in FAULT_MASKS]
    for layout in ("dense", "hierarchical"):
        for compute in ("masked", "gathered"):
            hp = RAgeKConfig(**FIG3, age_layout=layout)
            card, cpu = (FederatedEngine(
                "mlp", shards, test, hp, seed=0, device=where,
                compute=compute, faults=FaultModel(10, device=where,
                                                   **FAULTS_FIG3))
                for where in (dev, "cpu"))
            for e in (card, cpu):
                e._faults = _HandedMasks(e._faults, masks)
            plan = card._scheduler.plan(card.sched)
            act = plan.active & ~masks[0].to(dev)
            bx, by, _ = (card._store.draw_gathered(
                card._data, card.samp, hp.H, card._compact(act))
                if compute == "gathered"
                else card._store.draw(card._data, card.samp, hp.H))
            mc = card._round_impl(bx, by)
            mh = cpu._round_impl(bx.cpu(), by.cpu())
            name = f"{layout} {compute}"
            torch.testing.assert_close(mc["losses"].cpu(), mh["losses"],
                                       equal_nan=True, **tol)
            torch.testing.assert_close(card.g_params.cpu(), cpu.g_params,
                                       **tol)
            same = [torch.equal(a.cpu(), b) for a, b in (
                (mc["idx"], mh["idx"]), (mc["faults"], mh["faults"]),
                (card.sched.aoi, cpu.sched.aoi))]
            same += [torch.equal(a.cpu(), b) for a, b in zip(card.age, cpu.age)
                     if a is not None]
            if not all(same) or mc["faults"].tolist() != [3, 1, 1]:
                raise AssertionError(f"faults parity {name}: {same}, "
                                     f"counts {mc['faults'].tolist()}")
            say(f"faults: one faulted fig3 rAge-k round {name} card == CPU "
                f"from handed masks (indices, ages, "
                f"{'log' if layout == 'hierarchical' else 'counts'}, AoI "
                f"exact; quarantined/crashed/dropped "
                f"{mc['faults'].tolist()})")
    # 20 rounds stepped and chunked under the fault model
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    hp = RAgeKConfig(**FIG3)
    path = ("rage_k", "segmented")

    def make(**kw):
        return FederatedEngine("mlp", shards, test, hp, seed=0, faults=(
            FaultModel(10, device=dev, **FAULTS_FIG3)), **kw)
    step = make()
    launches, rs, _ = drive_chunked(torch, step, 20, path, 20, driver="run")
    add(launches)
    chunk = make()
    launches, rc, tc = drive_chunked(torch, chunk, 20, path, 20)
    add(launches)
    bad = same_run(torch, step, rs, chunk, rc)
    if bad:
        raise AssertionError(f"faults: stepped and chunked differ in {bad}")
    if not (torch.isfinite(chunk.g_params).all()
            and sum(rc.n_quarantined) and sum(rc.n_crashed)):
        raise AssertionError("faults: the gated run is not finite, or "
                             "nothing was quarantined or crashed")
    say(f"faults: fig3 rage_k, 20 rounds under {FAULTS_FIG3}: stepped == "
        f"chunked bitwise (losses, picks, labels, counters, every state "
        f"buffer); quarantined {sum(rc.n_quarantined)}, crashed "
        f"{sum(rc.n_crashed)}, dropped {sum(rc.n_dropped)}; labels "
        f"{rc.cluster_labels[-1].tolist()}; params finite; every round's "
        f"launches the unfaulted round's {PER_ROUND[path]}")
    sync_free_chunk(torch, chunk, 5)
    say("faults: 5 faulted replays under set_sync_debug_mode('error'): no "
        "host sync")
    off = make(quarantine=False)
    build.reset_launches()
    off.run_scanned(20, eval_every=20)
    add(build.LAUNCHES)
    if torch.isfinite(off.g_params).all():
        raise AssertionError("faults: without the gate the params stayed "
                             "finite")
    say("faults: the same 20 rounds without the gate: the params go NaN")
    for e in (step, chunk, off):
        e.close()
    # resume under faults, both layouts
    for layout in ("dense", "hierarchical"):
        hpl = RAgeKConfig(**HIER_FIG3, age_layout=layout)

        def make_l():
            return FederatedEngine("mlp", shards, test, hpl, seed=0,
                                   faults=FaultModel(10, device=dev,
                                                     **FAULTS_FIG3))
        ckpt = os.path.join(scratch, f"faults_{layout}")
        ref = make_l()
        with AsyncCheckpointer(ckpt, keep=0) as ck:
            rr = ref.run_scanned(20, eval_every=5, checkpointer=ck,
                                 ckpt_every=5)
        build.reset_launches()
        eng, res = _resumed(torch, make_l, ckpt, 10, "run_scanned", 10, 5)
        add(build.LAUNCHES)
        bad = same_run(torch, ref, rr, eng, res)
        if not np_equal(ref.freq_matrix, eng.freq_matrix):
            bad.append("freq_matrix")
        if bad:
            raise AssertionError(f"faults resume {layout}: differs in {bad}")
        say(f"faults: fig3 {layout} at M 5 under faults, saved every 5, "
            f"resumed at 10: bitwise the uninterrupted 20 rounds, counters "
            f"{sum(res.n_quarantined)}/{sum(res.n_crashed)}/"
            f"{sum(res.n_dropped)} (quarantined/crashed/dropped)")
        ref.close()
        eng.close()
    # the chunked rate with and without faults, in turns
    engines = {"none": FederatedEngine("mlp", shards, test, hp, seed=0),
               "faults": make()}
    for e in engines.values():
        e.run_scanned(40, eval_every=20)
    times = {v: [] for v in engines}
    for v in ("none", "faults", "faults", "none", "none", "faults"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engines[v].run_scanned(20, eval_every=20)
        torch.cuda.synchronize()
        times[v].append((time.perf_counter() - t0) * 1e3 / 20)
    prof = {v: profile_window(torch, lambda: e.run_scanned(
        10, eval_every=10), 10) for v, e in engines.items()}
    for v, e in engines.items():
        say(f"faults: a replayed fig3 round, {v}: " + device_kernels(
            torch, lambda: e._chunk(10), 10, "a round"))
    say("faults: fig3 rage_k chunked, windows of 20 rounds in turns: "
        + "; ".join(f"{v} " + ", ".join(f"{t:.3f}" for t in ts)
                    + f" ms a round (profiled 10: busy "
                    f"{prof[v]['busy_ms']:.3f} ms a round)"
                    for v, ts in times.items()))
    for e in engines.values():
        e.close()
    return total


def device_kernels(torch, fn, calls: int, per: str) -> str:
    """The device kernels ``fn`` runs (``calls`` units of work): their
    count and device ms per unit, and the six that take the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    count = sum(e.count for e in rows) / calls
    busy = sum(_dev_us(e) for e in rows) / calls / 1e3
    top = sorted(rows, key=_dev_us, reverse=True)[:6]
    return (f"{count:.0f} device kernels {per}, {busy:.3f} ms of kernel "
            f"time; the most: " + ", ".join(
                f"{kernel_name(e.key)} {_dev_us(e) / calls:.1f} us "
                f"x{e.count / calls:g}" for e in top))


def _tensors(tree) -> list:
    """The tensors of a tree of NamedTuples, tuples and dicts, in order."""
    if tree is None:
        return []
    if hasattr(tree, "shape"):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    return [t for x in tree for t in _tensors(x)]


def _svc_diff(torch, a, b) -> list:
    """The fields of two services' states that differ bitwise."""
    return [name for name in a.state._fields
            if not all(torch.equal(x, y) for x, y in zip(
                _tensors(getattr(a.state, name)),
                _tensors(getattr(b.state, name))))]


def _host_replay(svc, events: int):
    """The event order and clocks a numpy replay of the argmin loop gives
    from ``svc``'s latency draws (float32 clock, ties to the lowest id)."""
    import numpy as np
    lat, n = svc._latency, svc.n
    nd = np.zeros(n, np.int64)
    key = int(svc.seed)
    next_done = np.array([float(lat.dispatch_s(key, i, 0))
                          for i in range(n)], np.float32)
    clients, clocks = [], []
    for _ in range(events):
        i = int(np.argmin(next_done))
        t = next_done[i]
        clients.append(i)
        clocks.append(t)
        nd[i] += 1
        next_done[i] = np.float32(t + np.float32(float(
            lat.dispatch_s(key, i, int(nd[i])))))
    return clients, clocks


def event_reports(torch, svc, n_events: int) -> dict:
    """``n_events`` eager events of the report-mode service ``svc``; each
    landing's candidates (the report's kernels inside the event, on the
    landing's (1, d) update row) against the plain report
    (``threshold_topk_batch_plain``) on the same row, exactly. Returns
    the events' metrics."""
    from repro_torch.kernels import report as RP

    phase, seen = svc._client_phase, []

    def record(*args):
        out = phase(*args)
        seen.append((out[3], out[4]))
        return out
    svc._client_phase = record
    try:
        m = svc._advance(n_events, eager=True)
    finally:
        svc._client_phase = phase
    for j, (g, cand) in enumerate(seen):
        if g.shape[0] != 1 or not torch.equal(
                cand, RP.threshold_topk_batch_plain(g, svc.hp.r)):
            raise AssertionError(f"event {j}: the report's candidates on "
                                 f"its {tuple(g.shape)} row differ from "
                                 f"the plain report's")
    return m


def phase_async_fig3(torch, dev, shards, test, scratch):
    """6o: ``AsyncService`` at fig3. The degenerate service (K = N, V = 1,
    equal latencies) against the engine over ``ASYNC_AGGS`` aggregations
    (the first round and quantity that differ, if any; losses within
    ``DEGENERATE_RTOL``; the label pairs at 20); at ``ASYNC_FIG3`` under
    hetero 1.0, report and dispatch modes in both layouts: the event order
    against a host replay of the port's own draws, graph replays against
    eager events bitwise (each eager landing's candidates against the
    plain report, ``event_reports``), each event's
    launches (the report's two kernels a report-mode landing, none in
    dispatch mode); a chunk of replays with no host sync; faults with a
    dark client; resume bitwise; events/s and ms per aggregation, eager
    and replayed, in turns. Returns the runs' launch counts."""
    import numpy as np
    from repro_torch.checkpoint import AsyncCheckpointer
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.fl.engine import FederatedEngine
    from repro_torch.fl.faults import FaultModel
    from repro_torch.fl.latency import LatencyModel
    from repro_torch.fl.service import AsyncService
    from repro_torch.kernels import build

    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # the degenerate service against the engine
    n, aggs = len(shards), ASYNC_AGGS
    hp = RAgeKConfig(**FIG3)
    eng = FederatedEngine("mlp", shards, test, hp, seed=0)
    er = eng.run_scanned(aggs, eval_every=1)
    svc = AsyncService("mlp", shards, test, hp, seed=0)
    build.reset_launches()
    sr = svc.run_async(aggs, eval_every=1)
    add(build.LAUNCHES)
    labels = sr.cluster_labels[-1].tolist()
    if labels != PAIRS or sr.clients != list(range(n)) * aggs:
        raise AssertionError(f"degenerate service: labels {labels} at "
                             f"{aggs}, or landings out of client order")
    first = None
    for t in range(aggs):
        diff = [q for q, a, b in (
            ("loss", er.loss[t], sr.loss[t]), ("acc", er.acc[t], sr.acc[t]),
            ("requested", er.requested[t].tolist(),
             np.stack(sr.requested[t * n:(t + 1) * n]).tolist()),
            ("labels", er.cluster_labels[t].tolist(),
             sr.cluster_labels[t].tolist())) if a != b]
        if diff and first is None:
            first = (t + 1, diff)
    same_params = torch.equal(eng.g_params, svc.state.g_params)
    if not np.allclose(sr.loss, er.loss, rtol=DEGENERATE_RTOL, atol=0):
        raise AssertionError(f"degenerate service: losses {sr.loss} against "
                             f"the engine's {er.loss}")
    say(f"async: the degenerate service (K = N, V = 1, equal latencies) "
        f"against the engine over {aggs} aggregations: "
        + ("bitwise (losses, accuracies, picks, labels, params)"
           if first is None and same_params else
           (f"first differs at round {first[0]} in {first[1]}"
            if first else "losses, accuracies, picks and labels equal at "
            "every round") + f"; params "
           f"{'equal' if same_params else 'differ'} at the end (max |diff| "
           f"{float((eng.g_params - svc.state.g_params).abs().max()):.3e})")
        + f"; labels {labels} at {aggs}; losses {er.loss[-1]:.6f} / "
        f"{sr.loss[-1]:.6f}")
    eng.close()
    # hetero 1.0 at K 5, V 4: both modes, both layouts
    want_event = {"report": {"maghist_batch": 1, "threshold_topk_batch": 1},
                  "dispatch": {}}

    def make(solicit, layout="dense", faults=None):
        cfg = RAgeKConfig(**FIG3, **ASYNC_FIG3, age_layout=layout)
        return AsyncService(
            "mlp", shards, test, cfg, seed=0, solicit=solicit, faults=faults,
            latency=LatencyModel(n, hetero=1.0, jitter=0.25, seed=0))
    for layout in ("dense", "hierarchical"):
        for solicit in ("report", "dispatch"):
            name = f"{solicit} {layout}"
            want = {k: want_event[solicit].get(k, 0) for k in build.LAUNCHES}
            svc = make(solicit, layout)
            build.reset_launches()
            res = svc.run_async(aggs, eval_every=aggs)
            events = len(res.clients)
            if dict(build.LAUNCHES) != {k: events * v
                                        for k, v in want.items()}:
                raise AssertionError(f"async {name}: {events} events "
                                     f"launched {dict(build.LAUNCHES)}")
            add(build.LAUNCHES)
            clients, clocks = _host_replay(svc, events)
            if res.clients != clients or not np.array_equal(
                    np.asarray(res.event_clock, np.float32),
                    np.asarray(clocks, np.float32)):
                raise AssertionError(f"async {name}: the event order is "
                                     f"not the host replay's")
            # graph replays against eager events, from one seed
            a, b = make(solicit, layout), make(solicit, layout)
            ma = a._advance(50)
            mb = (event_reports(torch, b, 50) if solicit == "report"
                  else b._advance(50, eager=True))
            bad = [k for k in ma if not np.array_equal(ma[k], mb[k],
                                                       equal_nan=True)]
            bad += _svc_diff(torch, a, b)
            if bad:
                raise AssertionError(f"async {name}: replays differ from "
                                     f"eager events in {bad}")
            for key, (_, tally, _) in a._graphs.items():
                if tally != want:
                    raise AssertionError(f"async {name}: graph {key} "
                                         f"launches {tally}")
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                a._chunk(10)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            say(f"async: fig3 {name}, K {svc.K}, V {svc.V}, hetero 1.0: "
                f"{aggs} aggregations in {events} events, the order and "
                f"clocks the host replay's; staleness max "
                f"{max(res.staleness)}; labels "
                f"{res.cluster_labels[-1].tolist()}; loss {res.loss[-1]:.4f}"
                f", acc {res.acc[-1]:.4f}; 50 replayed events == 50 eager "
                f"bitwise (metrics, every state field)"
                + ("; each eager landing's candidates == the plain report "
                   "on its (1, d) row" if solicit == "report" else "")
                + f"; graphs "
                f"{sorted(a._graphs)}; launches an event {want_event[solicit]}"
                f"; 10 replays under set_sync_debug_mode('error'): no host "
                f"sync")
            for s in (svc, a, b):
                s.close()
    # faults with a dark client
    flt = FaultModel(n, dark=(3,), device=dev, **FAULTS_FIG3)
    svc = make("report", faults=flt)
    build.reset_launches()
    res = svc.run_async(aggs, eval_every=aggs)
    add(build.LAUNCHES)
    s = res.summary()
    ev = np.asarray(res.clients)
    if not (np.asarray(res.crashed)[ev == 3].all()
            and not svc.freq_matrix[3].any()
            and torch.isfinite(svc.state.g_params).all()
            and s["total_quarantined"] and s["total_crashed"]):
        raise AssertionError(f"async faults: {s}")
    say(f"async: fig3 report under {FAULTS_FIG3}, dark (3,): {aggs} "
        f"aggregations in {s['events']} events; quarantined "
        f"{s['total_quarantined']}, crashed {s['total_crashed']} (client 3 "
        f"{int((ev == 3).sum())} of them), dropped {s['total_dropped']}, "
        f"retried {s['total_retried']}; params finite; loss "
        f"{res.loss[-1]:.4f}")
    svc.close()
    # resume, faulted, in both layouts and modes
    for layout, solicit in (("dense", "report"), ("hierarchical",
                                                  "dispatch")):
        def make_r():
            return make(solicit, layout, FaultModel(n, device=dev,
                                                    **FAULTS_FIG3))
        ckpt = os.path.join(scratch, f"async_{layout}")
        ref = make_r()
        with AsyncCheckpointer(ckpt, keep=0) as ck:
            rr = ref.run_async(aggs, eval_every=5, checkpointer=ck,
                               ckpt_every=10)
        b = make_r()
        b.load_state(ckpt, step=10)
        build.reset_launches()
        rb = b.run_async(aggs - 10, eval_every=5)
        add(build.LAUNCHES)
        bad = _svc_diff(torch, ref, b)
        if (bad or rb.loss != rr.loss[-len(rb.loss):]
                or rb.clients != rr.clients[-len(rb.clients):]):
            raise AssertionError(f"async resume {layout} {solicit}: "
                                 f"differs in {bad}")
        say(f"async: fig3 {solicit} {layout} under faults, saved at 10, "
            f"resumed: bitwise the uninterrupted {aggs} aggregations "
            f"(losses, events, every state field)")
        ref.close()
        b.close()
    # events/s, eager and replayed, in turns
    svcs = {"replayed": make("report"), "eager": make("report")}
    for v, s in svcs.items():
        s._advance(25, eager=v == "eager")
    times = {v: [] for v in svcs}
    for v in ("replayed", "eager", "eager", "replayed", "replayed", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = svcs[v]._advance(50, eager=v == "eager")
        torch.cuda.synchronize()
        times[v].append((time.perf_counter() - t0, int(m["flushed"].sum())))
    say("async: fig3 report, K 5, windows of 50 events in turns: " + "; ".join(
        f"{v} " + ", ".join(f"{50 / t:.1f} events/s ({t * 1e3 / f:.2f} ms an "
                            f"aggregation)" for t, f in ts)
        for v, ts in times.items()))
    prof = profile_window(torch, lambda: svcs["replayed"]._advance(20), 20)
    say(f"async: 20 replayed events profiled: {prof['ms']:.3f} ms an event, "
        f"device busy {prof['busy_ms']:.3f} ms "
        f"({100 * prof['busy_ms'] / prof['ms']:.1f}%), cudaGraphLaunch "
        f"{prof['graph_launch']:.1f} an event; " + device_kernels(
            torch, lambda: svcs["replayed"]._chunk(10), 10, "an event"))
    for s in svcs.values():
        s.close()
    return total


def phase_fig5_async(torch, shards, test):
    """6p: ``AsyncService("cnn")`` at fig5's width, ``ASYNC_FIG5`` (K 6, V
    2, H 10) under hetero 1.0: 2 aggregations, finite losses, the
    report's two launches an event (on a (1, 2,515,338) row), ms an
    event; then a replayed window of 6 events, and two eager events
    whose candidates are held to the plain report. Returns the launch
    counts."""
    import numpy as np
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.fl.latency import LatencyModel
    from repro_torch.fl.service import AsyncService
    from repro_torch.kernels import build

    hp = RAgeKConfig(**{**FIG5, **ASYNC_FIG5})
    svc = AsyncService("cnn", shards, test, hp, seed=0,
                       latency=LatencyModel(len(shards), hetero=1.0,
                                            jitter=0.25, seed=0))
    build.reset_launches()
    t0 = time.perf_counter()
    res = svc.run_async(2, eval_every=2)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    events = len(res.clients)
    want = {k: events * int(k in ("maghist_batch", "threshold_topk_batch"))
            for k in launches}
    if launches != want or not np.isfinite(res.loss).all():
        raise AssertionError(f"fig5 async: {events} events launched "
                             f"{launches}; losses {res.loss}")
    t0 = time.perf_counter()
    svc._advance(6)
    torch.cuda.synchronize()
    per = (time.perf_counter() - t0) * 1e3 / 6
    launches = dict(build.LAUNCHES)
    event_reports(torch, svc, 2)
    say(f"fig5 async: Network-2, K {svc.K}, V {svc.V}, H {hp.H}, hetero "
        f"1.0: {events} events for 2 aggregations in {dt:.2f} s (capture "
        f"{svc._graphs.capture_s:.2f} s included), losses {res.loss}, "
        f"staleness {res.staleness}; the report's two kernels once an "
        f"event; 6 more replayed events {per:.1f} ms an event; 2 eager "
        f"landings' candidates == the plain report on their (1, "
        f"{svc.d:,}) rows")
    svc.close()
    return launches


# ---------------------------------------------------------------------------
# 6q: the paper's command line, its library surface and the examples
# ---------------------------------------------------------------------------

# fig3 at full width and depth through the CLI (benchmarks/fig3_mnist.py's
# hyper-parameters: r 75, k 10, H 4, M 20, Adam lr 1e-4, batch 256 on
# paper_mnist_split of 60,000), and the reference's CI smokes' flags
CLI_FIG3 = ["--dataset", "mnist", "--paper-hparams"]
CLI_CI = ["--dataset", "mnist", "--n-train", "2000"]
CLI_SMOKE = [*CLI_CI, "--rounds", "5"]
# the launches of a report-mode event of the async service
PER_REPORT_EVENT = {"maghist_batch": 1, "threshold_topk_batch": 1}
# the parameters GlobalServer is held to card == CPU with, as
# tests/test_torch_model_optim.py holds the optimizers
GS_TOL = dict(rtol=1e-5, atol=1e-6)


def cli_run(torch, argv, out: str, rounds: int = 0, path=None) -> tuple:
    """``fl_train.main(argv + --out out)`` in this process, its printing
    kept: with ``path`` every launch count set to 0 just before and read
    just after, which must be ``rounds`` times ``PER_ROUND[path]``.
    Returns (the --out JSON, the launch counts, the printed lines, the
    main's wall in s)."""
    import contextlib
    import io
    from repro_torch.kernels import build
    from repro_torch.launch import fl_train

    buf = io.StringIO()
    build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        fl_train.main([*argv, "--out", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    if path is not None:
        want = {k: rounds * PER_ROUND[path].get(k, 0) for k in launches}
        if launches != want:
            raise AssertionError(f"cli {' '.join(argv)}: launched "
                                 f"{launches}, expected {want}")
    with open(out) as f:
        d = json.load(f)
    return d, launches, buf.getvalue().splitlines(), wall


def _summary_wall(lines) -> float:
    """The driver's wall from the CLI's ``summary:`` line."""
    import re
    line = [x for x in lines if x.startswith("summary:")][-1]
    return float(re.search(r"'wall_s': ([0-9.e+-]+)", line).group(1))


def cli_kill_resume(scratch: str) -> str:
    """The reference CI's resilience smoke through subprocesses of the
    CLI on the card: the uninterrupted run and the one killed after the
    round-4 checkpoint side by side (rc 17), then ``--resume``; the
    resumed ``--out`` byte-equal to the uninterrupted one."""
    import filecmp
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}

    def start(name, *argv):
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.fl_train", *CLI_CI,
             "--rounds", "6", "--ckpt-every", "2", "--ckpt-dir",
             os.path.join(scratch, f"ck_{name}"), "--out",
             os.path.join(scratch, f"{name}.json"), *argv],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    procs = [start("ref"), start("run", "--kill-at-round", "4")]
    outs = [p.communicate(timeout=300) for p in procs]
    if procs[0].returncode != 0 or procs[1].returncode != 17:
        raise AssertionError(f"kill and resume: rc {procs[0].returncode} "
                             f"and {procs[1].returncode} (want 0, 17): "
                             f"{outs[0][1][-2000:]} {outs[1][1][-2000:]}")
    res = start("run", "--resume")
    out, err = res.communicate(timeout=300)
    if res.returncode != 0 or "resumed at round 4" not in out:
        raise AssertionError(f"resume: rc {res.returncode}: {err[-2000:]}")
    # the killed run wrote to run.json nothing; the resumed one did
    if not filecmp.cmp(os.path.join(scratch, "ref.json"),
                       os.path.join(scratch, "run.json"), shallow=False):
        raise AssertionError("resumed --out differs from the "
                             "uninterrupted run's")
    return (f"rc 17 after the round-4 checkpoint, then --resume: --out "
            f"byte-equal to the uninterrupted run's "
            f"({time.perf_counter() - t0:.1f} s for the three processes)")


def cli_functional(torch, dev):
    """The library surface beneath the CLI on the card against the CPU:
    ``apply_method(candidates='threshold')`` (the report's two kernels on
    one vector) and ``rage_k`` over three rounds on a fig3 gradient row
    (indices, ages, densified vector exact), and ``GlobalServer``'s three
    Adam and three SGD steps on Network-1's parameters within
    ``GS_TOL``."""
    from repro_torch.configs.base import RAgeKConfig
    from repro_torch.core import sparsify as S
    from repro_torch.data.federated import paper_mnist_split
    from repro_torch.data.synthetic import mnist_like
    from repro_torch.device import strict_fp32
    from repro_torch.fl.engine import FederatedEngine
    from repro_torch.fl.server import GlobalServer

    (x, y), test = mnist_like(n_train=3000, n_test=500, seed=0)
    eng = FederatedEngine("mlp", paper_mnist_split(x, y, seed=0), test,
                          RAgeKConfig(**FIG3), seed=0)
    bx, by, _ = eng._store.draw(eng._data, eng.samp, eng.hp.H)
    with strict_fp32():
        G = eng._local_phase(eng.params_s, eng.opt_s, eng.state_s, bx,
                             by)[3]
    g = G[0].contiguous()
    r, k = FIG3["r"], FIG3["k"]
    for method in ("rage_k", "top_k"):
        ages = [torch.zeros(g.shape[0], dtype=torch.int32, device=d)
                for d in (dev, "cpu")]
        for t in range(3):
            outs = [S.apply_method(method, gg, age=a, r=r, k=k,
                                   candidates="threshold")
                    for gg, a in ((g, ages[0]), (g.cpu(), ages[1]))]
            (cs, ci, ca), (hs, hi, ha) = outs
            if not (torch.equal(ci.cpu(), hi) and torch.equal(cs.cpu(), hs)
                    and (ca is None or torch.equal(ca.cpu(), ha))):
                raise AssertionError(f"apply_method {method} threshold: "
                                     f"card != CPU at round {t}")
            if ca is not None:
                ages = [ca, ha]
    age_c = torch.zeros(g.shape[0], dtype=torch.int32, device=dev)
    age_h = age_c.cpu()
    for t in range(3):
        cs, ci, age_c = S.rage_k(g, age_c, r, k)
        hs, hi, age_h = S.rage_k(g.cpu(), age_h, r, k)
        if not (torch.equal(ci.cpu(), hi) and torch.equal(age_c.cpu(), age_h)
                and torch.equal(cs.cpu(), hs)):
            raise AssertionError(f"rage_k: card != CPU at round {t}")
    errs = {}
    for opt in ("adam", "sgd"):
        params = eng.params
        gc = GlobalServer({a: {b: t.clone() for b, t in v.items()}
                           for a, v in params.items()}, opt=opt, lr=1e-4)
        gh = GlobalServer({a: {b: t.cpu() for b, t in v.items()}
                           for a, v in params.items()}, opt=opt, lr=1e-4)
        err = 0.0
        for j in range(3):
            grad = eng._unflatten(G[j])
            pc = gc.apply_gradient(grad)
            ph = gh.apply_gradient({a: {b: t.cpu() for b, t in v.items()}
                                    for a, v in grad.items()})
            for a in pc:
                for b in pc[a]:
                    if pc[a][b].device != g.device:
                        raise AssertionError("GlobalServer left the card")
                    torch.testing.assert_close(pc[a][b].cpu(), ph[a][b],
                                               **GS_TOL)
                    err = max(err, float((pc[a][b].cpu() - ph[a][b])
                                         .abs().max()))
        errs[opt] = err
    eng.close()
    return (f"apply_method(candidates='threshold') for rage_k and top_k and "
            f"rage_k, 3 rounds each on a fig3 gradient row (d "
            f"{g.shape[0]:,}, r {r}, k {k}): card == CPU exactly; "
            f"GlobalServer 3 steps card vs CPU max |diff| adam "
            f"{errs['adam']:.2e}, sgd {errs['sgd']:.2e} (rtol 1e-5, atol "
            f"1e-6)")


def phase_cli(torch, dev, scratch: str) -> dict:
    """6q: ``python -m repro_torch.launch.fl_train`` through ``main(argv)``
    on the card. fig3 at the paper's hyper-parameters for 20 rounds by
    the scan and the step driver (equal ``--out``, the label pairs at
    20, each round's four launches); the paper's 200 rounds for rAge-k
    and rTop-k (wall and final accuracy); the reference CI's smokes at
    its flags (uniform m 8, hierarchical == dense, ``--aggregate jnp``
    == ``pallas``, the fault gate, the async buffered PS); kill and
    resume in subprocesses; fig5 at the paper's hyper-parameters for 2
    rounds; the three examples at their defaults; and the functional
    surface card == CPU. Returns the CLI runs' launch counts."""
    import math
    from repro_torch.examples import (clustered_cifar, federated_mnist,
                                      quickstart)

    t_phase = time.perf_counter()
    os.makedirs(scratch, exist_ok=True)
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def out(name):
        return os.path.join(scratch, f"{name}.json")

    # fig3, 20 rounds, both drivers
    outs = {}
    for driver in ("scan", "step"):
        d, launches, lines, wall = cli_run(
            torch, [*CLI_FIG3, "--rounds", "20", "--driver", driver],
            out(f"fig3_{driver}"), 20, ("rage_k", "segmented"))
        add(launches)
        if d["clusters"] != PAIRS or not all(map(math.isfinite, d["loss"])):
            raise AssertionError(f"cli fig3 {driver}: clusters "
                                 f"{d['clusters']}, losses {d['loss']}")
        outs[driver] = d
        say(f"cli: fig3 --paper-hparams --rounds 20 --driver {driver}: "
            f"clusters {d['clusters']}, acc {d['acc'][-1]:.4f}, wall "
            f"{wall:.2f} s (driver {_summary_wall(lines):.2f} s); launches "
            f"{launches}")
    if outs["scan"] != outs["step"]:
        bad = [k for k in outs["scan"] if outs["scan"][k] != outs["step"][k]]
        raise AssertionError(f"cli fig3: scan and step --out differ in "
                             f"{bad}")
    say("cli: fig3 scan --out == step --out (losses, accuracies, uplink, "
        "clusters, participation and age columns)")

    # the paper's full fig3 run
    for method in ("rage_k", "rtop_k"):
        d, launches, lines, wall = cli_run(
            torch, [*CLI_FIG3, "--rounds", "200", "--method", method],
            out(f"fig3_200_{method}"), 200, (method, "segmented"))
        add(launches)
        if not all(map(math.isfinite, d["loss"])):
            raise AssertionError(f"cli fig3 200 {method}: losses "
                                 f"{d['loss']}")
        say(f"cli: fig3 --paper-hparams --rounds 200 --method {method} on "
            f"{torch.cuda.get_device_name(0)}: main {wall:.2f} s (driver "
            f"{_summary_wall(lines):.2f} s, data and build included in "
            f"main), final acc {d['acc'][-1]:.4f}, loss "
            f"{d['loss'][-1]:.4f}, clusters {d['clusters']}, uplink "
            f"{d['uplink'][-1]:,} B; launches {launches}")

    # the reference CI's smokes at its flags
    d, launches, _, _ = cli_run(
        torch, [*CLI_SMOKE, "--schedule", "uniform", "--participation-m", "8"],
        out("schedule"), 5, ("rage_k", "segmented"))
    add(launches)
    if d["n_active"] != [8] * 5 or max(d["aoi_peak"]) < 1:
        raise AssertionError(f"cli schedule smoke: {d['n_active']}, "
                             f"{d['aoi_peak']}")
    hier, launches, _, _ = cli_run(
        torch, [*CLI_SMOKE, "--age-layout", "hierarchical"], out("hier"), 5,
        ("rage_k", "segmented"))
    add(launches)
    dense, launches, _, _ = cli_run(torch, CLI_SMOKE, out("dense"), 5,
                                    ("rage_k", "segmented"))
    add(launches)
    if any(hier[k] != dense[k] for k in ("loss", "acc", "clusters",
                                         "uplink")):
        raise AssertionError("cli age-layout smoke: hierarchical != dense")
    jnp_, launches, _, _ = cli_run(
        torch, [*CLI_SMOKE, "--aggregate", "jnp"], out("jnp"), 5,
        ("rage_k", "segmented"))
    add(launches)
    pallas, launches, _, _ = cli_run(
        torch, [*CLI_SMOKE, "--aggregate", "pallas"], out("pallas"), 5,
        ("rage_k", "segmented"))
    add(launches)
    if jnp_ != pallas:
        raise AssertionError("cli --aggregate jnp --out != pallas --out")
    d, launches, _, _ = cli_run(torch, [*CLI_SMOKE, "--faults", "nan:0.1"],
                                out("faults"), 5, ("rage_k", "segmented"))
    add(launches)
    if sum(d["n_quarantined"]) == 0 or not all(map(math.isfinite,
                                                   d["loss"])):
        raise AssertionError(f"cli faults smoke: {d['n_quarantined']}, "
                             f"{d['loss']}")
    quarantined = sum(d["n_quarantined"])
    d, launches, _, _ = cli_run(
        torch, [*CLI_SMOKE, "--driver", "async", "--buffer-k", "4"],
        out("async"))
    add(launches)
    hist = {int(k): v for k, v in d["staleness_hist"].items()}
    want = {k: 5 * 4 * PER_REPORT_EVENT.get(k, 0) for k in launches}
    if (d["aggregations"] != 5 or d["clock"] != sorted(d["clock"])
            or sum(hist.values()) != 20 or max(hist) > d["version_window"] - 1
            or d["downlink"][-1] <= 0 or launches != want):
        raise AssertionError(f"cli async smoke: {d}, launches {launches}")
    say(f"cli: the CI smokes at --n-train 2000, 5 rounds: uniform m 8 "
        f"n_active [8] x 5; hierarchical == dense; --aggregate jnp == "
        f"pallas (--out equal; sparse_aggregate once a round each); faults "
        f"nan:0.1 {quarantined} quarantined, finite; async K 4: 5 "
        f"aggregations, staleness {hist}, downlink {d['downlink'][-1]} B, "
        f"the report's two kernels an event")
    say(f"cli: kill and resume: {cli_kill_resume(scratch)}")

    # fig5 at the paper's hyper-parameters
    d, launches, lines, wall = cli_run(
        torch, ["--dataset", "cifar", "--paper-hparams", "--rounds", "2"],
        out("fig5"), 2, ("rage_k", "segmented"))
    add(launches)
    if not all(map(math.isfinite, d["loss"])):
        raise AssertionError(f"cli fig5: losses {d['loss']}")
    say(f"cli: --dataset cifar --paper-hparams --rounds 2 (H 100): losses "
        f"{d['loss']}, main {wall:.2f} s (driver {_summary_wall(lines):.2f}"
        f" s); launches {launches}")

    # the examples at their defaults
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        labels = quickstart.main()
        t_q = time.perf_counter() - t0
        t0 = time.perf_counter()
        mn = federated_mnist.main()
        t_m = time.perf_counter() - t0
        t0 = time.perf_counter()
        cc = clustered_cifar.main()
        t_c = time.perf_counter() - t0
    if labels.tolist() != [0, 0, 1, 1]:
        raise AssertionError(f"quickstart: clusters {labels.tolist()}")
    for res in (*mn.values(), cc):
        if not all(map(math.isfinite, res.loss)):
            raise AssertionError(f"examples: losses {res.loss}")
    cc_labels = cc.cluster_labels[-1].tolist()
    say(f"cli: examples: quickstart clusters {labels.tolist()} "
        f"({t_q:.1f} s); federated_mnist 150 rounds: "
        + ", ".join(f"{m} acc {r.acc[-1]:.4f} clusters "
                    f"{r.cluster_labels[-1].tolist()}"
                    for m, r in mn.items())
        + f" ({t_m:.1f} s); clustered_cifar 24 rounds: clusters "
        f"{cc_labels} (pairs (0,1), (2,3), (4,5) "
        f"{'found' if cc_labels == [0, 0, 1, 1, 2, 2] else 'not found'}), "
        f"acc {cc.acc[-1]:.4f} ({t_c:.1f} s)")
    say(f"cli: {cli_functional(torch, dev)}")
    say(f"cli: phase wall {time.perf_counter() - t_phase:.1f} s; launches "
        f"{total}")
    return total


# ---------------------------------------------------------------------------
# 6r: LM training with the rAge-k sparse gradient sync
# ---------------------------------------------------------------------------

# the reference CLI's defaults (src/repro/launch/train.py): batch 8, seq
# 128, Adam lr 1e-3, r 2,048, k 256; steps of each full-width path (10
# until the script's clock needed room for phase 14)
LM_TRAIN = dict(batch=8, seq=128, lr=1e-3, r=2048, k=256)
LM_STEPS = 6
# the profiled steps at the end of each path's LM_STEPS
LM_PROFILED = 2
# steps of each path of phases 10-12's archs, one of them profiled
# (``SSM_PROFILED``): the first, one timed, one profiled
ARCH_STEPS = 3
# phase 13: the production mesh's model axis, and its dry-run combination
MODEL_AXIS = 16
DRYRUN_COMBO = ["--arch", "internlm2-1.8b", "--shape", "train_4k",
                "--sync", "rage_k"]
# phase 14: the dry run's growth a layer against the card's, relative
TRAIN_MEMORY_TOL = 0.02
# the reference example's final losses at --steps 60 on a CPU (the
# reference's own RNG streams): read beside the port's, never a gate
REF_EXAMPLE = {"rage_k": 5.3894, "dense": 3.6821}
# full-width paths: (label, driver, method, candidates); the manual
# syncs run over a world-size-1 NCCL group
LM_PATHS = [("single rage_k sort", "single", "rage_k", "sort"),
            ("single rage_k threshold", "single", "rage_k", "threshold"),
            ("single dense", "single", "dense", "sort"),
            ("manual rage_k threshold validate", "manual", "rage_k",
             "threshold"),
            ("manual dense", "manual", "dense", "sort"),
            ("buffered rage_k threshold k 2", "buffered", "rage_k",
             "threshold")]


def lm_per_step(driver: str, method: str, candidates: str,
                buckets: int) -> dict:
    """A full-width step's launches: the report's two kernels a bucket on
    the threshold plane, and the union's ``sparse_aggregate`` a bucket in
    the manual syncs; dense and the sort plane none."""
    from repro_torch.kernels import build
    per = {k: 0 for k in build.LAUNCHES}
    if method != "dense" and candidates == "threshold":
        per["maghist_batch"] = per["threshold_topk_batch"] = buckets
    if method != "dense" and driver != "single":
        per["sparse_aggregate"] = buckets
    return per


def survivors(torch, row, r: int) -> int:
    """The report's survivors on one row: the values at or above its
    threshold fine bin (the fine bin b where the count from the top first
    reaches r), NaN lanes aside, counted from ``maghist.fine_slots``."""
    from repro_torch.kernels import maghist as MH
    h = torch.bincount(MH.fine_slots(row).reshape(-1),
                       minlength=MH.SLOTS).tolist()
    above = 0
    for f in range(MH.SLOTS - 2, 0, -1):
        if above + h[f] >= r:
            return above + h[f]
        above += h[f]
    return above + h[0]


def lm_report_check(torch, row, r: int, label: str) -> dict:
    """The report as a bucket's selection calls it (``ops.threshold_topk``
    on one row: the f32 copy, ``maghist_batch``'s counts and
    ``threshold_topk_batch``) against its plain version on the card
    (``report.threshold_topk_plain``: per-block histograms and a stable
    sort of the masked row), vals and indices exactly (ties to the lower
    index); two launches. Device times beside the bound (one read of the
    float32 row the kernels are handed, the report written), the plain
    version and ``torch.topk`` of the magnitudes."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ops
    from repro_torch.kernels import report as RP

    g = row.reshape(-1)
    before = dict(build.LAUNCHES)
    vals, idx = ops.threshold_topk(g, r)
    rose = {k: build.LAUNCHES[k] - before[k] for k in before}
    if rose != {k: int(k in ("maghist_batch", "threshold_topk_batch"))
                for k in before}:
        raise AssertionError(f"lm report {label}: launched {rose}")
    pv, pi = RP.threshold_topk_plain(g.reshape(1, -1), r)
    if not (torch.equal(idx.long(), pi[0]) and torch.equal(vals, pv[0])):
        bad = int((idx.long() != pi[0]).sum())
        raise AssertionError(f"lm report {label}: the kernels differ from "
                             f"the plain version at {bad} of {r} places")
    d = g.numel()
    g32 = g.to(torch.float32)
    mag = g32.abs()
    b, by = bound(4 * d + 8 * r, d)
    rec = dict(bucket=label, d=d, r=r, dtype=str(g.dtype).split(".")[-1],
               survivors=survivors(torch, g32.reshape(1, -1), r),
               ms=device_ms(lambda: ops.threshold_topk(g32, r), reps=10,
                            warmup=2),
               plain_ms=device_ms(lambda: RP.threshold_topk_plain(
                   g32.reshape(1, -1), r), reps=3, warmup=1),
               bound_ms=b, bound_by=by,
               library_ms=device_ms(lambda: torch.topk(mag, r), reps=10,
                                    warmup=2))
    say(f"  report at {label} (d {d:,}, r {r}, {rec['dtype']} cast to "
        f"float32): card == plain exactly ({int((pv[0] == pv[0][-1]).sum())}"
        f" ties at the r-th magnitude); {rec['survivors']:,} survivors; "
        f"kernels {rec['ms']:.4f} ms (2 launches), plain "
        f"{rec['plain_ms']:.4f}, torch.topk {rec['library_ms']:.4f}, bound "
        f"{b:.6f} ({by})")
    return rec


def lm_aggregate_check(torch, dev, gen, d: int, k: int) -> list:
    """``sparse_aggregate`` at one bucket's d with k and 2 k uploads (one
    and two ranks' picks: the second rank's half repeat the first's,
    sentinels d among them): dense and ages equal to the plain version
    exactly (at most two adds a coordinate commute), and repeatable.
    Device times beside the bound (12 d + 8 NK bytes), the plain version
    and ``index_add_`` into zeros (no age lane)."""
    from repro_torch.kernels import sparse_aggregate as SA

    age = torch.randint(0, 30, (d,), generator=gen, device=dev).int()
    first = torch.randint(0, d, (k,), generator=gen, device=dev).int()
    second = torch.randint(0, d, (k,), generator=gen, device=dev).int()
    second[:k // 2] = first[:k // 2]
    first[-1] = second[-2] = d                       # sentinels
    recs = []
    for idx in (first, torch.cat([first, second])):
        vals = torch.randn(idx.numel(), generator=gen, device=dev)
        dense, new_age = SA.sparse_aggregate(idx, vals, age)
        dp, ap = SA.sparse_aggregate_plain(idx, vals, age)
        if not (torch.equal(dense, dp) and torch.equal(new_age, ap)):
            raise AssertionError(f"sparse_aggregate differs from plain at "
                                 f"d {d}, NK {idx.numel()}")
        if not torch.equal(dense, SA.sparse_aggregate(idx, vals, age)[0]):
            raise AssertionError("sparse_aggregate is not repeatable")
        nk = idx.numel()
        idx64 = idx.long().clamp(max=d - 1)
        b, by = bound(12 * d + 8 * nk, nk)
        rec = dict(nk=nk, d=d, ms=device_ms(
            lambda: SA.sparse_aggregate(idx, vals, age), reps=10, warmup=2),
            plain_ms=device_ms(lambda: SA.sparse_aggregate_plain(
                idx, vals, age), reps=5, warmup=1),
            bound_ms=b, bound_by=by,
            library_ms=device_ms(lambda: torch.zeros(
                d, device=dev).index_add_(0, idx64, vals), reps=10,
                warmup=2))
        say(f"  sparse_aggregate d={d:,} NK={nk}: == plain exactly; kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}, index_add_ "
            f"{rec['library_ms']:.4f}, bound {b:.6f} ({by})")
        recs.append(rec)
    return recs


def _cpu_mesh():
    """This process alone on the CPU, whatever group is initialized."""
    import torch
    from repro_torch.launch.mesh import HostMesh
    return HostMesh({"data": 1, "model": 1}, None, 0, torch.device("cpu"))


def _same_tree(torch, a, b) -> bool:
    from repro_torch.tree import leaves
    return all(torch.equal(x.cpu(), y) for x, y in zip(leaves(a),
                                                        leaves(b)))


def lm_sync_parity(torch, dev, mesh) -> str:
    """internlm2-1.8b's smoke config in float32: the CPU's gradients of
    one batch handed to every sync on the card and on the CPU; synced
    values, ages and stats equal exactly."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import token_stream
    from repro_torch.dist import sparse_sync as SS
    from repro_torch.launch.train import to_device
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map, value_and_grad

    cfg = get_smoke_config(ARCH).replace(dtype="float32", remat=False)
    params = T.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = to_device(next(token_stream(cfg.vocab_size, 4, 32, seed=1)),
                      "cpu")
    _, grads = value_and_grad(lambda p, b: T.loss_fn(p, cfg, b)[0], params,
                              batch)
    kw = dict(r=LM_TRAIN["r"] // 8, k=LM_TRAIN["k"] // 8)
    shapes = tree_map(lambda g: g.to("meta"), grads)
    done = []
    for method in ("rage_k", "cafe", "top_k", "dense"):
        for cand in (("sort", "threshold") if method in ("rage_k", "cafe")
                     else ("sort",)):
            ages = SS.init_age_state(params, method=method)
            # two steps, the second from the first's ages
            outs = []
            for d in ("cpu", dev):
                a = tree_map(lambda t: t.to(d), ages)
                g = tree_map(lambda t: t.to(d), grads)
                res = []
                for _ in range(2):
                    s, a, st = SS.sync_grads(g, a, method=method,
                                             candidates=cand, **kw)
                    res.append((s, a, st))
                outs.append(res)
            for (s0, a0, st0), (s1, a1, st1) in zip(*outs):
                if not (_same_tree(torch, s1, s0) and _same_tree(torch, a1, a0)
                        and st0 == st1):
                    raise AssertionError(f"sync_grads {method} {cand}: card "
                                         f"!= CPU")
            done.append(f"single {method} {cand}")
    for method, validate, bk in (("rage_k", True, 0), ("cafe", False, 0),
                                 ("top_k", False, 0), ("dense", True, 0),
                                 ("rage_k", False, 2)):
        outs = []
        for m in (_cpu_mesh(), mesh):
            d = m.device
            mk = dict(method=method, candidates="threshold", validate=validate,
                      **kw)
            a = tree_map(lambda t: t.to(d), SS.init_age_state(
                params, method=method))
            g = tree_map(lambda t: t.to(d), grads)
            if bk:
                sync = SS.make_buffered_sync(m, None, shapes, buffer_k=bk,
                                             **mk)
                buf = sync.init_buffer()
                res = []
                for _ in range(2):
                    s, a, buf, st = sync(g, a, buf)
                    res.append((s, a, st))
            else:
                sync = SS.make_manual_sync(m, None, shapes, **mk)
                res = []
                for act in (None, torch.tensor([True], device=d)):
                    s, a, st = sync(g, a, active=act)
                    res.append((s, a, st))
            outs.append(res)
        for (s0, a0, st0), (s1, a1, st1) in zip(*outs):
            same_stats = {k: int(v) for k, v in st0.items()} == {
                k: int(v) for k, v in st1.items()}
            if not (_same_tree(torch, s1, s0) and _same_tree(torch, a1, a0)
                    and same_stats):
                raise AssertionError(f"manual sync {method} validate "
                                     f"{validate} buffer_k {bk}: card != CPU")
        done.append(f"{'buffered' if bk else 'manual'} {method}"
                    + (" validate" if validate else ""))
    return (f"smoke config float32, the CPU's gradients handed over, two "
            f"calls each: card == CPU exactly (synced values, ages, stats) "
            f"for {', '.join(done)}")


def lm_profile(torch, fn, steps: int) -> dict:
    """``fn`` (``steps`` steps) under ``torch.profiler``, the device's
    activity alone (the host's ops of a full-width step made reading the
    trace take seconds): host ms a step, device busy ms a step
    (``busy_union_us``) and the top device kernels by time a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    top = ", ".join(f"{kernel_name(e.key)} {_dev_us(e) / steps / 1e3:.3f} "
                    f"ms x{e.count / steps:g}"
                    for e in sorted(rows, key=_dev_us, reverse=True)[:6])
    busy = busy_union_us(prof) / steps / 1e3
    return dict(ms=wall, busy_ms=busy, busy_share=busy / wall, top=top)


def lm_full_width(torch, dev, mesh, base, stream_batches, cfg,
                  paths, profiled: int = LM_PROFILED,
                  steps: int = LM_STEPS) -> dict:
    """Each of ``paths`` ((label, driver, method, candidates)) for
    ``steps`` steps of ``cfg`` from ``base`` (one ``T.init``; the
    steps are functional and never write it): every step's loss finite,
    the launches ``steps`` times ``lm_per_step``; ms a step on the host
    clock after a sync over the unprofiled steps 2 on, then the last
    ``profiled`` under the profiler (busy share, top kernels); the
    allocator's peak. Under MoE also each step's ``lb_loss`` and
    ``drop_frac``, from a forward pass of the step's input parameters on
    its batch outside the timed and profiled steps (``loss_fn``'s aux,
    which the train steps do not return). Returns {label: record}."""
    import math
    from repro_torch.configs import InputShape
    from repro_torch.dist import sparse_sync as SS
    from repro_torch.kernels import build
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import adam
    from repro_torch.tree import leaves, tree_map

    def aux_of(params, batch):
        with torch.no_grad():
            _, aux = T.loss_fn(params, cfg, batch)
        return [float(aux["lb_loss"]), float(aux["drop_frac"])]

    shape = InputShape("lm_train", LM_TRAIN["seq"], LM_TRAIN["batch"],
                       "train")
    buckets = len(leaves(base))
    shapes = tree_map(lambda p: p.to("meta"), base)
    out = {}
    for label, driver, method, cand in paths:
        t_path = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        opt = adam(LM_TRAIN["lr"])
        opt_state = opt.init(base)
        ages = SS.init_age_state(base)
        kw = dict(method=method, r=LM_TRAIN["r"], k=LM_TRAIN["k"],
                  candidates=cand)
        held = {}                          # the buffered sync's buffer
        if driver == "single":
            step = SS.make_sync_train_step(
                lambda p, b: T.loss_fn(p, cfg, b)[0], opt, mesh, **kw)

            def one(state, batch):
                p, o, a = state
                p, o, a, loss, st = step(p, o, a, batch)
                return (p, o, a), loss, st
        else:
            if driver == "manual":
                sync = SS.make_manual_sync(mesh, None, shapes,
                                           validate=method != "dense", **kw)
            else:
                buffered = SS.make_buffered_sync(mesh, None, shapes,
                                                 buffer_k=2, **kw)
                held["buf"] = buffered.init_buffer()

                def sync(g, a):
                    s, a, held["buf"], st = buffered(g, a, held["buf"])
                    return s, a, st
            tstep = make_train_step(cfg, shape, lr=LM_TRAIN["lr"], sync=sync)

            def one(state, batch):
                p, o, a = state
                p, o, loss, a, st = tstep(p, o, batch, a)
                return (p, o, a), loss, st
        state = (base, opt_state, ages)
        del opt_state, ages
        losses, stats, auxes, held_in = [], None, [], []
        build.reset_launches()
        torch.cuda.synchronize()
        times = []
        for i in range(steps - profiled):
            t0 = time.perf_counter()
            prev, (state, loss, stats) = state[0], one(state,
                                                       stream_batches[i])
            losses.append(loss)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if cfg.is_moe:
                auxes.append(aux_of(prev, stream_batches[i]))
            del prev

        def tail():
            nonlocal state, stats
            for i in range(steps - profiled, steps):
                if cfg.is_moe:
                    held_in.append(state[0])
                state, loss, stats = one(state, stream_batches[i])
                losses.append(loss)
        prof = lm_profile(torch, tail, profiled)
        launches = dict(build.LAUNCHES)
        auxes += [aux_of(p, stream_batches[steps - profiled + j])
                  for j, p in enumerate(held_in)]
        del held_in
        want = {k: steps * v for k, v in
                lm_per_step(driver, method, cand, buckets).items()}
        if launches != want:
            raise AssertionError(f"lm {label}: launched {launches} in "
                                 f"{steps} steps, expected {want}")
        losses = [float(x) for x in losses]
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"lm {label}: losses {losses}")
        peak = torch.cuda.max_memory_allocated()
        rec = dict(path=label, losses=losses,
                   ms_steps=times[1:], ms=statistics.median(times[1:]),
                   first_step_ms=times[0], profiled_ms=prof["ms"],
                   busy_ms=prof["busy_ms"], busy_share=prof["busy_share"],
                   peak_bytes=peak,
                   wire_bytes_per_shard=int(stats["wire_bytes_per_shard"]),
                   launches=launches)
        if driver != "single":
            rec.update({k: int(v) for k, v in stats.items()
                        if k != "wire_bytes_per_shard"})
        if cfg.is_moe:
            rec.update(lb_loss=[a[0] for a in auxes],
                       drop_frac=[a[1] for a in auxes])
            if not all(map(math.isfinite, rec["lb_loss"] + rec["drop_frac"])):
                raise AssertionError(f"lm {label}: aux {auxes}")
        say(f"lm train: {label}: {steps} steps, losses "
            f"{losses[0]:.4f} .. {losses[-1]:.4f}; "
            f"{rec['ms']:.1f} ms a step (median of steps 2-"
            f"{steps - profiled}: "
            f"{', '.join(f'{t:.1f}' for t in times[1:])}; first "
            f"{times[0]:.1f}); profiled {prof['ms']:.1f} ms a step, busy "
            f"{prof['busy_ms']:.1f} ms ({100 * prof['busy_share']:.1f}%); "
            f"peak {peak / 2**30:.2f} GiB; wire "
            f"{rec['wire_bytes_per_shard']:,} B/shard a step; launches "
            f"{ {k: v for k, v in launches.items() if v} }; path wall "
            f"{time.perf_counter() - t_path:.1f} s")
        if cfg.is_moe:
            say("  lb_loss / drop_frac a step: " + ", ".join(
                f"{a:.4f} / {b:.4f}" for a, b in auxes))
        say(f"  top kernels a step: {prof['top']}")
        out[label] = rec
        del state, one
        held.clear()
    return out


def phase_lm_train(torch, dev, scratch: str) -> tuple:
    """6r: LM training with the rAge-k sparse gradient sync on the card.
    The report and ``sparse_aggregate`` at the LM's bucket shapes against
    their plain versions; every sync on the smoke config card == CPU from
    handed gradients; internlm2-1.8b at full width in bfloat16 through
    each ``LM_PATHS`` path (the manual syncs over a world-size-1 NCCL
    group); ``launch.train --smoke`` for both methods and the example.
    Returns (the phase's launch counts, the kernels' LM records)."""
    import math
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.sparsify import bucket_budgets
    from repro_torch.data.pipeline import token_stream
    from repro_torch.examples import distributed_ragek_lm
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.tree import flatten, value_and_grad

    t_phase = time.perf_counter()
    os.makedirs(scratch, exist_ok=True)
    pg = os.path.join(scratch, "pg_file")
    if os.path.exists(pg):
        os.remove(pg)
    dist.init_process_group("nccl", init_method=f"file://{pg}", rank=0,
                            world_size=1)
    total = {k: 0 for k in build.LAUNCHES}
    try:
        mesh = make_host_mesh(1, 1)
        if mesh.group is None:
            raise AssertionError("the mesh does not span the NCCL group")
        say(f"lm train: {lm_sync_parity(torch, dev, mesh)}")

        cfg = get_config(ARCH).replace(remat=False)
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        base = T.init(cfg, gen, device=dev)
        leaves, node = flatten(base)
        names = _leaf_names(base)
        sizes = [p.numel() for p in leaves]
        budgets = bucket_budgets(sizes, LM_TRAIN["r"], LM_TRAIN["k"])
        stream = token_stream(cfg.vocab_size, LM_TRAIN["batch"],
                              LM_TRAIN["seq"], seed=1)
        batches = [train.to_device(next(stream), dev)
                   for _ in range(LM_STEPS)]
        say(f"lm train: {cfg.name} at full width: {sum(sizes):,} params in "
            f"{len(leaves)} leaves, bfloat16, init {time.perf_counter() - t0:.1f}"
            f" s; buckets (d, r_b, k_b): "
            + ", ".join(f"{n} ({d:,}, {r}, {k})"
                        for n, d, (r, k) in zip(names, sizes, budgets))
            + f"; k total {sum(k for _, k in budgets)}")

        # the kernels at the LM's bucket shapes: a real gradient of the
        # first batch, and a seeded bfloat16 row of the largest bucket
        _, grads = value_and_grad(lambda p, b: T.loss_fn(p, cfg, b)[0],
                                  base, batches[0])
        g_leaves = flatten(grads)[0]
        big = max(range(len(sizes)), key=sizes.__getitem__)
        emb = names.index("embed/w")
        report = [lm_report_check(torch, g_leaves[big], budgets[big][0],
                                  f"{names[big]} gradient"),
                  lm_report_check(torch, g_leaves[emb], budgets[emb][0],
                                  f"{names[emb]} gradient")]
        del g_leaves
        row = (torch.randn(sizes[big], generator=gen, device=dev)
               * 1e-3).to(torch.bfloat16)
        report.append(lm_report_check(torch, row, budgets[big][0],
                                      f"{names[big]} seeded randn"))
        del row
        aggregate = lm_aggregate_check(torch, dev, gen, sizes[big],
                                       budgets[big][1])
        torch.cuda.empty_cache()
        axis_launches, axis_recs = model_axis_sync(torch, dev, cfg, base,
                                                   grads, gen)
        del grads
        for k, v in axis_launches.items():
            total[k] += v
        torch.cuda.empty_cache()

        runs = lm_full_width(torch, dev, mesh, base, batches, cfg,
                             LM_PATHS)
        for rec in runs.values():
            for k, v in rec["launches"].items():
                total[k] += v
        del base, batches
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # the CLI (the card by default) and the example, in this process
    import contextlib
    import io
    cli = {}
    for method in ("rage_k", "dense"):
        buf = io.StringIO()
        build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = train.main(["--smoke", "--steps", "20", "--method",
                              method])
        wall = time.perf_counter() - t0
        for k, v in build.LAUNCHES.items():
            total[k] += v
        losses = res["losses"]
        if not all(map(math.isfinite, losses)) or (
                method == "dense" and not losses[-1] < losses[0]):
            raise AssertionError(f"launch.train --smoke {method}: losses "
                                 f"{losses}")
        cli[method] = losses
        say(f"lm train: `launch.train --smoke --steps 20 --method {method}`"
            f" on the card in {wall:.1f} s: "
            + " | ".join(buf.getvalue().strip().splitlines()))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ex = distributed_ragek_lm.main(["--steps", "60"])
    if not all(math.isfinite(r["loss"]) for r in ex.values()):
        raise AssertionError(f"distributed_ragek_lm: {ex}")
    say(f"lm train: distributed_ragek_lm --steps 60 in "
        f"{time.perf_counter() - t0:.1f} s: "
        + " | ".join(buf.getvalue().strip().splitlines())
        + f" (the reference's on a CPU, its own RNG streams: rage_k "
        f"{REF_EXAMPLE['rage_k']}, dense {REF_EXAMPLE['dense']})")
    say(f"lm train: phase wall {time.perf_counter() - t_phase:.1f} s; "
        f"launches {total}")
    return total, {"threshold_topk_batch": report,
                   "sparse_aggregate": aggregate, "model_axis": axis_recs}


# ---------------------------------------------------------------------------
# 13: the model axis, the dry run and the autotune registry
# ---------------------------------------------------------------------------


class _plain_kernels:
    """The port's kernel wrappers take their plain versions on the card's
    tensors inside (``ops._on_card`` answers False): the plain side of a
    comparison, which launches nothing."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.saved = ops, ops._on_card
        ops._on_card = lambda name, t: False

    def __exit__(self, *exc):
        self.ops._on_card = self.saved


def model_axis_sync(torch, dev, cfg, base, grads, gen) -> tuple:
    """13 (inside 6r, while its gradient lives): the full-width gradient's
    specs on a (data 1, model 16) mesh under ``rules={"fsdp": None}``,
    every leaf cut into its 16 local slices, each model coordinate's
    exchange through ``make_manual_sync`` (rage_k, threshold candidates)
    on the card against the same exchange through the plain versions on
    the card: indices (the synced values' support), ages and synced
    values equal exactly; then the report and ``sparse_aggregate`` at the
    largest model-sharded slice (``mlp.w1``'s; the Megatron override
    leaves ``wk`` and ``wv`` whole on every shard) beside the bound and
    ``torch.topk``. Returns (the exchanges' launch counts, the
    records)."""
    import math
    from repro_torch.core.sparsify import bucket_budgets
    from repro_torch.dist import sharding as SH
    from repro_torch.dist import sparse_sync as SS
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.launch.steps import attention_overrides
    from repro_torch.tree import flatten, leaves, tree_map, unflatten

    t0 = time.perf_counter()
    shape = {"data": 1, "model": MODEL_AXIS}
    with SH.use_mesh(SH.Mesh(shape), rules={"fsdp": None}):
        specs = SH.param_specs(base, overrides=attention_overrides(
            SH.Mesh(shape), cfg))
    shapes = tree_map(lambda p: p.to("meta"), base)
    names = _leaf_names(base)
    spec_l = leaves(specs)
    g_leaves, node = flatten(grads)
    total = {k: 0 for k in build.LAUNCHES}
    for j in range(MODEL_AXIS):
        mesh = HostMesh(shape, None, 0, dev, MODEL_AXIS, j)
        coords = {"data": 0, "model": j}
        local = [SH.local_slice(g, s, mesh, coords)
                 for g, s in zip(g_leaves, spec_l)]
        sync = SS.make_manual_sync(mesh, specs, shapes, method="rage_k",
                                   candidates="threshold", r=LM_TRAIN["r"],
                                   k=LM_TRAIN["k"])
        ages = [torch.zeros(t.shape, dtype=torch.int32, device=dev)
                for t in local]
        build.reset_launches()
        got = sync(unflatten(node, local), unflatten(node, ages))
        for k, v in build.LAUNCHES.items():
            total[k] += v
        with _plain_kernels():
            want = sync(unflatten(node, local), unflatten(node, ages))
        for part, a, b in (("synced", got[0], want[0]),
                           ("ages", got[1], want[1])):
            for n, x, y in zip(names, leaves(a), leaves(b)):
                if not torch.equal(x, y):
                    raise AssertionError(f"model axis: slice {j} {n} "
                                         f"{part} differ from the plain "
                                         f"exchange")
        if got[2]["wire_bytes_per_shard"] != want[2]["wire_bytes_per_shard"]:
            raise AssertionError(f"model axis: slice {j} wire bytes differ")
        del local, got, want
    per_slice = {k: v // MODEL_AXIS for k, v in total.items()}
    sizes = [math.prod(s.shape) for s in leaves(shapes)]
    budgets = bucket_budgets(sizes, LM_TRAIN["r"], LM_TRAIN["k"])
    i = max((i for i, s in enumerate(spec_l)
             if SH.shard_count(SH.Mesh(shape), s) > 1),
            key=lambda i: sizes[i])
    t = SH.local_slice(g_leaves[i], spec_l[i], SH.Mesh(shape),
                       {"data": 0, "model": 0})
    n = t.numel()
    ns = SH.shard_count(SH.Mesh(shape), spec_l[i])
    r_l = max(1, budgets[i][0] // ns)
    k_b = budgets[i][1]
    k_l = max(1, min(r_l, k_b // ns if k_b >= ns else 1))
    say(f"model axis: {cfg.name}'s gradient on a (data 1, model "
        f"{MODEL_AXIS}) mesh, fsdp off: specs "
        + ", ".join(f"{nm} {tuple(s)}" for nm, s in zip(names, spec_l))
        + f"; all {MODEL_AXIS} slices' exchanges card == plain exactly "
        f"(indices, ages, synced values, wire bytes); launches a slice "
        f"{ {k: v for k, v in per_slice.items() if v} }; in "
        f"{time.perf_counter() - t0:.1f} s")
    rep = lm_report_check(torch, t.contiguous(), r_l,
                          f"model slice of {names[i]} {tuple(t.shape)}")
    agg = lm_aggregate_check(torch, dev, gen, n, k_l)
    return total, dict(leaf=names[i], slice_shape=list(t.shape),
                       slice_elems=n, r_l=r_l, k_l=k_l, report=rep,
                       aggregate=agg)


def start_dryrun(scratch: str):
    """The dry-run combination in a subprocess on the CPU (no card: it
    allocates nothing and launches nothing), running beside the card's
    phases; its output in ``scratch``. Killed at exit if a phase fails
    before :func:`finish_dryrun` waits for it."""
    import atexit
    os.makedirs(scratch, exist_ok=True)
    log = open(os.path.join(scratch, "dryrun.log"), "w")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_COMBO,
         "--out", scratch], stdout=log, stderr=subprocess.STDOUT, env=env,
        cwd=ROOT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, log, time.perf_counter()


def finish_dryrun(proc, log, t_start, scratch: str) -> dict:
    """Wait for :func:`start_dryrun`'s run; its record, printed."""
    import torch
    rc = proc.wait(timeout=900)
    log.close()
    text = open(os.path.join(scratch, "dryrun.log")).read()
    if rc != 0:
        raise AssertionError(f"dryrun: exit {rc}: {text[-3000:]}")
    path = os.path.join(scratch,
                        "internlm2-1.8b_train_4k_16x16.json")
    rec = json.load(open(path))
    t = rec["roofline"]
    say(f"dryrun: internlm2-1.8b x train_4k x 16x16 --sync rage_k under "
        f"torch {torch.__version__} on the CPU: ok in "
        f"{time.perf_counter() - t_start:.1f} s of wall beside the card "
        f"(trace {rec['lower_s']} s, probes {rec['compile_s']} s); "
        f"per device: {rec['flops_per_dev']:.4e} FLOPs, "
        f"{rec['bytes_per_dev']:.4e} B, collectives "
        f"{rec['collective_bytes_per_dev']}; terms compute "
        f"{t['compute_s']:.4e} s, memory {t['memory_s']:.4e} s, "
        f"collective {t['collective_s']:.4e} s (dominant {rec['dominant']}"
        f"); memory {rec['memory']}")
    return rec


def start_train_memory(scratch: str):
    """``train_memory.py --dry`` (the dry run's count of phase 14's steps)
    in a subprocess on the CPU beside the card's phases; its output in
    ``scratch``."""
    import atexit
    os.makedirs(scratch, exist_ok=True)
    log = open(os.path.join(scratch, "train_memory_dry.log"), "w")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "train_memory.py"), "--dry"],
        stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, log


def phase_train_memory(torch, dev, proc, log, scratch: str) -> dict:
    """14: the LM training step's peak memory and ms on the card
    (``train_memory.real_peaks``: ``train_memory.STEPS``, internlm2-1.8b
    at 2 and 4 full-width layers, phi4-mini-3.8b at 1 and 2, remat on and
    off) beside the dry run's count of the same steps on a fake (1, 1)
    mesh (:func:`start_train_memory`): the growth a layer within
    ``TRAIN_MEMORY_TOL`` of the card's."""
    import train_memory as TM
    t0 = time.perf_counter()
    card = TM.real_peaks(torch, dev)
    rc = proc.wait(timeout=600)
    log.close()
    text = open(os.path.join(scratch, "train_memory_dry.log")).read()
    if rc != 0:
        raise AssertionError(f"train memory: dry run exit {rc}: "
                             f"{text[-3000:]}")
    dry = json.loads(text.strip().splitlines()[-1])["dry"]
    gib = 2 ** 30
    for arch, rec in card.items():
        st = TM.STEPS[arch]
        for remat, row in rec["peak"].items():
            got = dry[arch]["per_layer"][remat]
            want = rec["per_layer"][remat]
            say(f"train memory: {arch} at full width, {st['batch']} x "
                f"{st['seq']} tokens in {st['accum']} microbatch(es), {remat}: "
                "card peak " + ", ".join(
                    f"{n} layers {b / gib:.4f} GiB ({rec['ms'][remat][n]:.1f}"
                    " ms a step)" for n, b in row.items())
                + f" ({want / gib:.4f} GiB a layer); dry run "
                + ", ".join(f"{n} layers {int(b) / gib:.4f} GiB"
                            for n, b in dry[arch]["peak"][remat].items())
                + f" ({got / gib:.4f} GiB a layer, {got / want:.4f} of the "
                f"card's)")
            if abs(got / want - 1) > TRAIN_MEMORY_TOL:
                raise AssertionError(
                    f"train memory: {arch} {remat}: the dry run's growth "
                    f"{got} against the card's {want}")
        if "attention" in rec:
            att = rec["attention"]
            say(f"train memory: {arch}, {TM.ATTENTION_PROBE[1]} layer(s) "
                f"with remat: the flash attention's backward starts with "
                f"{att['live'] / gib:.4f} GiB allocated and peaks at "
                f"{att['peak'] / gib:.4f} GiB")
    say(f"train memory: ok in {time.perf_counter() - t0:.1f} s")
    return {"card": card, "dry": dry}


def autotune_sweep(torch, dev, gen, scratch: str, d: int, r: int) -> dict:
    """13: one sweep of each consulted launch choice into a temporary
    registry: ``decode_attention``'s tile and splits at internlm2's serve
    and long-decode shapes (bfloat16), the report's blocks a row at
    ``mlp.w1``'s model slice (1 x d, r its split budget); every
    candidate timed on the card (``device_ms``), the winner recorded and
    its output held to the plain twin (decode within ``DA_TOL``, the
    report exactly). The registry stays in ``scratch``
    (``AUTOTUNE.json``); the default one is restored after."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ops
    from repro_torch.kernels import report as RP

    t0 = time.perf_counter()
    path = os.path.join(scratch, "AUTOTUNE.json")
    if os.path.exists(path):
        os.remove(path)
    autotune.set_path(path)
    out = {}
    try:
        for B, H, G, D, S in (DA_SERVE, DA_MAIN):
            q = torch.randn((B, H, D), generator=gen, device=dev).to(
                torch.bfloat16)
            k = torch.randn((B, S, G, D), generator=gen, device=dev).to(
                torch.bfloat16)
            v = torch.randn((B, S, G, D), generator=gen, device=dev).to(
                torch.bfloat16)
            rep = H // G
            configs = []
            for tile in (DA.LARGE_TILE, DA.SMALL_TILE):
                if DA.smem_bytes(D, 2, rep, tile) > DA.SMEM_LIMIT:
                    continue
                most = -(-S // DA.tile_positions(D, 2, tile))
                for splits in (1, 2, 4, 8, 16, 32, 64):
                    if splits <= most:
                        configs.append({"tile_bytes": tile,
                                        "splits": splits})

            def timer(tile_bytes, splits):
                chunk = DA.split_chunk(S, splits,
                                       DA.tile_positions(D, 2, tile_bytes))
                n_s = max(1, -(-S // chunk))
                return 1e3 * device_ms(lambda: DA._launch(
                    q, k, v, S, tile_bytes, n_s, chunk), reps=20, warmup=3)
            rule = DA.choose_splits(B * G, S, D, 2, DA._sm_count(
                dev.index or 0), rep)
            best, results = autotune.sweep(
                "decode_attention", (B * G, S, D, rep), "bfloat16",
                autotune.CARD, configs, timer)
            got = ops.decode_attention(q, k, v, S)
            if DA.LAST_CUT["splits"] != DA.launch_cut(
                    B * G, S, D, 2, DA._sm_count(dev.index or 0), rep)[1]:
                raise AssertionError("autotune: the launch did not take "
                                     "the recorded cut")
            _da_close(torch, got, DA.decode_attention_plain(q, k, v, S),
                      DA_TOL["bfloat16"])
            say(f"autotune: decode_attention (B {B}, H {H}, G {G}, D {D}, "
                f"{S} positions, bfloat16): rule {rule[:2]}; candidates "
                + ", ".join(f"{c['tile_bytes']}/{c['splits']} "
                            f"{c['us']:.2f} us" for c in results)
                + f"; winner {best}, its output == plain within "
                f"{DA_TOL['bfloat16']}")
            out[f"decode_attention S {S}"] = dict(rule=list(rule[:2]),
                                                  best=best,
                                                  results=results)
        row = (torch.randn((1, d), generator=gen, device=dev) * 1e-3)
        want = RP.threshold_topk_batch_plain(row, r)

        def rtimer(parts):
            autotune.record("maghist_batch", (1, d), "float32",
                            autotune.CARD, {"parts": parts}, 0.0)
            return 1e3 * device_ms(lambda: RP.threshold_topk_batch(row, r),
                                   reps=10, warmup=2)
        best, results = autotune.sweep(
            "maghist_batch", (1, d), "float32", autotune.CARD,
            [{"parts": p} for p in (64, 32, 16, 8)], rtimer)
        got = RP.threshold_topk_batch(row, r)
        if not torch.equal(got.long(), want.long()):
            raise AssertionError("autotune: the report at the winning "
                                 "chunk differs from the plain version")
        say(f"autotune: the report at 1 x {d:,} (r {r}): candidates "
            + ", ".join(f"{c['parts']} parts {c['us']:.1f} us"
                        for c in results)
            + f"; winner {best}, its picks == plain exactly; registry "
            f"{len(autotune.load())} entries in "
            f"{time.perf_counter() - t0:.1f} s")
        out["report"] = dict(best=best, results=results, r=r)
    finally:
        autotune.set_path(None)
    return out


# ---------------------------------------------------------------------------
# 10: the other dense configs, MoE and MLA
# ---------------------------------------------------------------------------

# the archs this phase brings: three dense, granite's MoE, deepseek's MoE
# with MLA attention
FAMILIES = ("gemma-2b", "phi4-mini-3.8b", "qwen1.5-110b",
            "granite-moe-3b-a800m", "deepseek-v2-236b")
# decode_attention at each new serve shape, batch 8: the serve phase's cache
# at its end and a longer one
FAM_DA_S = (160, 4096)
# card == CPU decode in float32 at full width with 2 layers (each under 4 GB
# in float32); qwen1.5-110b and deepseek-v2-236b at their smoke configs (two
# full-width float32 layers of those are 21 and 32 GB on the host as on the
# card)
FAM_PARITY_FULL = ("gemma-2b", "phi4-mini-3.8b", "granite-moe-3b-a800m")
# the serve depth cuts one card's 80 GB forces, of 80 and 60 layers
# (bfloat16: qwen1.5-110b 1.36 B parameters a layer beside a 2.5 B untied
# embedding and head; deepseek-v2-236b 4.05 B a layer, whose largest leaf
# is drawn in float32 at init)
FAM_SERVE_LAYERS = {"qwen1.5-110b": 8, "deepseek-v2-236b": 4}
# decode against prefill at full width: qwen1.5-110b at its serve cut in
# bfloat16; deepseek-v2-236b in float32 with 2 layers (34 GB), since in
# bfloat16 the two paths' roundings flip the top 6 of its 160 experts for
# some tokens (on the H100 one row's last logits came out 1.15 apart)
FAM_MLA_CHECK_LAYERS = 2
# granite-moe-3b-a800m's training cut, 16 of 32 layers: about internlm2-1.8b's
# 1.7 B parameters, which phase 6r trains at a 54-68 GiB peak
MOE_ARCH = "granite-moe-3b-a800m"
MOE_TRAIN_LAYERS = 16
MOE_PATHS = [("single rage_k threshold", "single", "rage_k", "threshold"),
             ("manual rage_k threshold validate", "manual", "rage_k",
              "threshold"),
             ("single dense", "single", "dense", "sort")]


def family_da_check(torch, dev, gen) -> list:
    """``decode_attention`` at each new GQA serve shape (B 8, the arch's H,
    G and D) over ``FAM_DA_S`` positions in bfloat16, against its plain
    version within ``_da_close`` at cache_len 1, S - 13 and S, bitwise
    repeatable; device times beside the bound, the plain version and
    ``scaled_dot_product_attention``. deepseek-v2-236b's MLA decode never
    calls it."""
    from repro_torch.configs import get_config

    recs = []
    tol = DA_TOL["bfloat16"]
    for arch in FAMILIES:
        cfg = get_config(arch)
        if cfg.use_mla:
            continue
        B, H, G, D = 8, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        for S in FAM_DA_S:
            q = torch.randn((B, H, D), generator=gen, device=dev).bfloat16()
            k = torch.randn((B, S, G, D), generator=gen,
                            device=dev).bfloat16()
            v = torch.randn((B, S, G, D), generator=gen,
                            device=dev).bfloat16()
            err = max(_da_check(torch, q, k, v, clen, tol)[0]
                      for clen in (1, S - 13, S))
            cut, cut_text = _da_cut(q, k, v, S)
            t = _da_times(torch, q, k, v, S, tol)
            rec = dict(arch=arch, B=B, H=H, G=G, D=D, S=S, rep=H // G,
                       max_abs_err=err, splits=cut["splits"],
                       tile_bytes=cut["tile_bytes"], **t)
            say(f"  decode_attention {arch} B={B} H={H} G={G} D={D} (rep "
                f"{H // G}) S={S} bfloat16: max_abs_err {err:.3e}; "
                f"{cut_text}, kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f}, sdpa {t['library_ms']:.4f}, bound "
                f"{t['bound_ms']:.6f} ({t['bound_by']})")
            recs.append(rec)
    return recs


def family_parity(torch, dev) -> str:
    """Each new arch in float32 through ``decode_parity`` (12 decode steps
    card == CPU): ``FAM_PARITY_FULL`` at full width with 2 layers, the
    others at their smoke configs."""
    from repro_torch.configs import get_config, get_smoke_config

    done = []
    for arch in FAMILIES:
        t0 = time.perf_counter()
        full = arch in FAM_PARITY_FULL
        cfg = (get_config(arch).replace(n_layers=2) if full
               else get_smoke_config(arch))
        err = decode_parity(torch, dev, cfg.replace(dtype="float32",
                                                    remat=False))
        done.append(f"{arch} ({'full width' if full else 'smoke'}, d "
                    f"{cfg.d_model}, {cfg.n_layers} layers): max |logit "
                    f"diff| {err:.3e} in {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    return ("float32, 12 decode steps card == CPU (greedy tokens equal, "
            "every cache within 1e-5): " + "; ".join(done))


def family_serve(torch, dev) -> tuple:
    """Each new arch at full width through ``serve_arch``, qwen1.5-110b and
    deepseek-v2-236b cut in depth to ``FAM_SERVE_LAYERS``. For
    qwen1.5-110b also ``prefill`` over the 160 tokens fed against the
    loop's last logits (``decode_vs_prefill``), and for deepseek-v2-236b
    the same in float32 at ``FAM_MLA_CHECK_LAYERS`` layers. Returns (the
    launch counts summed, a record per arch)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T

    total = {k: 0 for k in build.LAUNCHES}
    recs = []
    for arch in FAMILIES:
        cfg = get_config(arch)
        if arch in FAM_SERVE_LAYERS:
            cfg = cfg.replace(n_layers=FAM_SERVE_LAYERS[arch])
            say(f"serve {arch}: depth cut to {cfg.n_layers} of "
                f"{get_config(arch).n_layers} layers (one card's 80 GB)")
        rec, params, prompts, out = serve_arch(torch, dev, cfg)
        for k, v in rec["launches"].items():
            total[k] += v
        if arch in FAM_SERVE_LAYERS and not cfg.is_moe:
            rec["decode_vs_prefill"] = decode_vs_prefill(
                torch, params, cfg, torch.cat([prompts, out.tokens], dim=1),
                out.logits, 3e-2)
            say(f"serve {arch}: bfloat16 {rec['decode_vs_prefill']}")
        recs.append(rec)
        del params, out, prompts
        torch.cuda.empty_cache()
        if arch in FAM_SERVE_LAYERS and cfg.is_moe:
            cfg = cfg.replace(n_layers=FAM_MLA_CHECK_LAYERS, dtype="float32")
            gen = torch.Generator(device=dev).manual_seed(0)
            params = T.init(cfg, gen)
            B, S = 8, 160
            toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                 device=dev)
            cache = T.init_cache(cfg, B, S)
            for t in range(S):
                logits, cache = T.decode_step(params, cfg,
                                              {"token": toks[:, t]}, cache, t)
            rec["decode_vs_prefill"] = decode_vs_prefill(
                torch, params, cfg, toks, logits, 1e-4)
            say(f"serve {arch}: float32 at {cfg.n_layers} layers, "
                f"{rec['decode_vs_prefill']}")
            del params, cache, logits
            torch.cuda.empty_cache()
    return total, recs


def decode_vs_prefill(torch, params, cfg, fed, last, tol) -> str:
    """The decode loop's last logits ``last`` against ``prefill`` over the
    tokens it was fed, within ``tol`` relative and ``tol`` of max(1, the
    largest |logit|) absolute (in bfloat16 the two paths round
    activations in other places; float32 sums in other orders). Under
    MoE at a capacity that drops nothing (cf E / K), as a decode step of
    8 tokens drops none either."""
    from repro_torch.models import transformer as T

    if cfg.is_moe:
        cfg = cfg.replace(capacity_factor=cfg.n_experts
                          / cfg.experts_per_token)
    t0 = time.perf_counter()
    with torch.no_grad():
        full = T.prefill(params, cfg, {"tokens": fed})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    scale = max(1.0, float(full.abs().max()))
    torch.testing.assert_close(last, full, rtol=tol, atol=tol * scale)
    return (f"decode's last logits == prefill over the {fed.shape[1]} "
            f"tokens (max |diff| {float((last - full).abs().max()):.3e}, "
            f"largest |logit| {scale:.2f}, tol {tol}; the forward "
            f"{wall:.2f} s)")


def family_smoke_train(torch, dev) -> str:
    """deepseek-v2-236b's smoke config in float32 (MLA and 2 shared
    experts; at full width one layer outgrows one card's training state):
    ``loss_fn``'s value, aux and every gradient leaf on the card against
    the CPU from the same CPU-drawn parameters and batch, within 1e-5 of
    the loss and 1e-4 of each gradient entry and 1e-5 of each leaf's
    norm (float32 summed in other orders; TF32 off), routing equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import token_stream
    from repro_torch.launch.train import to_device
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves, value_and_grad

    cfg = get_smoke_config("deepseek-v2-236b").replace(dtype="float32",
                                                       remat=False)
    cpu = T.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = next(token_stream(cfg.vocab_size, 4, 64, seed=1))
    outs = []
    for d, params in (("cpu", cpu), (dev, _tree_to(cpu, dev))):
        (loss, aux), g = value_and_grad(lambda p, b: T.loss_fn(p, cfg, b),
                                        params, to_device(batch, d),
                                        has_aux=True)
        outs.append((float(loss), {k: float(v) for k, v in aux.items()},
                     [x.cpu() for x in leaves(g)]))
    (l0, a0, g0), (l1, a1, g1) = outs
    if abs(l1 - l0) > 1e-5 * max(1.0, abs(l0)) or a1["drop_frac"] != \
            a0["drop_frac"] or abs(a1["lb_loss"] - a0["lb_loss"]) > 1e-5:
        raise AssertionError(f"deepseek smoke train: card {l1} {a1} != CPU "
                             f"{l0} {a0}")
    worst = 0.0
    for x, y in zip(g1, g0):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4)
        worst = max(worst, float((x - y).norm() / y.norm().clamp(min=1e-30)))
    if worst > 1e-5:
        raise AssertionError(f"deepseek smoke train: gradient {worst} of "
                             f"its norm from the CPU's")
    return (f"{cfg.name} smoke float32: loss {l1:.6f} (CPU {l0:.6f}), "
            f"lb_loss {a1['lb_loss']:.6f}, drop_frac {a1['drop_frac']:.4f}, "
            f"{len(g1)} gradient leaves card == CPU (worst {worst:.2e} of a "
            f"leaf's norm)")


def phase_families(torch, dev, scratch: str) -> tuple:
    """10: the other dense configs, MoE and MLA on the card. The kernels at
    their new shapes (``decode_attention`` at each serve shape; the report
    and ``sparse_aggregate`` at granite's ``experts_w1`` gradient row);
    each arch card == CPU in float32; each served at full width in
    bfloat16; granite-moe-3b-a800m trained at full width with its depth
    cut to ``MOE_TRAIN_LAYERS`` through ``MOE_PATHS`` (the manual sync on
    a world-size-1 NCCL group); deepseek-v2-236b's smoke training card ==
    CPU; ``launch.train --smoke`` for granite and deepseek and ``launch.
    serve --smoke`` for every new arch on the card. Returns (the phase's
    launch counts, the kernels' records)."""
    import contextlib
    import io
    import math
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.sparsify import bucket_budgets
    from repro_torch.data.pipeline import token_stream
    from repro_torch.kernels import build
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.tree import flatten, value_and_grad

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(10)
    da = family_da_check(torch, dev, gen)
    say(f"families: {family_parity(torch, dev)}")
    total, served = family_serve(torch, dev)

    os.makedirs(scratch, exist_ok=True)
    pg = os.path.join(scratch, "pg_file_families")
    if os.path.exists(pg):
        os.remove(pg)
    dist.init_process_group("nccl", init_method=f"file://{pg}", rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(1, 1)
        cfg = get_config(MOE_ARCH).replace(n_layers=MOE_TRAIN_LAYERS,
                                           remat=False)
        t0 = time.perf_counter()
        base = T.init(cfg, gen)
        names = _leaf_names(base)
        sizes = [p.numel() for p in flatten(base)[0]]
        budgets = bucket_budgets(sizes, LM_TRAIN["r"], LM_TRAIN["k"])
        stream = token_stream(cfg.vocab_size, LM_TRAIN["batch"],
                              LM_TRAIN["seq"], seed=1)
        batches = [train.to_device(next(stream), dev)
                   for _ in range(ARCH_STEPS)]
        say(f"moe train: {cfg.name} at full width, depth cut to "
            f"{cfg.n_layers} of {get_config(MOE_ARCH).n_layers} layers: "
            f"{sum(sizes):,} params in {len(sizes)} leaves, bfloat16, init "
            f"{time.perf_counter() - t0:.1f} s; buckets (d, r_b, k_b): "
            + ", ".join(f"{n} ({d:,}, {r}, {k})"
                        for n, d, (r, k) in zip(names, sizes, budgets)))
        _, grads = value_and_grad(lambda p, b: T.loss_fn(p, cfg, b)[0],
                                  base, batches[0])
        i = names.index("layers/moe/experts_w1")
        report = [lm_report_check(torch, flatten(grads)[0][i], budgets[i][0],
                                  f"{MOE_ARCH} {names[i]} gradient")]
        del grads
        aggregate = lm_aggregate_check(torch, dev, gen, sizes[i],
                                       budgets[i][1])
        torch.cuda.empty_cache()
        runs = lm_full_width(torch, dev, mesh, base, batches, cfg, MOE_PATHS,
                             profiled=SSM_PROFILED, steps=ARCH_STEPS)
        for rec in runs.values():
            for k, v in rec["launches"].items():
                total[k] += v
        del base, batches
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    say(f"families: {family_smoke_train(torch, dev)}")
    clis = [["launch.train", "--arch", MOE_ARCH, "--smoke", "--steps", "20"],
            ["launch.train", "--arch", "deepseek-v2-236b", "--smoke",
             "--steps", "5"]]
    clis += [["launch.serve", "--arch", a, "--smoke"] for a in FAMILIES]
    for argv in clis:
        mod = {"launch.train": train, "launch.serve": serve}[argv[0]]
        buf = io.StringIO()
        build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = mod.main(argv[1:])
        for k, v in build.LAUNCHES.items():
            total[k] += v
        if mod is train and not all(map(math.isfinite, res["losses"])):
            raise AssertionError(f"{' '.join(argv)}: losses "
                                 f"{res['losses']}")
        say(f"families: `{' '.join(argv)}` on the card in "
            f"{time.perf_counter() - t0:.1f} s: "
            + " | ".join(buf.getvalue().strip().splitlines()))
    say(f"families: phase wall {time.perf_counter() - t_phase:.1f} s; "
        f"launches {total}")
    return total, {"decode_attention": da, "threshold_topk_batch": report,
                   "sparse_aggregate": aggregate, "serve": served,
                   "moe_train": runs}


# ---------------------------------------------------------------------------
# 11: the SSM and hybrid families
# ---------------------------------------------------------------------------

# mamba2-780m (attention-free Mamba2) and zamba2-2.7b (Mamba2 with one
# shared attention block after every 6 layers)
SSM_ARCHS = ("mamba2-780m", "zamba2-2.7b")
# decode_attention at zamba2's serve shape (B 8, H = G = 32, D 80): the
# serve phase's cache at its end, a longer one, and the 8,192-position
# window, zamba2's longest cache
D80_SERVE = (8, 32, 32, 80)
D80_S = (160, 4096, 8192)
# card == CPU in float32 at full width (layers, the caches' tolerance):
# mamba2 at 2 layers; zamba2 at 6, one group and one application of the
# shared block (so the D 80 kernel runs in float32 against the CPU's plain
# version), whose caches after six full-width layers of float32 sums in
# other orders lie up to 1.3e-5 from the CPU's (the conv state of layer 6
# on the H100), past the 1e-5 that two layers hold
SSM_PARITY = {"mamba2-780m": (2, 1e-5), "zamba2-2.7b": (6, 1e-4)}
# zamba2-2.7b's training cut, a multiple of its 6-layer group: 30 of 54
# layers, 1.38 B parameters. At 36 layers (1.62 B, about internlm2-1.8b's
# 1.7 B) the single rAge-k path peaked at 55.8 GiB, but the manual sync's
# ran out of the card's memory at its ninth step on the H100 (52.2 GiB
# allocated and 25.0 GiB reserved but free, cut up by the 3.9 GB float32
# temporaries of the 963 M-element in_proj); 54 layers would be 2.34 B
HYBRID_TRAIN_LAYERS = 30
# the profiled steps of each training path of phases 10-12: one, to keep
# the phases short (the profiler's trace of a step holds some 10,000
# kernels)
SSM_PROFILED = 1


def d80_da_check(torch, dev, gen) -> list:
    """``decode_attention`` at D 80 (``csrc/decode_attention_d80.cu``) at
    zamba2's serve shape over ``D80_S`` positions in bfloat16 and float32:
    against its plain version within ``_da_close`` at cache_len 1, S - 13
    and S, bitwise repeatable; device times beside the bound, the plain
    version and ``scaled_dot_product_attention``."""
    recs = []
    B, H, G, D = D80_SERVE
    for dtype, tol in DA_TOL.items():
        dt = getattr(torch, dtype)
        for S in D80_S:
            q = torch.randn((B, H, D), generator=gen, device=dev).to(dt)
            k = torch.randn((B, S, G, D), generator=gen, device=dev).to(dt)
            v = torch.randn((B, S, G, D), generator=gen, device=dev).to(dt)
            err = max(_da_check(torch, q, k, v, clen, tol)[0]
                      for clen in (1, S - 13, S))
            cut, cut_text = _da_cut(q, k, v, S)
            t = _da_times(torch, q, k, v, S, tol)
            rec = dict(arch="zamba2-2.7b", B=B, H=H, G=G, D=D, S=S,
                       dtype=dtype, max_abs_err=err, splits=cut["splits"],
                       tile_bytes=cut["tile_bytes"], **t)
            say(f"  decode_attention zamba2 B={B} H={H} G={G} D={D} S={S} "
                f"{dtype} ({2 * k.numel() * k.element_size() / 1e6:.0f} MB "
                f"of K and V): max_abs_err {err:.3e}; {cut_text}, kernel "
                f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, sdpa "
                f"{t['library_ms']:.4f}, bound {t['bound_ms']:.6f} "
                f"({t['bound_by']})")
            recs.append(rec)
            del q, k, v
    return recs


def ssm_parity(torch, dev, arch: str) -> str:
    """``arch`` at full width with ``SSM_PARITY`` layers in float32: 12
    decode steps card == CPU (``decode_parity``, the caches within
    ``SSM_PARITY``'s tolerance); ``prefill`` over 12
    tokens card == CPU within rtol=atol=1e-4; and on the card the decode
    loop's last logits == ``prefill`` over the tokens it was fed
    (``decode_vs_prefill`` at 1e-4)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    layers, cache_tol = SSM_PARITY[arch]
    cfg = get_config(arch).replace(n_layers=layers, dtype="float32",
                                   remat=False)
    err = decode_parity(torch, dev, cfg, cache_tol)
    cpu = T.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = _tree_to(cpu, dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = T.prefill(cpu, cfg, {"tokens": toks})
        got = T.prefill(card, cfg, {"tokens": toks.to(dev)})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    cache = T.init_cache(cfg, 2, 12, device=dev)
    for t in range(12):
        logits, cache = T.decode_step(card, cfg, {"token": toks[:, t].to(dev)},
                                      cache, t)
    same = decode_vs_prefill(torch, card, cfg, toks.to(dev), logits, 1e-4)
    return (f"{arch} (full width, {cfg.n_layers} layers, float32): 12 decode "
            f"steps card == CPU (max |logit diff| {err:.3e}, caches within "
            f"{cache_tol}); prefill card "
            f"== CPU (max |diff| {float((got.cpu() - want).abs().max()):.3e});"
            f" {same}; in {time.perf_counter() - t0:.1f} s")


def ssm_train(torch, dev, mesh, arch: str, gen) -> tuple:
    """``arch`` at full width in bfloat16 (zamba2 cut to
    ``HYBRID_TRAIN_LAYERS``) through ``arch_train`` on
    ``data.token_stream``'s batches."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import token_stream
    from repro_torch.launch import train

    full = get_config(arch)
    cfg = full.replace(remat=False)
    if cfg.family == "hybrid":
        cfg = cfg.replace(n_layers=HYBRID_TRAIN_LAYERS)
    stream = token_stream(cfg.vocab_size, LM_TRAIN["batch"],
                          LM_TRAIN["seq"], seed=1)
    batches = [train.to_device(next(stream), dev)
               for _ in range(ARCH_STEPS)]
    return arch_train(torch, dev, mesh, cfg, full.n_layers, gen, batches)


def arch_train(torch, dev, mesh, cfg, full_layers: int, gen,
               batches) -> tuple:
    """``cfg`` (of ``full_layers`` at full depth) in bfloat16 from one
    ``T.init``: the report and ``sparse_aggregate`` at the largest
    bucket's gradient (on ``batches[0]``) == their plain versions, then
    ``ARCH_STEPS`` steps of each ``MOE_PATHS`` path on ``batches``
    (``lm_full_width``). Returns (the paths' launch counts, the report's
    and the aggregate's records, the paths' records)."""
    from repro_torch.core.sparsify import bucket_budgets
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T
    from repro_torch.tree import flatten, value_and_grad

    t0 = time.perf_counter()
    base = T.init(cfg, gen)
    names = _leaf_names(base)
    leaves = flatten(base)[0]
    sizes = [p.numel() for p in leaves]
    budgets = bucket_budgets(sizes, LM_TRAIN["r"], LM_TRAIN["k"])
    say(f"train: {cfg.name} at full width, {cfg.n_layers} of "
        f"{full_layers} layers: {sum(sizes):,} params in {len(sizes)} "
        f"leaves ({', '.join(sorted({str(p.dtype)[6:] for p in leaves}))}),"
        f" init {time.perf_counter() - t0:.1f} s; buckets (d, r_b, k_b): "
        + ", ".join(f"{n} ({d:,}, {r}, {k})"
                    for n, d, (r, k) in zip(names, sizes, budgets)))
    big = max(range(len(sizes)), key=sizes.__getitem__)
    if sizes[big] >= 2 ** 31:
        raise AssertionError(f"{cfg.name}: bucket {names[big]} has "
                             f"{sizes[big]:,} elements, past int32")
    _, grads = value_and_grad(lambda p, b: T.loss_fn(p, cfg, b)[0], base,
                              batches[0])
    report = [lm_report_check(torch, flatten(grads)[0][big], budgets[big][0],
                              f"{cfg.name} {names[big]} gradient")]
    del grads
    torch.cuda.empty_cache()
    aggregate = lm_aggregate_check(torch, dev, gen, sizes[big],
                                   budgets[big][1])
    torch.cuda.empty_cache()
    runs = lm_full_width(torch, dev, mesh, base, batches, cfg, MOE_PATHS,
                         profiled=SSM_PROFILED, steps=ARCH_STEPS)
    total = {k: 0 for k in build.LAUNCHES}
    for rec in runs.values():
        for k, v in rec["launches"].items():
            total[k] += v
    del base, batches
    torch.cuda.empty_cache()
    return total, report, aggregate, runs


def phase_ssm_hybrid(torch, dev, scratch: str) -> tuple:
    """11: the SSM and hybrid families on the card. ``decode_attention`` at
    D 80 (``d80_da_check``); each arch card == CPU in float32
    (``ssm_parity``); each served at full width and depth in bfloat16
    (``serve_arch``, then the top device kernels of four decode steps);
    each trained at full width (``ssm_train``) over a world-size-1 NCCL
    group; ``launch.serve --smoke`` and ``launch.train --smoke`` for both
    on the card. Returns (the phase's launch counts, the records)."""
    import contextlib
    import io
    import math
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    walls = {}
    gen = torch.Generator(device=dev).manual_seed(11)
    da = d80_da_check(torch, dev, gen)
    torch.cuda.empty_cache()
    walls["decode_attention"] = time.perf_counter() - t_phase
    for arch in SSM_ARCHS:
        say(f"ssm parity: {ssm_parity(torch, dev, arch)}")
        torch.cuda.empty_cache()
    walls["parity"] = time.perf_counter() - t_phase - sum(walls.values())

    total = {k: 0 for k in build.LAUNCHES}
    served = []
    for arch in SSM_ARCHS:
        rec, params, prompts, out = serve_arch(torch, dev, get_config(arch))
        for k, v in rec["launches"].items():
            total[k] += v
        profile_decode(torch, dev, params, get_config(arch), prompts[:, :8],
                       steps=2)
        served.append(rec)
        del params, prompts, out
        torch.cuda.empty_cache()
    walls["serve"] = time.perf_counter() - t_phase - sum(walls.values())

    os.makedirs(scratch, exist_ok=True)
    pg = os.path.join(scratch, "pg_file_ssm")
    if os.path.exists(pg):
        os.remove(pg)
    dist.init_process_group("nccl", init_method=f"file://{pg}", rank=0,
                            world_size=1)
    report, aggregate, trained = [], [], {}
    try:
        mesh = make_host_mesh(1, 1)
        for arch in SSM_ARCHS:
            launches, rep_, agg, runs = ssm_train(torch, dev, mesh, arch, gen)
            for k, v in launches.items():
                total[k] += v
            report += rep_
            aggregate += agg
            trained[arch] = runs
    finally:
        dist.destroy_process_group()
    walls["train"] = time.perf_counter() - t_phase - sum(walls.values())

    for arch in SSM_ARCHS:
        for argv in (["launch.serve", "--arch", arch, "--smoke"],
                     ["launch.train", "--arch", arch, "--smoke", "--steps",
                      "5"]):
            mod = {"launch.train": train, "launch.serve": serve}[argv[0]]
            buf = io.StringIO()
            build.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = mod.main(argv[1:])
            for k, v in build.LAUNCHES.items():
                total[k] += v
            if mod is train and not all(map(math.isfinite, res["losses"])):
                raise AssertionError(f"{' '.join(argv)}: losses "
                                     f"{res['losses']}")
            say(f"ssm: `{' '.join(argv)}` on the card in "
                f"{time.perf_counter() - t0:.1f} s: "
                + " | ".join(buf.getvalue().strip().splitlines()))
    walls["cli"] = time.perf_counter() - t_phase - sum(walls.values())
    say(f"ssm: phase wall {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
        + f"); launches {total}")
    return total, {"decode_attention": da, "threshold_topk_batch": report,
                   "sparse_aggregate": aggregate, "serve": served,
                   "train": trained}

# ---------------------------------------------------------------------------
# 12: the VLM and audio families
# ---------------------------------------------------------------------------

VLM_ARCH = "pixtral-12b"
AUDIO_ARCH = "whisper-large-v3"
# decode_attention at the two archs' decode shapes, batch 8: (label, H, G,
# D, positions, dtype). pixtral (rep 4, D 128): the serve cache at its end
# and a longer one; whisper (rep 1, D 64): its 448 self positions and its
# 1,500 cross positions (30 s of audio: 3,000 frames downsampled 2x), the
# latter in float32 too
VA_DA = [("pixtral-12b", 32, 8, 128, 160, "bfloat16"),
         ("pixtral-12b", 32, 8, 128, 4096, "bfloat16"),
         ("whisper-large-v3 self", 20, 20, 64, 448, "bfloat16"),
         ("whisper-large-v3 cross", 20, 20, 64, 1500, "bfloat16"),
         ("whisper-large-v3 cross", 20, 20, 64, 1500, "float32")]
# card == CPU in float32 at full width: pixtral at 2 layers, whisper at 2
# encoder and 2 decoder layers
VA_PARITY_LAYERS = 2
# pixtral-12b's training cut, 4 of 40 layers: 1,761,648,640 parameters by
# param_count, about internlm2-1.8b's 1.70 B, which phase 6r trains at a
# 54-68 GiB peak (5 layers would be 2.03 B; at full depth the stacked
# mlp.w1 passes int32 from 30 layers); whisper-large-v3 trains at full depth
VLM_TRAIN_LAYERS = 4
# whisper's decode: 30 s of audio (3,000 frames, 1,500 encoder positions)
# for a batch of 8, a 128-token prompt fed by decode steps, 32 greedy
# tokens, then one step past its 448 target positions
AUDIO_FRAMES = 3000


def va_da_check(torch, dev, gen) -> list:
    """``decode_attention`` at ``VA_DA``: against its plain version within
    ``_da_close`` at cache_len 1, S - 13 and S, bitwise repeatable;
    device times beside the bound, the plain version and
    ``scaled_dot_product_attention``."""
    recs = []
    B = 8
    for label, H, G, D, S, dtype in VA_DA:
        dt, tol = getattr(torch, dtype), DA_TOL[dtype]
        q = torch.randn((B, H, D), generator=gen, device=dev).to(dt)
        k = torch.randn((B, S, G, D), generator=gen, device=dev).to(dt)
        v = torch.randn((B, S, G, D), generator=gen, device=dev).to(dt)
        err = max(_da_check(torch, q, k, v, clen, tol)[0]
                  for clen in (1, S - 13, S))
        cut, cut_text = _da_cut(q, k, v, S)
        t = _da_times(torch, q, k, v, S, tol)
        recs.append(dict(arch=label, B=B, H=H, G=G, D=D, S=S, dtype=dtype,
                         rep=H // G, max_abs_err=err, splits=cut["splits"],
                         tile_bytes=cut["tile_bytes"], **t))
        say(f"  decode_attention {label} B={B} H={H} G={G} D={D} (rep "
            f"{H // G}) S={S} {dtype} ({2 * k.numel() * k.element_size() / 1e6:.1f}"
            f" MB of K and V): max_abs_err {err:.3e}; {cut_text}, kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, sdpa "
            f"{t['library_ms']:.4f}, bound {t['bound_ms']:.6f} "
            f"({t['bound_by']})")
        del q, k, v
    return recs


def fill_cross(torch, params, cfg, frames, cache):
    """The audio decode's cross caches, which neither package writes
    (ROADMAP queue 3, fault 8), filled for the checks: the encoder's output
    over ``frames`` through each decoder layer's cross ``wk`` / ``wv``, (B,
    S_enc, G, D) a layer, no RoPE, as ``_cross_attn_seq`` projects it."""
    from repro_torch.models import transformer as T

    B, S = frames.shape[:2]
    with torch.no_grad():
        enc = T._encoder(params, cfg, frames)
        p = params["layers"]["cross_attn"]
        for i in range(cfg.n_layers):
            for name, w in (("cross_k", "wk"), ("cross_v", "wv")):
                cache[name][i] = (enc @ p[w][i]).reshape(
                    B, S, cfg.n_kv_heads, cfg.head_dim_)
    return cache


def va_parity(torch, dev, arch: str) -> str:
    """``arch`` at full width in float32 with ``VA_PARITY_LAYERS`` layers
    (whisper: as many encoder layers), from CPU-drawn parameters: 12 decode
    steps card == CPU (logits within 1e-4, the greedy tokens equal,
    every cache within 1e-5 at the end), from tokens, and for pixtral a
    second pass from ``embed`` inputs; for whisper from cross caches that
    ``fill_cross`` fills from the same frames on each device. Then
    ``prefill`` card == CPU within 1e-4, and on the card the decode loop's
    last logits == ``prefill`` over the same inputs within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    cfg = get_config(arch).replace(n_layers=VA_PARITY_LAYERS,
                                   dtype="float32", remat=False)
    if cfg.family == "audio":
        cfg = cfg.replace(encoder_layers=VA_PARITY_LAYERS)
    cpu = T.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = _tree_to(cpu, dev)
    B, S = 2, 12
    hg = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=hg)
    if cfg.family == "vlm":
        embeds = torch.randn((B, S, cfg.d_model), generator=hg)
        passes = {"tokens": [{"token": toks[:, t]} for t in range(S)],
                  "embeds": [{"embed": embeds[:, t]} for t in range(S)]}
        pre = {"embeds": embeds}
    else:
        frames = torch.randn((B, 64, cfg.d_model), generator=hg)
        passes = {"tokens": [{"token": toks[:, t]} for t in range(S)]}
        pre = {"frames": frames, "tokens": toks}
    done = []
    for name, feeds in passes.items():
        caches = [T.init_cache(cfg, B, 128, device=d) for d in ("cpu", dev)]
        if cfg.family == "audio":
            caches = [fill_cross(torch, cpu, cfg, frames, caches[0]),
                      fill_cross(torch, card, cfg, frames.to(dev), caches[1])]
        err = 0.0
        for t, inp in enumerate(feeds):
            with torch.no_grad():
                lc, _ = T.decode_step(cpu, cfg, inp, caches[0], t)
                lg, _ = T.decode_step(card, cfg, _tree_to(inp, dev),
                                      caches[1], t)
            torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
            if not torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1)):
                raise AssertionError(f"{arch} parity ({name}): greedy tokens "
                                     f"differ at step {t}")
            err = max(err, float((lg.cpu() - lc).abs().max()))
        for key in caches[0]:
            torch.testing.assert_close(caches[1][key].cpu(), caches[0][key],
                                       rtol=1e-5, atol=1e-5)
        done.append(f"{S} decode steps from {name} card == CPU (max |logit "
                    f"diff| {err:.3e})")
        if name == "tokens" and cfg.family == "audio" or name == "embeds":
            with torch.no_grad():
                want = T.prefill(cpu, cfg, pre)
                got = T.prefill(card, cfg, _tree_to(pre, dev))
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
            scale = max(1.0, float(got.abs().max()))
            torch.testing.assert_close(lg, got, rtol=1e-4, atol=1e-4 * scale)
            done.append(f"prefill over {'/'.join(pre)} card == CPU (max "
                        f"|diff| {float((got.cpu() - want).abs().max()):.3e}"
                        f"), == the decode loop's last logits on the card "
                        f"(max |diff| {float((lg - got).abs().max()):.3e})")
    return (f"{arch} (full width d {cfg.d_model}, {cfg.n_layers} layers"
            + (f" and {cfg.encoder_layers} encoder layers, frames (2, 64, "
               f"{cfg.d_model})" if cfg.family == "audio" else "")
            + f", float32): " + "; ".join(done)
            + f"; in {time.perf_counter() - t0:.1f} s")


def audio_decode(torch, dev) -> tuple:
    """whisper-large-v3 at full width and depth in bfloat16 (``launch.serve``
    refuses audio, so through ``decode_step``): ``init_cache(cfg, 8,
    AUDIO_FRAMES)`` (self caches of 448, cross caches of 1,500), the cross
    caches filled (``fill_cross``) from random frames (8, 1,500, 1,280)
    under ``no_grad``, a 128-token prompt fed by decode steps, then 32
    greedy tokens: finite logits, ``decode_attention`` twice a layer a
    step and no other kernel; host ms a step after a sync. Then the
    clamps: a step at position 448 and one at 10,000 from copies of the
    same self caches give equal logits (the learned position's row, RoPE,
    the slot and cache_len all clamp to the last target position, as the
    reference's gathers do). Then four steps under the profiler. Returns
    (a record, the launches of the decode loop)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T

    cfg = get_config(AUDIO_ARCH).replace(remat=False)
    B, P, GEN = 8, 128, 32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = T.init(cfg, gen)
    cache = T.init_cache(cfg, B, AUDIO_FRAMES)
    frames = torch.randn((B, AUDIO_FRAMES // cfg.frontend_downsample,
                          cfg.d_model), generator=gen, device=dev).bfloat16()
    fill_cross(torch, params, cfg, frames, cache)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device=dev)
    build.reset_launches()
    finite = torch.ones((), dtype=torch.bool, device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        for t in range(P):
            logits, _ = T.decode_step(params, cfg, {"token": prompts[:, t]},
                                      cache, t)
            finite &= torch.isfinite(logits).all()
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        toks = []
        t0 = time.perf_counter()
        for t in range(P, P + GEN):
            tok = logits.argmax(-1)
            toks.append(tok)
            logits, _ = T.decode_step(params, cfg, {"token": tok}, cache, t)
            finite &= torch.isfinite(logits).all()
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    want = {k: (attention_layers(cfg) * (P + GEN) if k == "decode_attention"
                else 0) for k in launches}
    if launches != want:
        raise AssertionError(f"whisper decode: kernel launches {launches}, "
                             f"expected {want}")
    if not bool(finite) or logits.shape != (B, cfg.padded_vocab):
        raise AssertionError("whisper decode: non-finite logits or a wrong "
                             "shape")
    tok = logits.argmax(-1)
    past = []
    for pos in (cfg.max_target_len, 10_000):
        c = dict(cache, k=cache["k"].clone(), v=cache["v"].clone())
        with torch.no_grad():
            past.append(T.decode_step(params, cfg, {"token": tok}, c, pos)[0])
    if not (torch.equal(past[0], past[1]) and bool(torch.isfinite(
            past[0]).all())):
        raise AssertionError("whisper decode: steps past the 448 target "
                             "positions do not clamp alike")
    peak = torch.cuda.max_memory_allocated()
    cache_bytes = sum(c.numel() * c.element_size() for c in cache.values())
    n_params = sum(w.numel() for w in _leaves(params))
    rec = dict(arch=cfg.name, n_layers=cfg.n_layers, params=n_params,
               setup_s=setup_s, prefill_s=prefill_s,
               decode_tok_s=B * GEN / decode_s,
               ms_per_step=decode_s / GEN * 1e3, peak_bytes=peak,
               cache_bytes=cache_bytes, launches=launches)
    say(f"audio decode {cfg.name}: {cfg.encoder_layers} + {cfg.n_layers} "
        f"layers d={cfg.d_model}, {n_params / 1e9:.3f} B params bfloat16 on "
        f"{torch.cuda.get_device_name(0)}, batch {B}, {AUDIO_FRAMES} frames "
        f"(init, encoder and cross caches {setup_s:.1f} s), prompt {P} by "
        f"decode steps {prefill_s:.3f} s, {GEN} greedy tokens at "
        f"{rec['decode_tok_s']:.1f} tokens/s over the batch "
        f"({rec['ms_per_step']:.2f} ms a step), peak {peak / 2**30:.3f} GiB, "
        f"cache {cache_bytes / 2**20:.1f} MiB ({'/'.join(cache)}), launches "
        f"{ {k: v for k, v in launches.items() if v} } "
        f"({attention_layers(cfg)} decode_attention a step); steps at "
        f"positions {cfg.max_target_len} and 10,000 equal (clamped); first "
        f"row "
        f"{torch.stack(toks, 1)[0].tolist()}")

    def run():
        with torch.no_grad():
            for pos in range(P + GEN, P + GEN + 4):
                T.decode_step(params, cfg, {"token": tok}, cache, pos)
    rec["profile"] = profile_steps(torch, run, 2)
    del params, cache, frames
    torch.cuda.empty_cache()
    return rec, launches


def phase_vlm_audio(torch, dev, scratch: str) -> tuple:
    """12: the VLM and audio families on the card. ``decode_attention`` at
    pixtral's and whisper's decode shapes (``va_da_check``); each arch card
    == CPU in float32 at full width (``va_parity``); pixtral-12b served
    at full width and depth in bfloat16 (``serve_arch``, then four
    profiled decode steps); whisper-large-v3 decoded at full width and
    depth (``audio_decode``); each trained at full width (pixtral cut to
    ``VLM_TRAIN_LAYERS``) through ``arch_train`` on
    ``registry.concrete_batch`` batches (batch 8, seq 128) over a
    world-size-1 NCCL group; ``launch.serve --arch pixtral-12b --smoke``
    on the card, and the refusals of ``launch.serve`` for whisper and
    ``launch.train`` for both. Returns (the phase's launch counts, the
    records)."""
    import contextlib
    import io
    import torch.distributed as dist
    from repro_torch.configs import InputShape, get_config
    from repro_torch.kernels import build
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import concrete_batch

    t_phase = time.perf_counter()
    walls = {}
    gen = torch.Generator(device=dev).manual_seed(12)
    da = va_da_check(torch, dev, gen)
    torch.cuda.empty_cache()
    walls["decode_attention"] = time.perf_counter() - t_phase
    for arch in (VLM_ARCH, AUDIO_ARCH):
        say(f"vlm/audio parity: {va_parity(torch, dev, arch)}")
        torch.cuda.empty_cache()
    walls["parity"] = time.perf_counter() - t_phase - sum(walls.values())

    total = {k: 0 for k in build.LAUNCHES}
    cfg = get_config(VLM_ARCH)
    rec, params, prompts, out = serve_arch(torch, dev, cfg)
    total = {k: total[k] + v for k, v in rec["launches"].items()}
    rec["profile"] = profile_decode(torch, dev, params, cfg, prompts[:, :8],
                                    steps=2)
    served = [rec]
    del params, prompts, out
    torch.cuda.empty_cache()
    rec, launches = audio_decode(torch, dev)
    total = {k: total[k] + v for k, v in launches.items()}
    served.append(rec)
    walls["serve"] = time.perf_counter() - t_phase - sum(walls.values())

    os.makedirs(scratch, exist_ok=True)
    pg = os.path.join(scratch, "pg_file_vlm_audio")
    if os.path.exists(pg):
        os.remove(pg)
    dist.init_process_group("nccl", init_method=f"file://{pg}", rank=0,
                            world_size=1)
    report, aggregate, trained = [], [], {}
    shape = InputShape("lm_train", LM_TRAIN["seq"], LM_TRAIN["batch"],
                       "train")
    try:
        mesh = make_host_mesh(1, 1)
        for arch in (VLM_ARCH, AUDIO_ARCH):
            full = get_config(arch)
            cfg = full.replace(remat=False)
            if cfg.family == "vlm":
                cfg = cfg.replace(n_layers=VLM_TRAIN_LAYERS)
            batches = [concrete_batch(cfg, shape, gen)
                       for _ in range(ARCH_STEPS)]
            say(f"vlm/audio train: {arch} batches "
                + ", ".join(f"{k} {tuple(v.shape)} {str(v.dtype)[6:]}"
                            for k, v in batches[0].items()))
            launches, rep_, agg, runs = arch_train(
                torch, dev, mesh, cfg, full.n_layers, gen, batches)
            del batches
            total = {k: total[k] + v for k, v in launches.items()}
            report += rep_
            aggregate += agg
            trained[arch] = runs
    finally:
        dist.destroy_process_group()
    walls["train"] = time.perf_counter() - t_phase - sum(walls.values())

    buf = io.StringIO()
    build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve.main(["--arch", VLM_ARCH, "--smoke"])
    total = {k: total[k] + v for k, v in build.LAUNCHES.items()}
    lines = buf.getvalue().strip().splitlines()
    if not lines[0].startswith(f"arch={VLM_ARCH} "):
        raise AssertionError(f"serve --smoke {VLM_ARCH}: {lines}")
    say(f"vlm/audio: `launch.serve --arch {VLM_ARCH} --smoke` on the card in "
        f"{time.perf_counter() - t0:.1f} s: " + " | ".join(lines))
    refused = []
    for mod, argv, kind, text in (
            (serve, ["--arch", AUDIO_ARCH], SystemExit, "decoder-only"),
            (train, ["--arch", VLM_ARCH, "--smoke"], ValueError, "fault 9"),
            (train, ["--arch", AUDIO_ARCH, "--smoke"], ValueError,
             "fault 9")):
        try:
            mod.main(argv)
        except kind as e:
            if text not in str(e):
                raise
            refused.append(f"`{mod.__name__.split('.')[-1]} "
                           f"{' '.join(argv)}`: {e}")
        else:
            raise AssertionError(f"{mod.__name__} {argv} was not refused")
    say("vlm/audio: refused, as asserted: " + "; ".join(refused))
    walls["cli"] = time.perf_counter() - t_phase - sum(walls.values())
    say(f"vlm/audio: phase wall {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
        + f"); launches {total}")
    return total, {"decode_attention": da, "threshold_topk_batch": report,
                   "sparse_aggregate": aggregate, "serve": served,
                   "train": trained}


def _leaf_names(tree, prefix: str = "") -> list:
    """Leaf paths in ``jax.tree_util`` order, joined with '/'."""
    out = []
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        out += (_leaf_names(tree[k], path) if isinstance(tree[k], dict)
                else [path])
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.data.federated import (paper_cifar_split,
                                            paper_mnist_split)
    from repro_torch.data.synthetic import cifar10_like, mnist_like
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
    dry_dir = os.path.join(ROOT, "build", "dryrun_smoke")
    shutil.rmtree(dry_dir, ignore_errors=True)
    dryrun = start_dryrun(dry_dir)
    train_mem = start_train_memory(dry_dir)
    t_run = time.perf_counter()

    def lap(label):
        state = ("running" if dryrun[0].poll() is None
                 else f"ended {dryrun[0].returncode}")
        say(f"time: {label} done at {time.perf_counter() - t_run:.1f} s "
            f"(dry run {state})")

    kernels = phase_kernels(torch, dev)
    lap("kernels")

    t0 = time.perf_counter()
    (x, y), test = mnist_like(n_train=60_000, n_test=2_000, seed=0)
    shards = paper_mnist_split(x, y, seed=0)
    say(f"data: mnist_like 60000/2000 and paper_mnist_split in "
        f"{time.perf_counter() - t0:.1f} s")
    phase_parity(torch, dev, shards, test)
    lap("parity")
    launches, eng, median_round_s, acc = phase_slice(torch, dev, shards,
                                                     test)
    lap("slice")
    profile = "--profile" in sys.argv[1:]
    if profile:
        phase_profile(torch, eng, median_round_s)
    base, rtop, rtop_median_s = phase_baselines(torch, shards, test, acc)
    lap("baselines")
    if profile:
        phase_profile(torch, rtop, rtop_median_s)
    del eng, rtop
    chunked = phase_chunked(torch, shards, test)
    lap("chunked")
    phase_rates_fig3(torch, shards, test, profile)
    lap("rates")
    phase_partial_parity(torch, dev, shards, test)
    lap("partial parity")
    partial = phase_partial_slice(torch, shards, test)
    lap("partial slice")
    compute = phase_compute_plane(torch)
    lap("compute plane")
    hier = phase_hier_fig3(torch, dev, shards, test)
    lap("hier fig3")
    scratch = os.path.join(ROOT, "build", "ckpt_smoke")
    shutil.rmtree(scratch, ignore_errors=True)
    resume = phase_resume(torch, shards, test, scratch)
    lap("resume")
    faults = phase_faults(torch, dev, shards, test, scratch)
    lap("faults")
    async_fig3 = phase_async_fig3(torch, dev, shards, test, scratch)
    lap("async")
    del shards, test, x, y
    age_mem, seg_bench = phase_age_memory(torch, dev)
    lap("age memory")

    t0 = time.perf_counter()
    (x, y), test = cifar10_like(n_train=50_000, n_test=10_000, seed=0)
    shards = paper_cifar_split(x, y, seed=0)
    del x, y
    say(f"data: cifar10_like 50000/10000 and paper_cifar_split in "
        f"{time.perf_counter() - t0:.1f} s (shard sizes "
        f"{[len(s[1]) for s in shards]})")
    phase_cifar_parity(torch, dev, shards, test)
    lap("cifar parity")
    cifar, real = phase_cifar_slice(torch, dev, shards, test, profile)
    lap("cifar slice")
    cifar_chunked = phase_cifar_chunked(torch, shards, test, profile)
    lap("cifar chunked")
    fig5_partial = phase_fig5_partial(torch, dev, shards, test)
    lap("fig5 partial")
    fig5_hier = phase_fig5_hier(torch, shards, test)
    lap("fig5 hier")
    fig5_resume = phase_fig5_resume(torch, shards, test, scratch)
    lap("fig5 resume")
    fig5_async = phase_fig5_async(torch, shards, test)
    lap("fig5 async")
    del shards, test
    cli = phase_cli(torch, dev, os.path.join(scratch, "cli"))
    lap("cli")
    shutil.rmtree(scratch, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_lm_parity(torch, dev)
    lap("lm parity")
    smoke = phase_smoke_serve(torch, dev)
    lap("smoke serve")
    serve = phase_serve(torch, dev, profile)
    lap("serve")
    torch.cuda.empty_cache()
    long = phase_long_decode(torch, dev)
    lap("long decode")
    torch.cuda.empty_cache()
    lm, lm_recs = phase_lm_train(torch, dev, os.path.join(ROOT, "build",
                                                          "lm_smoke"))
    lap("lm train")
    torch.cuda.empty_cache()
    fam, fam_recs = phase_families(torch, dev, os.path.join(
        ROOT, "build", "lm_smoke"))
    lap("families")
    torch.cuda.empty_cache()
    ssm, ssm_recs = phase_ssm_hybrid(torch, dev, os.path.join(
        ROOT, "build", "lm_smoke"))
    lap("ssm hybrid")
    torch.cuda.empty_cache()
    va, va_recs = phase_vlm_audio(torch, dev, os.path.join(
        ROOT, "build", "lm_smoke"))
    lap("vlm audio")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    axis = lm_recs["model_axis"]
    tuned = autotune_sweep(torch, dev, torch.Generator(
        device=dev).manual_seed(13), dry_dir, axis["slice_elems"],
        axis["r_l"])
    dry = finish_dryrun(*dryrun, dry_dir)
    say(f"model axis: phase 13's sweep and dry run in "
        f"{time.perf_counter() - t0:.1f} s after phase 12")
    lap("model axis")
    phase_train_memory(torch, dev, *train_mem, dry_dir)
    lap("train memory")

    for k in kernels:
        k["launches"] = sum(run[k["name"]] for run in (
            launches, base, chunked, partial, compute, hier, resume,
            faults, async_fig3, age_mem, cifar, cifar_chunked, fig5_partial,
            fig5_hier, fig5_resume, fig5_async, cli, smoke, serve, long, lm,
            fam, ssm, va))
        if k["name"] in lm_recs:
            k["lm_buckets"] = lm_recs[k["name"]]
        if k["name"] == "threshold_topk_batch":
            k["model_axis_slice"] = axis["report"]
            k["autotune"] = tuned["report"]
        if k["name"] == "sparse_aggregate":
            k["model_axis_slice"] = axis["aggregate"]
        if k["name"] == "decode_attention":
            k["autotune"] = {n: v for n, v in tuned.items()
                             if n.startswith("decode")}
        if k["name"] in fam_recs:
            k["families"] = fam_recs[k["name"]]
        if k["name"] in ssm_recs:
            k["ssm_hybrid"] = ssm_recs[k["name"]]
        if k["name"] in va_recs:
            k["vlm_audio"] = va_recs[k["name"]]
        if k["name"] == "segmented_age_topk":
            k["age_bench_packing"] = seg_bench
        if k["name"] in real:
            k["cifar_real_gradients"] = real[k["name"]]
    say(json.dumps({"dryrun": {key: dry[key] for key in (
        "arch", "shape", "mesh", "sync", "roofline", "dominant",
        "flops_per_dev", "bytes_per_dev", "collective_total_per_dev")}}))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
