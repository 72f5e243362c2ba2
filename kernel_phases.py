#!/usr/bin/env python3
"""Phase times inside the rAge-k report kernel and ``segmented_age_topk``,
on one NVIDIA card: ``python3 kernel_phases.py`` from the repository root.

It copies ``src/`` to ``build/phases/src`` (``build/`` is not committed),
puts ``%globaltimer`` stamps at the phase boundaries of the copy's
``csrc/report.cu`` (the last block of row 0: prologue, compaction,
hand-off, refine, gather, sort, write) and ``csrc/segmented_topk.cu``
(block 0: load, sort, each member's walk), builds the copy and prints
the stamps' differences in microseconds for the report at fig3 (10 x
39,760, r 75) and CIFAR (6 x 2,515,338, r 2,500) on ``torch.randn``
rows, and for the selection at fig3 and CIFAR shapes. The stamps cost a
few instructions; the kernels' own times are ``chip_smoke.py``'s and
``kernel_turns.py``'s. The stamped kernels are checked against the plain
versions first. It exits 2 without a card, and fails if a stamp's anchor
is no longer in the source.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
COPY = os.path.join(ROOT, "build", "phases")

TIMER = ('__device__ __forceinline__ unsigned long long stamp() {\n'
         '  unsigned long long t;\n'
         '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
         '  return t;\n}\n')
READ = '''
extern "C" int read_stamps(void* dst) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(dst, STAMPS, sizeof(STAMPS));
  unsigned long long init[64];
  for (int i = 0; i < 64; ++i) init[i] = i == 0 ? ~0ull : 0ull;
  cudaMemcpyToSymbol(STAMPS, init, sizeof(init));
  return static_cast<int>(cudaGetLastError());
}
'''
# (anchor, text put before it) in csrc/report.cu; T0..T7 bound the phases
REPORT = [
    ("namespace {\n\nusing bitonic::spad;",
     "__device__ unsigned long long g_report[64];\n" + TIMER),
    ("  // 1. the row histogram and the threshold bin\n",
     "  const unsigned long long T0 = stamp();\n"
     "  if (tid == 0) atomicMin(&g_report[0], T0);\n"),
    ("  const float* rowp = g + row * d;",
     "  const unsigned long long T1 = stamp();\n"),
    ("  // 3. hand-off: the last block",
     "  const unsigned long long T2 = stamp();\n"),
    ("  // 4. refine the range", "  const unsigned long long T3 = stamp();\n"
     "  int levels = 0;\n"),
    ("  // gather: every value above bin b",
     "  const unsigned long long T4 = stamp();\n"),
    ("  // 5. sort the gathered pairs",
     "  const unsigned long long T5 = stamp();\n"),
]
REPORT_LEVEL = ("    shift = s;\n", "    shift = s;\n    ++levels;\n")
REPORT_END = ("  nan_lanes(o, row_vals(), ri + nan_base, count, r);\n}",
              "  const unsigned long long T6 = stamp();\n"
              "  nan_lanes(o, row_vals(), ri + nan_base, count, r);\n"
              "  __syncthreads();\n"
              "  if (tid == 0 && row == 0) {\n"
              "    const unsigned long long T = stamp();\n"
              "    const unsigned long long t[] = {T0, T1, T2, T3, T4, T5,"
              " T6, T};\n"
              "    for (int i = 0; i < 8; ++i) g_report[1 + i] = t[i];\n"
              "    g_report[9] = levels; g_report[10] = count;\n"
              "    g_report[11] = n2; g_report[12] = above;\n  }\n}")
SEG = [
    ("namespace {\n\nusing bitonic::spad;",
     "__device__ unsigned long long g_seg[64];\n" + TIMER),
    ("  const long long cl = blockIdx.x;\n", None),
    ("  // 1. rank every member's lanes at once",
     "  P[1] = stamp();\n"),
    ("  // 2. walk the members in order", "  P[2] = stamp();\n"),
]
SEG_END = ("        disjoint, tab, hash - 1, &found, warp_n);\n  }\n}",
           "        disjoint, tab, hash - 1, &found, warp_n);\n"
           "    if (s < 4) P[3 + s] = stamp();\n  }\n"
           "  if (tid == 0 && cl == 0)\n"
           "    for (int i = 0; i < 3 + (S < 4 ? S : 4); ++i) g_seg[i] = P[i];"
           "\n}")


def instrument() -> None:
    if os.path.exists(COPY):
        shutil.rmtree(COPY)
    shutil.copytree(os.path.join(ROOT, "src"), os.path.join(COPY, "src"))
    csrc = os.path.join(COPY, "src", "repro_torch", "kernels", "csrc")

    def edit(name, inserts, replaces, symbol):
        path = os.path.join(csrc, name)
        s = open(path).read()
        for anchor, text in inserts:
            if anchor not in s:
                raise SystemExit(f"kernel_phases: {name} lost the anchor "
                                 f"{anchor[:50]!r}")
            if text is None:   # after the anchor: the member stamps
                s = s.replace(anchor, anchor + "  unsigned long long P[8];\n"
                              "  P[0] = stamp();\n", 1)
            else:
                s = s.replace(anchor, text + anchor, 1)
        for old, new in replaces:
            if old not in s:
                raise SystemExit(f"kernel_phases: {name} lost the anchor "
                                 f"{old[:50]!r}")
            s = s.replace(old, new, 1)
        open(path, "w").write(s + READ.replace("STAMPS", symbol)
                              .replace("read_stamps", f"read_{symbol}"))

    edit("report.cu", REPORT, [REPORT_LEVEL, REPORT_END], "g_report")
    edit("segmented_topk.cu", SEG, [SEG_END], "g_seg")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 2
    instrument()
    sys.path.insert(0, os.path.join(COPY, "src"))
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import segmented_topk as ST

    lib = build.library()
    for name in ("read_g_report", "read_g_seg"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    buf = torch.zeros(64, dtype=torch.int64)
    lib.read_g_report(buf.data_ptr())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    names = ("prologue", "compaction", "hand-off", "refine", "gather",
             "sort", "write")
    for n, d, r in ((10, 39_760, 75), (6, 2_515_338, 2500)):
        G = torch.randn((n, d), generator=gen, device=dev)
        if not torch.equal(ops.threshold_topk_batch(G, r).cpu(),
                           ops.threshold_topk_batch(G.cpu(), r)):
            raise AssertionError(f"the stamped report differs at {(n, d)}")
        lib.read_g_report(buf.data_ptr())   # clears the check's stamps
        for _ in range(3):
            ops.threshold_topk_batch(G, r)
            lib.read_g_report(buf.data_ptr())
            t = buf.tolist()
            parts = ", ".join(f"{k} {(t[i + 2] - t[i + 1]) / 1e3:.1f}"
                              for i, k in enumerate(names))
            print(f"report {n}x{d} r={r} (row 0's last block, us): {parts}; "
                  f"row 0 done {(t[8] - t[0]) / 1e3:.1f} us after the first "
                  f"block began; {t[9]} refine levels, {t[10]} pairs "
                  f"sorted, bin b {t[11]} values, {t[12]} above",
                  flush=True)
    for C, S, r, k in ((10, 1, 75, 10), (5, 2, 75, 10), (6, 1, 2500, 100),
                       (3, 2, 2500, 100)):
        cand = torch.stack([torch.randperm(3 * r, generator=gen,
                                           device=dev)[:r]
                            for _ in range(C * S)]).view(C, S, r).int()
        age = torch.randint(0, 4, (C, S, r), generator=gen,
                            device=dev).int()
        valid = torch.ones((C, S), dtype=torch.bool, device=dev)
        if not torch.equal(ST.segmented_age_topk(cand, age, valid, k),
                           ST.segmented_age_topk_plain(cand, age, valid, k)):
            raise AssertionError(f"the stamped selection differs at "
                                 f"{(C, S, r, k)}")
        for _ in range(2):
            ST.segmented_age_topk(cand, age, valid, k)
            lib.read_g_seg(buf.data_ptr())
            t = buf.tolist()
            walk = ", ".join(f"{(t[3 + s] - t[2 + s]) / 1e3:.2f}"
                             for s in range(S))
            print(f"segmented_age_topk C={C} S={S} r={r} k={k} (block 0, "
                  f"us): load {(t[1] - t[0]) / 1e3:.2f}, sort "
                  f"{(t[2] - t[1]) / 1e3:.2f}, members {walk}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
