"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process
per source, all started together) and linked into one shared library
with a plain C interface, loaded through ``ctypes``. The library lands
in ``build/kernels/`` at the repository root under a name keyed by a
hash of the sources and flags, so an edited source never loads a stale
build. Nothing is built when this module is imported: the first kernel
launch builds.

Each C entry takes its pointers and the stream as ``void*``, launches on
that stream and returns ``cudaGetLastError()``; :func:`call` raises if
it is not 0. ``LAUNCHES`` counts each kernel's launches (a plain
integer per kernel, bumped only where the kernel is launched).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

SMEM_LIMIT = 232_448   # an H100 block's shared memory (opt-in), bytes

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> argument types (every pointer and the stream are void*)
SIGNATURES = {
    "decode_attention": [P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, F, P],
    "maghist": [P, P, I, I, P],
    "maghist_batch": [P, P, P, P, I, I, I, P],
    "segmented_age_topk": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                           P],
    "sparse_aggregate": [P, P, P, P, P, I, I, P],
    "threshold_topk_batch": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                             P],
}
LAUNCHES = {name: 0 for name in SIGNATURES}

_lib = None
build_log = ""


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless a build of
    the same sources and flags exists; returns its path."""
    global build_log
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode() + src.read_bytes())
    lib = BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in sources]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(sources, objs)]
    logs = []
    for s, p in zip(sources, procs):
        out, _ = p.communicate()
        done = time.perf_counter() - t0
        logs.append(f"== {s.name} (finished by {done:.1f} s)\n{out}")
        if p.returncode != 0:
            build_log = "\n".join(logs)
            raise RuntimeError(f"nvcc failed on {s.name}:\n{out}")
    tmp = BUILD_DIR / f"{lib.name}.{tag}.tmp"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    build_log = "\n".join(logs)
    return lib


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def call(name: str, *args):
    """Launch C entry ``name`` on the current stream; raise on a CUDA error
    and count the launch."""
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} ({err})")
    LAUNCHES[name] += 1


def require_cuda(name: str, *tensors: torch.Tensor):
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, "
                             f"got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
