"""The port's dry run (``repro_torch.launch.dryrun``) and its autotune
registry (``repro_torch.kernels.autotune``), on the CPU.

The dry run traces ``launch.steps.lower_combo``'s step on DTensors of fake
shards over a fake process group. As the reference's
``tests/test_dryrun_small.py`` lowers and compiles its 6 archs x 3 kinds
at smoke configs on a one-device mesh, the port's steps run at those
configs (one layer) on a (1, 1) and a fake (2, 2) mesh and count FLOPs
above 0. The counter reads local shards: a column-parallel product on a
(1, 2) mesh counts half the whole product's FLOPs, and the output bytes
of a known redistribution's collective. The 1- and 2-unit extrapolation
equals the direct count of FLOPs and bytes at 4 layers. ``roofline_terms``
is the reference's formula over the H100 constants. deepseek-v2-236b's
MLA decode traces on a mesh whose pod and data axes make its context a
partial sum. The training step's memory a device grows from 1 to 2
full-width layers by no more than the reference's growth (its compiled
step's memory analysis, in one subprocess for the module) plus a stated
slack, and where the heads do not divide the model axis it stays within
a stated ratio of the reference's.

Each test leaves no process group behind (``fake_group`` destroys it):
the fake group is process-wide state in an xdist worker.

The registry's cases are the reference's ``tests/test_autotune.py``:
``key_of`` equals the reference's for the same arguments; the JSON round
trip, the nearest-shape fallback and misses, a corrupt file read as
empty, the sweep's winner; and the launchers consult it: the report's
chunk (``maghist.launch_chunk``, bitwise the same report through the
plain twin of its kernels' steps at the tuned chunk) and
``decode_attention``'s cut (``launch_cut``, exact shapes only; the split
twin within 1e-5 of the plain attention at the tuned split count).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

import torch.distributed as dist

from repro.kernels import autotune as JA
from repro.launch import mesh as JM

from repro_torch.configs import INPUT_SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels import autotune as A
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import maghist as MH
from repro_torch.kernels import report as RP
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch.steps import lower_combo

ARCHS = ["internlm2-1.8b", "granite-moe-3b-a800m", "mamba2-780m",
         "zamba2-2.7b", "whisper-large-v3", "deepseek-v2-236b"]
SHAPES = {"train": InputShape("t", 32, 4, "train"),
          "prefill": InputShape("p", 32, 4, "prefill"),
          "decode": InputShape("d", 32, 4, "decode")}


def _one_unit(arch):
    cfg = get_smoke_config(arch)
    u = cfg.attn_every if cfg.family == "hybrid" else 1
    kw = dict(n_layers=u)
    if cfg.is_encoder_decoder:
        kw["encoder_layers"] = 1
    return cfg.replace(**kw)


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_trace_small(arch, kind):
    cfg = _one_unit(arch)
    one = D.host_mesh_trace(cfg, SHAPES[kind], 1, 1)
    four = D.host_mesh_trace(cfg, SHAPES[kind], 2, 2)
    assert one["kind"] == four["kind"] == kind
    assert one["flops"] > 0 and four["flops"] > 0
    assert four["flops"] < one["flops"]
    assert not dist.is_initialized()


def test_counter_reads_local_shards():
    """A column-parallel product on a (1, 2) mesh: half the FLOPs per
    device; gathering its output is an all-gather of the whole output."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with D.fake_group(2):
        dm = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data",
                                                             "model"))
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(64, 2048), dm,
                                   [Replicate(), Replicate()],
                                   run_check=False)
            w = DTensor.from_local(torch.empty(2048, 4096), dm,
                                   [Replicate(), Shard(1)], run_check=False)
            counter = D._counter_class()()
            with counter:
                y = x @ w
                y.redistribute(dm, [Replicate(), Replicate()])
    assert counter.flops == 2 * 64 * 2048 * 8192 // 2
    assert counter.coll["all-gather"] == 64 * 8192 * 4
    assert sum(counter.coll.values()) == 64 * 8192 * 4
    assert not dist.is_initialized()


def test_extrapolation_is_exact():
    """FLOPs and bytes of a 4-layer smoke config: the 1- and 2-unit
    extrapolation equals the direct count (each stacked leaf is unbound
    once a step, so its gradient's slices are written once, not a zero
    stack a layer)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import sharding as SH
    from repro_torch.launch.steps import lower_combo

    cfg = get_smoke_config("internlm2-1.8b").replace(n_layers=4)
    shape = SHAPES["train"]
    with D.fake_group(1):
        mesh = SH.from_device_mesh(init_device_mesh(
            "cpu", (1, 1), mesh_dim_names=("data", "model")))
        pm = D.probe_roofline(cfg, shape, mesh)
        direct = D.trace(lower_combo(cfg, shape, mesh)[0], memory=False)
    assert pm["flops"] == direct["flops"]
    assert pm["bytes"] == direct["bytes"]


def test_roofline_terms_are_the_reference_formula():
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as JD
    finally:                 # its import sets 512 host devices for later jax
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    f, b, c = 3.2e15, 7.1e11, 2.5e10
    want = JD.roofline_terms(f, b, c)
    got = D.roofline_terms(f, b, c)
    np.testing.assert_allclose(
        [got["compute_s"], got["memory_s"], got["collective_s"]],
        [want["compute_s"] * JM.PEAK_FLOPS_BF16 / M.PEAK_FLOPS_BF16,
         want["memory_s"] * JM.HBM_BW / M.HBM_BW,
         want["collective_s"] * JM.ICI_BW / M.NVLINK_BW], rtol=1e-12)
    assert (M.PEAK_FLOPS_BF16, M.HBM_BW, M.NVLINK_BW) == (989.4e12, 3.35e12,
                                                         450e9)
    assert D.SKIPS == JD.SKIPS


def test_skipped_combination_record(tmp_path):
    rec = D.run_combo("whisper-large-v3", "long_500k", multi_pod=False,
                      out_dir=str(tmp_path), verbose=False)
    assert rec["status"] == "skip"
    on_disk = json.load(open(tmp_path / "whisper-large-v3_long_500k_16x16.json"))
    assert on_disk == rec


def test_mla_decode_on_a_pod_mesh():
    """deepseek-v2-236b's smoke decode step on a fake (pod 2, data 4,
    model 2) mesh: the absorbed decode's context (B, H, hd), a partial
    sum over pod and data with its heads over model, meets ``wo`` through
    ``regions.merge_heads`` (its reshape to (B, 1, H x hd) left a strided
    shard that DTensor could not redistribute)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import sharding as SH

    cfg = get_smoke_config("deepseek-v2-236b").replace(n_layers=1)
    with D.fake_group(16):
        mesh = SH.from_device_mesh(init_device_mesh(
            "cpu", (2, 4, 2), mesh_dim_names=("pod", "data", "model")))
        lowered, kind = lower_combo(cfg, SHAPES["decode"], mesh)
        rec = D.trace(lowered, memory=False)
    assert kind == "decode" and rec["flops"] > 0
    assert not dist.is_initialized()


# The training step's memory a device against the reference's. Fault 10,
# the smallest full-width config whose growth a layer showed it: each
# microbatch's float32 gradient sum was made at the parameters' global
# shape on every device (0.43 GiB a layer here, 5.2 for qwen1.5-110b).
GROWTH_ARCH, GROWTH_SHAPE = "internlm2-1.8b", "train_4k"
GROWTH_SLACK_MIB = 560
# Fault 13, the smallest full-width config whose heads the 16-wide model
# axis does not divide (8): there the attention runs whole on every model
# shard, and the flash attention kept each KV chunk's float32 scores and
# weights for its backward (9.0070 GiB a device at one layer).
HEADS_ARCH, HEADS_RATIO = "gemma-2b", 1.5

_REF_MEMORY = """
import json, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=256 "
                           + os.environ.get("XLA_FLAGS", ""))
from repro.configs import INPUT_SHAPES, get_config
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import lower_combo
mesh = make_production_mesh(multi_pod=False)
out = {}
for arg in sys.argv[2:]:
    arch, layers = arg.split(":")
    for n in map(int, layers.split(",")):
        cfg = get_config(arch).replace(n_layers=n)
        ma = lower_combo(cfg, INPUT_SHAPES[sys.argv[1]], mesh)[0].compile(
            ).memory_analysis()
        out.setdefault(arch, []).append(
            ma.argument_size_in_bytes + ma.temp_size_in_bytes
            + ma.output_size_in_bytes - ma.alias_size_in_bytes)
print(json.dumps(out))
"""


class _Reference:
    """The reference's memory a device (XLA's memory analysis of its
    compiled step, on 256 forced host devices, as ``repro.launch.dryrun``
    compiles it) of each arch at the layer counts asked, in one
    subprocess that runs beside the port's traces."""

    def __init__(self, shape, wanted):
        src = os.path.join(os.path.dirname(__file__), "..", "src")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join(
                       p for p in (src, os.environ.get("PYTHONPATH")) if p))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _REF_MEMORY, shape, *wanted], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._out = None

    def get(self) -> dict:
        if self._out is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, err[-3000:]
            self._out = json.loads(out.strip().splitlines()[-1])
        return self._out


@pytest.fixture(scope="module")
def reference_memory():
    ref = _Reference(GROWTH_SHAPE, [f"{GROWTH_ARCH}:1,2", f"{HEADS_ARCH}:1"])
    yield ref
    if ref.proc.poll() is None:
        ref.proc.kill()
        ref.proc.communicate()


def _port_memory(arch, layers):
    """The dry run's memory a device of ``arch`` at full width cut to
    ``layers`` layers x ``GROWTH_SHAPE`` x 16x16."""
    cfg = get_config(arch).replace(n_layers=layers)
    with D.fake_group(256):
        mesh = M.make_production_mesh(multi_pod=False)
        lowered, _ = lower_combo(cfg, INPUT_SHAPES[GROWTH_SHAPE], mesh)
        return D.trace(lowered)["memory"]["per_device_total"]


def test_training_memory_grows_as_the_reference(reference_memory):
    """internlm2-1.8b at full width x train_4k x 16x16: the dry run's
    memory a device grows from 1 to 2 layers by at most the reference's
    growth plus ``GROWTH_SLACK_MIB``. The reference's 1-layer step holds
    more than its 2-layer one (2.7547 and 2.5273 GiB); the port's 1.1123
    and 1.3104 GiB (1.8745 and 2.0737 while the flash attention kept its
    chunks' scores and the cross entropy its chunks' logits, 2.81 and 3.24
    before the gradient sum took its parameter's placements)."""
    port = [_port_memory(GROWTH_ARCH, n) for n in (1, 2)]
    want = reference_memory.get()[GROWTH_ARCH]
    grow, ref_grow = port[1] - port[0], want[1] - want[0]
    assert grow <= ref_grow + GROWTH_SLACK_MIB * 2 ** 20, (port, want)
    assert not dist.is_initialized()


def test_training_memory_where_heads_do_not_divide_the_model_axis(
        reference_memory):
    """gemma-2b (8 heads) at one full-width layer x train_4k x 16x16: the
    dry run's memory a device at most ``HEADS_RATIO`` times the
    reference's (3.8932 GiB). The port's 1.5133 GiB, 9.0070 while the
    flash attention kept each KV chunk's float32 scores and weights."""
    port = _port_memory(HEADS_ARCH, 1)
    want = reference_memory.get()[HEADS_ARCH][0]
    assert port <= HEADS_RATIO * want, (port, want)
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the autotune registry
# ---------------------------------------------------------------------------


@pytest.fixture
def tmp_registry(tmp_path):
    p = str(tmp_path / "AUTOTUNE.json")
    A.set_path(p)
    A.reset_stats()
    yield p
    A.set_path(None)


def test_key_of_matches_reference():
    for args in (("maghist_batch", (1, 25_165_824), "float32",
                  "cuda:sm_90a"), ("decode_attention", (64, 160, 128, 2),
                                   "bfloat16", "cpu")):
        assert A.key_of(*args) == JA.key_of(*args)


def test_record_load_lookup_roundtrip(tmp_registry):
    A.record("maghist_batch", (1, 39760), "float32", "cuda:sm_90a",
             {"parts": 8}, 12.5)
    A.clear_cache()
    assert A.lookup("maghist_batch", (1, 39760), "float32",
                    "cuda:sm_90a") == {"parts": 8}
    on_disk = json.load(open(tmp_registry))
    key = "maghist_batch|1x39760|float32|cuda:sm_90a"
    assert on_disk[key]["us"] == 12.5 and on_disk[key]["shape"] == [1, 39760]


def test_nearest_shape_fallback_and_miss(tmp_registry):
    A.record("maghist_batch", (8, 39760), "float32", "cuda:sm_90a",
             {"parts": 16}, 3.0)
    assert A.lookup("maghist_batch", (64, 39760), "float32",
                    "cuda:sm_90a") == {"parts": 16}
    assert A.lookup("maghist_batch", (64, 39760), "float32", "cuda:sm_90a",
                    nearest=False) is None
    assert A.lookup("maghist_batch", (8, 39760), "float32", "cpu") is None
    assert A.lookup("decode_attention", (8, 39760), "float32",
                    "cuda:sm_90a") is None
    s = A.stats()
    assert s["hits"] >= 1 and s["misses"] >= 3


def test_corrupt_registry_is_empty_not_fatal(tmp_registry):
    with open(tmp_registry, "w") as f:
        f.write("{not json")
    A.clear_cache()
    assert A.lookup("x", (1,), "float32", "cpu") is None
    A.record("x", (1,), "float32", "cpu", {"a": 1}, 1.0)
    assert A.lookup("x", (1,), "float32", "cpu") == {"a": 1}


def test_sweep_records_best(tmp_registry):
    times = {64: 9.0, 32: 4.0, 16: 6.0}
    best, results = A.sweep("maghist_batch", (1, 1000), "float32",
                            "cuda:sm_90a", [{"parts": p} for p in times],
                            lambda parts: times[parts])
    assert best == {"parts": 32}
    assert [r["us"] for r in results] == [9.0, 4.0, 6.0]
    A.clear_cache()
    assert A.lookup("maghist_batch", (1, 1000), "float32",
                    "cuda:sm_90a") == {"parts": 32}


def test_report_chunk_consults_registry_and_stays_exact(tmp_registry):
    """A tuned blocks-a-row changes the report's chunk, never its picks."""
    G = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 50_000)).astype(np.float32))
    base = MH.launch_chunk(3, 50_000)
    assert base == MH.chunk_for(50_000)
    A.record("maghist_batch", (3, 50_000), "float32", "cuda:sm_90a",
             {"parts": 4}, 1.0)
    A.reset_stats()
    tuned = MH.launch_chunk(3, 50_000)
    assert A.stats()["hits"] == 1
    assert tuned == 4096 * 4 and tuned > base
    assert MH.launch_chunk(3, 50_000) == tuned      # memoized
    want = RP.threshold_topk_batch_plain(G, 300)
    got = RP.threshold_topk_batch_steps(G, 300, chunk=tuned)
    assert torch.equal(got, want)
    A.record("maghist_batch", (3, 50_000), "float32", "cuda:sm_90a",
             {"parts": 999}, 1.0)
    assert MH.launch_chunk(3, 50_000) == base       # out of range: the rule


def test_decode_cut_consults_registry_exact_only(tmp_registry):
    blocks, n, D, rep = 16, 4096, 128, 4
    rule = DA.choose_splits(blocks, n, D, 2, 132, rep)
    assert DA.launch_cut(blocks, n, D, 2, 132, rep) == rule
    A.record("decode_attention", (blocks, n, D, rep), "bfloat16",
             "cuda:sm_90a", {"tile_bytes": DA.SMALL_TILE, "splits": 3}, 1.0)
    tile, splits, chunk = DA.launch_cut(blocks, n, D, 2, 132, rep)
    assert tile == DA.SMALL_TILE and splits == 3
    assert chunk == DA.split_chunk(n, 3, DA.tile_positions(D, 2))
    # another position count takes the rule
    assert DA.launch_cut(blocks, n + 64, D, 2, 132, rep) == \
        DA.choose_splits(blocks, n + 64, D, 2, 132, rep)
    g = torch.Generator().manual_seed(1)
    q = torch.randn((2, 8, D), generator=g)
    k = torch.randn((2, 300, 2, D), generator=g)
    v = torch.randn((2, 300, 2, D), generator=g)
    torch.testing.assert_close(
        DA.decode_attention_split_plain(q, k, v, 300, splits),
        DA.decode_attention_plain(q, k, v, 300), rtol=1e-5, atol=1e-5)


def test_committed_registry_loads():
    """The repo ships the registry of a sweep on the card beside the
    module, and it parses with an entry of each consulted kernel, every
    time in microseconds from the card."""
    A.set_path(None)
    p = A.path()
    assert p.endswith(os.path.join("repro_torch", "kernels", "AUTOTUNE.json"))
    assert os.path.exists(p), f"missing committed registry {p}"
    reg = A.load(refresh=True)
    assert any(k.startswith("maghist_batch|") for k in reg)
    assert any(k.startswith("decode_attention|") for k in reg)
    assert all(k.endswith("|cuda:sm_90a") and v["us"] > 0
               for k, v in reg.items())
