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
equals the direct count of FLOPs at 4 layers. ``roofline_terms``
is the reference's formula over the H100 constants.

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

import numpy as np
import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

import torch.distributed as dist

from repro.kernels import autotune as JA
from repro.launch import mesh as JM

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels import autotune as A
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import maghist as MH
from repro_torch.kernels import report as RP
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M

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
    """FLOPs of a 4-layer smoke config: the 1- and 2-unit extrapolation
    equals the direct count. (Bytes do not extrapolate: a stacked leaf's
    select backward writes the whole stack once a layer, so they grow
    with the square of the depth.)"""
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
    assert pm["bytes"] <= direct["bytes"]


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
