"""The port's checkpoints (``repro_torch.checkpoint``) and the engine's
resume.

1. ``checkpoint.io``: a tree of dicts, lists, NamedTuples, numpy arrays
   and tensors (bfloat16 included) round-trips exactly; an uncommitted
   entry is invisible; a corrupt npz or meta falls back to the previous
   entry (an explicit step raises); pruning keeps the newest K and
   sweeps ``.tmp`` files; the port reads an entry that the reference's
   ``save_checkpoint`` wrote.
2. ``AsyncCheckpointer``: the snapshot is taken at ``save`` (later writes
   to the state do not reach it), and a worker's error surfaces at the
   next ``save``, ``wait`` or ``close``.
3. Resume within the port, bitwise: a run saved at round 4 through the
   async writer and resumed in a fresh engine equals the uninterrupted
   run (FLResult, every state buffer, the frequency matrix), for rAge-k
   under both layouts and both drivers, rTop-k chunked (the generator
   states) and CAFe hierarchical. The tests marked ``cuda`` resume on the
   card.
"""
import json
import os
from typing import NamedTuple

import numpy as np
import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

try:
    from repro.checkpoint.io import save_checkpoint as j_save
except ImportError:
    j_save = None

from repro_torch.checkpoint import (AsyncCheckpointer, list_checkpoints,
                                    load_checkpoint, prune_checkpoints,
                                    save_checkpoint)
from repro_torch.configs.base import RAgeKConfig
from repro_torch.data.federated import paper_mnist_split
from repro_torch.data.synthetic import mnist_like
from repro_torch.fl import client as TC
from repro_torch.fl.engine import FederatedEngine

# M 3 over 7 rounds: reclusters at 3 and 6, the checkpoint at 4 between
# them; eps 0.8 changes the labels at both (C 10 -> 5 -> 8)
HP = dict(r=30, k=6, H=2, M=3, lr=2e-3, batch_size=16, eps=0.8)
ROUNDS, EVAL_EVERY, CKPT_AT = 7, 2, 4


class Pair(NamedTuple):
    a: object
    b: object


def _tree():
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "nested": {"ids": np.arange(5, dtype=np.int32),
                       "pair": Pair(torch.arange(6).reshape(2, 3),
                                    None)},
            "seq": [torch.randn(4, generator=torch.Generator()
                                .manual_seed(1)).to(torch.bfloat16),
                    torch.tensor(7, dtype=torch.int64)],
            "scalar": np.float32(2.5)}


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            _assert_tree_equal(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif a is None:
        assert b is None
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and b.dtype == a.dtype
        assert torch.equal(a, b)
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- checkpoint.io --------------------------------------------------------

def test_roundtrip_namedtuple_and_bf16(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 3, tree, extra={"note": "x"})
    got, meta = load_checkpoint(str(tmp_path), tree)
    _assert_tree_equal(tree, got)
    assert isinstance(got["nested"]["pair"], Pair)
    assert meta["step"] == 3 and meta["extra"] == {"note": "x"}
    assert meta["keys"]["seq/0"] == "__bf16__"
    with np.load(tmp_path / "ckpt_00000003.npz") as data:
        assert sorted(data.files) == ["nested/ids", "nested/pair/a",
                                      "scalar", "seq/0", "seq/1", "w"]
        assert data["seq/0"].dtype == np.uint16


def test_uncommitted_entry_is_invisible(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 1, tree)
    save_checkpoint(str(tmp_path), 2, tree)
    os.remove(tmp_path / "ckpt_00000002.npz.json")   # crashed before meta
    (tmp_path / "ckpt_00000003.npz.tmp").write_bytes(b"partial")
    assert list_checkpoints(str(tmp_path)) == [1]
    assert load_checkpoint(str(tmp_path), tree)[1]["step"] == 1


@pytest.mark.parametrize("broken", ["npz", "meta"])
def test_corrupt_entry_falls_back(tmp_path, broken):
    tree = _tree()
    save_checkpoint(str(tmp_path), 1, tree)
    later = dict(tree, w=tree["w"] + 1)
    save_checkpoint(str(tmp_path), 2, later)
    fn = tmp_path / ("ckpt_00000002.npz" + (".json" if broken == "meta"
                                             else ""))
    fn.write_bytes(fn.read_bytes()[:len(fn.read_bytes()) // 2])
    got, meta = load_checkpoint(str(tmp_path), tree)
    assert meta["step"] == 1
    _assert_tree_equal(tree, got)
    with pytest.raises(Exception):
        load_checkpoint(str(tmp_path), tree, step=2)


def test_prune_keeps_newest_and_sweeps_tmp(tmp_path):
    tree = {"x": np.arange(3)}
    for step in range(5):
        save_checkpoint(str(tmp_path), step, tree)
    (tmp_path / "ckpt_00000009.npz.tmp").write_bytes(b"")
    prune_checkpoints(str(tmp_path), keep=2)
    assert list_checkpoints(str(tmp_path)) == [3, 4]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "empty"), tree)


@pytest.mark.skipif(j_save is None, reason="needs the JAX reference")
def test_reads_the_reference_entry(tmp_path):
    rng = np.random.default_rng(3)
    tree = {"params": {"w": rng.normal(size=(4, 2)).astype(np.float32),
                       "b": np.zeros(2, np.float32)},
            "steps": [np.int32(4), np.arange(3, dtype=np.int64)]}
    j_save(str(tmp_path), 12, tree, extra={"round_idx": 12})
    got, meta = load_checkpoint(str(tmp_path), tree)
    _assert_tree_equal(tree, got)
    assert meta["extra"] == {"round_idx": 12}
    with open(tmp_path / "ckpt_00000012.npz.json") as f:
        assert json.load(f)["keys"] == meta["keys"]


# -- the async writer -----------------------------------------------------

def test_async_snapshot_is_taken_at_save(tmp_path):
    state = {"t": torch.zeros(4), "a": np.zeros(3, np.int32)}
    with AsyncCheckpointer(str(tmp_path), keep=2) as ck:
        ck.save(1, state, extra={"k": 1})
        state["t"] += 5
        state["a"] += 5
        ck.save(2, state)
        ck.save(3, state)
        ck.wait()
        assert ck.saves == 3 and ck.latest_step() == 3
    assert list_checkpoints(str(tmp_path)) == [2, 3]
    got, meta = load_checkpoint(str(tmp_path), state, step=2)
    assert got["t"].tolist() == [5.0] * 4 and got["a"].tolist() == [5] * 3
    assert ck.load_latest(state)[1]["step"] == 3
    assert AsyncCheckpointer(str(tmp_path / "none")).load_latest(
        state) is None


@pytest.mark.parametrize("blocking", [False, True])
def test_async_worker_error_surfaces(tmp_path, blocking):
    target = tmp_path / "file"
    target.write_text("not a directory")
    ck = AsyncCheckpointer(str(target), blocking=blocking)
    if blocking:
        with pytest.raises(OSError):
            ck.save(1, {"x": np.zeros(2)})
        return
    ck.save(1, {"x": np.zeros(2)})          # fails on the worker
    with pytest.raises(OSError):
        ck.wait()
    ck.save(2, {"x": np.zeros(2)})
    with pytest.raises(OSError):            # joins the failed write 2
        ck.save(3, {"x": np.zeros(2)})
    assert ck.saves == 2
    ck.save(4, {"x": np.zeros(2)})
    with pytest.raises(OSError):
        ck.close()
    ck.close()


# -- resume, bitwise ------------------------------------------------------

@pytest.fixture(scope="module")
def mnist_setup():
    (x, y), test = mnist_like(n_train=1200, n_test=400, seed=0)
    return paper_mnist_split(x, y, seed=0), test


def _make(setup, method, layout, device="cpu"):
    shards, test = setup
    return FederatedEngine(
        "mlp", shards, test,
        RAgeKConfig(**HP, method=method, age_layout=layout), seed=3,
        device=device)


def _state(eng) -> list:
    return [t for t in (eng.g_params, *eng.g_opt_state, *eng.opt_s,
                        *TC.tree_leaves(eng.state_s), *eng.age, *eng.samp,
                        *eng.sched) if t is not None]


@pytest.fixture(scope="module")
def ref_runs(mnist_setup, tmp_path_factory):
    """The uninterrupted chunked run per (method, layout, device), saving
    every CKPT_AT rounds through the async writer."""
    cache = {}

    def get(method, layout, device="cpu"):
        key = (method, layout, device)
        if key not in cache:
            eng = _make(mnist_setup, method, layout, device)
            path = str(tmp_path_factory.mktemp(f"{method}_{layout}"))
            with AsyncCheckpointer(path) as ck:
                res = eng.run_scanned(ROUNDS, eval_every=EVAL_EVERY,
                                      checkpointer=ck, ckpt_every=CKPT_AT)
            eng.close()
            cache[key] = (eng, res, path)
        return cache[key]
    return get


def _resume_and_check(setup, ref, method, layout, driver, device="cpu"):
    eng_ref, res_ref, path = ref
    eng = _make(setup, method, layout, device)
    prior = eng.load_state(path, step=CKPT_AT)
    assert eng.round_idx == CKPT_AT and prior.rounds[-1] == CKPT_AT
    res = getattr(eng, driver)(ROUNDS - CKPT_AT, eval_every=EVAL_EVERY,
                               result=prior)
    for key in ("rounds", "loss", "acc", "uplink_bytes", "n_active",
                "aoi_mean", "aoi_peak", "age_mean", "age_peak"):
        assert getattr(res, key) == getattr(res_ref, key), key
    for a, b in zip(res.requested, res_ref.requested, strict=True):
        assert (a is None and b is None) or np.array_equal(a, b)
    for a, b in zip(res.cluster_labels, res_ref.cluster_labels,
                    strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_state(eng), _state(eng_ref), strict=True):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(eng.freq_matrix, eng_ref.freq_matrix)
    assert eng.cum_bytes == eng_ref.cum_bytes
    assert (eng._num_seg, eng._max_seg) == (eng_ref._num_seg,
                                            eng_ref._max_seg)
    eng.close()
    return eng


@pytest.mark.parametrize("driver", ["run", "run_scanned"])
@pytest.mark.parametrize("layout", ["dense", "hierarchical"])
def test_resume_bitwise_rage_k(mnist_setup, ref_runs, layout, driver):
    ref = ref_runs("rage_k", layout)
    eng = _resume_and_check(mnist_setup, ref, "rage_k", layout, driver)
    if layout == "hierarchical":
        # saved with 5 compacted rows and the ring mid-window
        with np.load(os.path.join(ref[2], "ckpt_00000004.npz")) as data:
            assert data["carry/age/cluster_age"].shape == (5, 39_760)
            assert int(data["carry/age/log_ptr"]) == CKPT_AT
            assert "freq_host" in data.files
        assert eng._log_seen == ROUNDS


@pytest.mark.parametrize("method,layout", [("rtop_k", "dense"),
                                           ("cafe", "hierarchical")])
def test_resume_bitwise_other_methods(mnist_setup, ref_runs, method, layout):
    _resume_and_check(mnist_setup, ref_runs(method, layout), method, layout,
                      "run_scanned")


def test_step_driver_saves_on_the_cadence(mnist_setup, tmp_path):
    """``run`` saves every ``ckpt_every`` rounds, the FLResult so far in
    the meta; a blocking writer writes the same entries."""
    eng = _make(mnist_setup, "rage_k", "hierarchical")
    with AsyncCheckpointer(str(tmp_path), keep=0, blocking=True) as ck:
        res = eng.run(5, eval_every=EVAL_EVERY, checkpointer=ck,
                      ckpt_every=2)
    assert list_checkpoints(str(tmp_path)) == [2, 4]
    _, meta = load_checkpoint(str(tmp_path), eng.state_tree())
    assert meta["extra"]["round_idx"] == 4
    assert meta["extra"]["result"]["rounds"] == [2, 4]
    assert res.rounds == [2, 4, 5]
    eng.close()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "hierarchical"])
def test_card_resume_bitwise(cuda, mnist_setup, ref_runs, layout):
    """On the card: saved from replayed graphs (the generators' states
    after the replays), resumed in a fresh engine whose first chunk
    captures anew."""
    ref = ref_runs("rage_k", layout, "cuda")
    assert ref[0]._graphs
    _resume_and_check(mnist_setup, ref, "rage_k", layout, "run_scanned",
                      "cuda")


@pytest.mark.cuda
def test_card_hierarchical_chunk_equals_dense(cuda, mnist_setup):
    """A hierarchical chunked run on the card equals the dense one, its
    graphs recaptured at each compaction; no N-row age buffer stays."""
    out = {}
    for layout in ("dense", "hierarchical"):
        eng = _make(mnist_setup, "rage_k", layout, cuda)
        res = eng.run_scanned(ROUNDS, eval_every=EVAL_EVERY)
        out[layout] = (eng, res, eng.freq_matrix)
        eng.close()
    (ed, rd, fd), (eh, rh, fh) = out["dense"], out["hierarchical"]
    assert rd.loss == rh.loss
    for a, b in zip(rd.requested, rh.requested, strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(fd, fh)
    rows = eh.age.cluster_age.shape[0]
    assert rows == int(eh.cluster_of.max()) + 1 < 10
    assert all(key[0] == rows for key in eh._graphs)
    assert torch.equal(ed.age.cluster_age[:rows], eh.age.cluster_age)
