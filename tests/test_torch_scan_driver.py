"""The port's chunked driver (``FederatedEngine.run_scanned``) and its
every-M recluster worker.

1. ``run_scanned`` is bitwise ``run`` (losses, accuracies, requested
   indices, uplink, cluster labels, heatmaps and every buffer of the
   engine state) for every method and selection path, across recluster
   boundaries, and for the CNN; the drivers hand over to each other.
2. The port's ``run_scanned`` against the reference's, from the same
   weights and batches over two recluster boundaries that change the
   labels: integers exact, floats within ``test_torch_engine.py``'s
   rtol=1e-5, atol=1e-6.
3. The worker: the labels are joined before they are read, the snapshot
   is taken at the submit, ``close()`` is idempotent and the engine
   stays usable, and a worker failure raises at every later consumer.
4. The kernels' launch tally under graph capture, driven directly on the
   CPU; the tests marked ``cuda`` capture and replay on the card.
"""
import threading
import time

import numpy as np
import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

try:
    import jax
    from repro.configs.base import RAgeKConfig as JCfg
    from repro.fl import client as JC
    from repro.fl.engine import FederatedEngine as JEngine
except ImportError:
    jax = None

from repro_torch.configs.base import RAgeKConfig
from repro_torch.data.federated import paper_cifar_split, paper_mnist_split
from repro_torch.data.synthetic import cifar10_like, mnist_like
from repro_torch.fl import client as TC
from repro_torch.fl import engine as TE
from repro_torch.fl.engine import FederatedEngine
from repro_torch.kernels import build
from repro_torch.kernels import ops
from repro_torch.weights import params_from_jax

# M 3 over 7 rounds: reclusters at rounds 3 and 6; eps 0.8 makes both
# change the labels (label pairs, then other pairs), so the segmented
# packing bounds change twice
HP = dict(r=30, k=6, H=2, M=3, lr=2e-3, batch_size=16)
ROUNDS, EVAL_EVERY = 7, 2
TOL = dict(rtol=1e-5, atol=1e-6)
PATHS = [("rage_k", "segmented", 0.3), ("rage_k", "segmented", 0.8),
         ("rage_k", "scan", 0.8), ("rtop_k", "segmented", 0.3),
         ("cafe", "segmented", 0.3), ("top_k", "segmented", 0.3),
         ("random_k", "segmented", 0.3), ("dense", "segmented", 0.3)]


@pytest.fixture(scope="module")
def mnist_setup():
    (x, y), test = mnist_like(n_train=1200, n_test=400, seed=0)
    return paper_mnist_split(x, y, seed=0), test


def _engine(setup, method="rage_k", selection="segmented", eps=0.8,
            **kw):
    shards, test = setup
    return FederatedEngine("mlp", shards, test,
                           RAgeKConfig(**HP, method=method, eps=eps),
                           seed=3, device="cpu", selection=selection, **kw)


def _state(eng) -> list:
    """Every buffer a round updates, flattened."""
    return [eng.g_params, *eng.g_opt_state, *eng.opt_s,
            *TC.tree_leaves(eng.state_s),
            *[t for t in eng.age if t is not None], *eng.samp, *eng.sched]


def _assert_same(ea, ra, eb, rb):
    assert ra.loss == rb.loss and ra.acc == rb.acc
    assert ra.rounds == rb.rounds and ra.uplink_bytes == rb.uplink_bytes
    for key in ("n_active", "aoi_mean", "aoi_peak", "age_mean", "age_peak"):
        assert getattr(ra, key) == getattr(rb, key), key
    assert len(ra.requested) == len(rb.requested)
    for a, b in zip(ra.requested, rb.requested):
        assert (a is None and b is None) or np.array_equal(a, b)
    for a, b in zip(ra.cluster_labels, rb.cluster_labels, strict=True):
        np.testing.assert_array_equal(a, b)
    assert ra.heatmaps.keys() == rb.heatmaps.keys()
    for t in ra.heatmaps:
        np.testing.assert_array_equal(ra.heatmaps[t], rb.heatmaps[t])
    for a, b in zip(_state(ea), _state(eb), strict=True):
        assert torch.equal(a, b)
    assert (ea._num_seg, ea._max_seg) == (eb._num_seg, eb._max_seg)


@pytest.mark.parametrize("method,selection,eps", PATHS)
def test_run_scanned_equals_run(mnist_setup, method, selection, eps):
    ea = _engine(mnist_setup, method, selection, eps)
    ra = ea.run(ROUNDS, eval_every=EVAL_EVERY, heatmap_at=(ROUNDS,))
    eb = _engine(mnist_setup, method, selection, eps)
    rb = eb.run_scanned(ROUNDS, eval_every=EVAL_EVERY, heatmap_at=(ROUNDS,))
    _assert_same(ea, ra, eb, rb)
    assert eb.round_idx == ROUNDS and rb.rounds == [2, 4, 6, 7]
    if method == "rage_k" and eps == 0.8:
        labels = [l.tolist() for l in rb.cluster_labels]
        assert labels[1] == [0, 0, 1, 1, 2, 2, 3, 3, 4, 4]
        assert labels[2] != labels[1]
        assert eb.recluster_s > 0
    eb.close()


def test_drivers_hand_over(mnist_setup):
    """Three chunked rounds, then four steps into the same result (and the
    reverse) equal seven steps: the drivers share one state."""
    ea = _engine(mnist_setup)
    ra = ea.run(ROUNDS, eval_every=EVAL_EVERY)
    for first, second in (("run_scanned", "run"), ("run", "run_scanned")):
        eb = _engine(mnist_setup)
        rb = getattr(eb, first)(3, eval_every=EVAL_EVERY)
        rb = getattr(eb, second)(ROUNDS - 3, eval_every=EVAL_EVERY,
                                 result=rb)
        assert rb.rounds == [2, 3, 4, 6, 7]
        keep = [i for i, t in enumerate(rb.rounds) if t != 3]
        for key in ("rounds", "loss", "acc", "uplink_bytes"):
            assert [getattr(rb, key)[i] for i in keep] == getattr(ra, key)
        for a, b in zip(ra.requested, rb.requested, strict=True):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(_state(ea), _state(eb), strict=True):
            assert torch.equal(a, b)
        eb.close()


def test_run_scanned_equals_run_cnn():
    """The CNN (its BatchNorm statistics per client in the state) across
    the round-2 and round-4 reclusters."""
    (x, y), test = cifar10_like(n_train=600, n_test=240, seed=0)
    shards = paper_cifar_split(x, y, seed=0)
    hp = RAgeKConfig(r=200, k=20, H=1, M=2, lr=1e-3, batch_size=8)
    ea = FederatedEngine("cnn", shards, test, hp, seed=1, device="cpu")
    ra = ea.run(5, eval_every=5)
    eb = FederatedEngine("cnn", shards, test, hp, seed=1, device="cpu")
    rb = eb.run_scanned(5, eval_every=5)
    _assert_same(ea, ra, eb, rb)
    assert TC.tree_leaves(eb.state_s)
    eb.close()


@pytest.mark.skipif(jax is None, reason="needs the JAX reference")
def test_run_scanned_matches_reference(mnist_setup):
    """The reference's run_scanned and the port's from the reference's
    initial weights, the port fed the reference's per-round batches (its
    sampler draws from the reference's own stream, which the training
    does not touch): over seven rounds whose two reclusters change the
    labels, requested indices, ages, request counts, labels and uplink
    exactly; losses, accuracies and params within TOL."""
    shards, test = mnist_setup
    hp = dict(**HP, eps=0.8)
    jeng = JEngine("mlp", shards, test, JCfg(**hp), seed=3, compute="masked")
    batches, samp = [], jeng.samp
    for _ in range(ROUNDS):
        bx, by, samp = jeng._store.draw(jeng._data, samp, hp["H"])
        batches.append((torch.from_numpy(np.array(bx)),
                        torch.from_numpy(np.array(by)).long()))
    params0 = jax.tree_util.tree_map(np.asarray, jeng.g_params)
    teng = FederatedEngine("mlp", shards, test, RAgeKConfig(**hp), seed=3,
                           device="cpu", params=params_from_jax(params0,
                                                                "cpu"))
    feed = iter(batches)
    teng._store.draw = lambda data, state, H: (*next(feed), state)
    ra = jeng.run_scanned(ROUNDS, eval_every=EVAL_EVERY)
    rb = teng.run_scanned(ROUNDS, eval_every=EVAL_EVERY)
    jeng.close()
    teng.close()
    assert rb.rounds == ra.rounds and rb.uplink_bytes == ra.uplink_bytes
    np.testing.assert_allclose(rb.loss, ra.loss, **TOL)
    np.testing.assert_allclose(rb.acc, ra.acc, **TOL)
    for a, b in zip(rb.requested, ra.requested, strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(rb.cluster_labels, ra.cluster_labels, strict=True):
        np.testing.assert_array_equal(a, b)
    assert rb.cluster_labels[1].tolist() == [0, 0, 1, 1, 2, 2, 3, 3, 4, 4]
    np.testing.assert_array_equal(teng.age.cluster_age.numpy(),
                                  np.asarray(jeng.age.cluster_age))
    np.testing.assert_array_equal(teng.freq_matrix, jeng.freq_matrix)
    np.testing.assert_allclose(teng.g_params.numpy(),
                               np.asarray(JC.flatten_tree(jeng.g_params)),
                               **TOL)


# -- the recluster worker -------------------------------------------------

PAIRS = np.asarray([0, 0, 1, 1, 2, 2, 3, 3, 4, 4])


def _slow_recluster(monkeypatch, seen, gate=None):
    """Replace the host recluster by one that waits for ``gate``, notes the
    request counts it was handed and returns the label pairs."""
    def fake(freq, cluster_age, cluster_of, eps, min_pts):
        if gate is not None:
            assert gate.wait(10)
        seen.append(freq.copy())
        return np.full_like(cluster_age, 7), PAIRS.copy()
    monkeypatch.setattr(TE, "_recluster_host", fake)


def test_worker_joins_before_labels_are_read(mnist_setup, monkeypatch):
    """The labels are joined before they are read, from the snapshot taken
    at the submit: a write to freq after the submit does not reach the
    worker."""
    eng = _engine(mnist_setup)
    eng.run_scanned(2, eval_every=2)
    seen, gate = [], threading.Event()
    _slow_recluster(monkeypatch, seen, gate)
    want = eng.age.freq.numpy().copy()
    eng._recluster_submit()
    eng.age.freq.add_(1000)                  # after the snapshot
    assert eng._recluster_future is not None
    threading.Timer(0.2, gate.set).start()
    t0 = time.perf_counter()
    assert eng.cluster_of.tolist() == PAIRS.tolist()
    assert time.perf_counter() - t0 > 0.1
    assert eng._recluster_future is None
    np.testing.assert_array_equal(seen[0], want)
    assert (eng._num_seg, eng._max_seg) == (5, 2)
    assert (eng.age.cluster_age == 7).all()
    assert eng.recluster_wait_s > 0.1 and eng.recluster_s > 0.1
    assert eng.recluster_hidden_s >= 0.0
    eng.close()


def test_worker_close_is_idempotent_and_engine_reusable(mnist_setup):
    eng = _engine(mnist_setup)
    ref = _engine(mnist_setup)
    eng.run_scanned(3, eval_every=3)      # ends on a recluster: submitted
    assert eng._recluster_pool is not None
    eng.close()
    eng.close()
    assert eng._recluster_pool is None and eng._recluster_future is None
    res = eng.run_scanned(ROUNDS - 3, eval_every=EVAL_EVERY)
    assert eng._recluster_pool is not None          # a new worker
    ref.run(ROUNDS, eval_every=EVAL_EVERY)
    for a, b in zip(_state(ref), _state(eng), strict=True):
        assert torch.equal(a, b)
    assert res.rounds == [4, 6, 7]
    eng.close()
    eng.close()


def test_worker_failure_reraises_at_every_consumer(mnist_setup, monkeypatch):
    eng = _engine(mnist_setup)
    eng.run_scanned(2, eval_every=2)

    def boom(*args):
        raise ValueError("dbscan broke")
    monkeypatch.setattr(TE, "_recluster_host", boom)
    eng._recluster_submit()
    with pytest.raises(ValueError, match="dbscan broke"):
        eng.cluster_of
    for consume in (lambda: eng.cluster_of, lambda: eng.freq_matrix,
                    eng.step, lambda: eng.run_scanned(1)):
        with pytest.raises(RuntimeError, match="stale") as info:
            consume()
        assert isinstance(info.value.__cause__, ValueError)
    with pytest.raises(RuntimeError, match="stale"):
        eng.close()
    assert eng._recluster_pool is None
    with pytest.raises(RuntimeError, match="stale"):
        eng.close()


class _Recorder:
    """A checkpointer that notes the steps it is handed."""

    def __init__(self):
        self.steps = []
        self.crashed = []

    def save(self, step, tree, extra=None):
        self.steps.append((step, extra["round_idx"]))
        self.crashed.append(extra["result"]["n_crashed"])


@pytest.mark.parametrize("driver", ["run", "run_scanned"])
def test_checkpointer_saves_at_its_cadence_under_faults(mnist_setup,
                                                        driver):
    """``checkpointer=`` saves every ``ckpt_every`` rounds; ``ckpt_every``
    alone saves nothing and changes no result; under ``faults=`` the
    saves come at the same rounds and carry the fault counters so far."""
    from repro_torch.fl.faults import FaultModel
    eng = _engine(mnist_setup)
    rec = _Recorder()
    res = getattr(eng, driver)(5, eval_every=EVAL_EVERY, checkpointer=rec,
                               ckpt_every=2)
    assert rec.steps == [(2, 2), (4, 4)] and eng.round_idx == 5
    other = _engine(mnist_setup)
    assert getattr(other, driver)(5, eval_every=EVAL_EVERY,
                                  ckpt_every=2).loss == res.loss
    faulted = _engine(mnist_setup, faults=FaultModel(
        10, p_crash=0.3, p_nan=0.3, seed=1, device="cpu"))
    rec = _Recorder()
    res = getattr(faulted, driver)(5, eval_every=EVAL_EVERY,
                                   checkpointer=rec, ckpt_every=2)
    assert rec.steps == [(2, 2), (4, 4)]
    assert rec.crashed == [res.n_crashed[:2], res.n_crashed[:4]]
    assert sum(res.n_crashed) > 0 and sum(res.n_quarantined) > 0
    for e in (eng, other, faulted):
        e.close()


def test_deterministic_scope(monkeypatch):
    """device.deterministic() turns cuDNN's deterministic algorithms on
    inside and restores the caller's setting, also on an exception."""
    from repro_torch.device import deterministic
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    with deterministic():
        assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.deterministic
    with pytest.raises(KeyError):
        with deterministic():
            raise KeyError
    assert not torch.backends.cudnn.deterministic


# -- the launch tally under capture ---------------------------------------

class _FakeLib:
    """A kernel library whose entries launch nothing and succeed."""

    def __getattr__(self, name):
        return lambda *args: 0


def test_launch_tally_bookkeeping(monkeypatch):
    """While the stream is captured a launch counts into the open tally
    (or raises without one) and not into LAUNCHES; each replay adds the
    tally."""
    monkeypatch.setattr(build, "library", lambda: _FakeLib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: type("S", (), {"cuda_stream": 0})())
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    build.reset_launches()
    build.call("sparse_aggregate")
    assert build.LAUNCHES["sparse_aggregate"] == 1
    capturing[0] = True
    with pytest.raises(RuntimeError, match="capturing"):
        build.call("sparse_aggregate")
    with build.capturing() as tally:
        build.call("sparse_aggregate")
        build.call("maghist_batch")
        build.call("maghist_batch")
        with pytest.raises(RuntimeError, match="already open"):
            with build.capturing():
                pass
    capturing[0] = False
    assert tally == {**{k: 0 for k in build.LAUNCHES},
                     "sparse_aggregate": 1, "maghist_batch": 2}
    assert build.LAUNCHES["sparse_aggregate"] == 1
    assert build.LAUNCHES["maghist_batch"] == 0
    for _ in range(3):
        build.replayed(tally)
    assert build.LAUNCHES["sparse_aggregate"] == 4
    assert build.LAUNCHES["maghist_batch"] == 6
    build.reset_launches()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_launch_tally_under_capture(cuda):
    """``sparse_aggregate`` captured into a graph: nothing is counted at
    capture, each replay counts one launch, and the replays compute what
    the kernel computes eagerly."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    d = 39_760
    idx = torch.randint(0, d, (100,), generator=gen, device=cuda).int()
    vals = torch.randn(100, generator=gen, device=cuda)
    age = torch.randint(0, 9, (d,), generator=gen, device=cuda).int()
    want = ops.sparse_aggregate(idx, vals, age)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ops.sparse_aggregate(idx, vals, age)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    build.reset_launches()
    with build.capturing() as tally, torch.cuda.graph(graph, stream=stream):
        got = ops.sparse_aggregate(idx, vals, age)
    assert build.LAUNCHES["sparse_aggregate"] == 0
    assert tally["sparse_aggregate"] == 1
    for _ in range(3):
        graph.replay()
        build.replayed(tally)
    torch.cuda.synchronize()
    assert build.LAUNCHES["sparse_aggregate"] == 3
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_card_run_scanned_replays_graphs(cuda, mnist_setup):
    """On the card run_scanned replays graphs and equals run bitwise, with
    the same kernel launches counted, across the label changes."""
    shards, test = mnist_setup
    hp = RAgeKConfig(**HP, eps=0.8)
    out = []
    for driver in ("run", "run_scanned"):
        eng = FederatedEngine("mlp", shards, test, hp, seed=3, device=cuda)
        build.reset_launches()
        res = getattr(eng, driver)(ROUNDS, eval_every=EVAL_EVERY)
        out.append((eng, res, dict(build.LAUNCHES)))
    (ea, ra, la), (eb, rb, lb) = out
    assert eb._graphs and not ea._graphs
    assert la == lb and lb["segmented_age_topk"] == ROUNDS
    _assert_same(ea, ra, eb, rb)
    eb.close()


@pytest.mark.cuda
@pytest.mark.parametrize("hp,kw", [
    ({"schedule": "uniform", "participation_m": 2}, {}),
    ({"schedule": "aoi", "participation_m": 3}, {"ef": True}),
    ({"schedule": "deadline"}, {}),
    ({"schedule": "uniform", "participation_m": 4, "method": "rtop_k"}, {})])
def test_card_partial_run_scanned_equals_run(cuda, mnist_setup, hp, kw):
    """The participation and compute planes on the card: a partial run
    (gathered under uniform and aoi, masked under deadline) replayed as
    graphs equals the stepped run bitwise, every round launching its
    method's kernels once each, on the m gathered rows."""
    shards, test = mnist_setup
    cfg = RAgeKConfig(**{**HP, "eps": 0.8, **hp})
    out = []
    for driver in ("run", "run_scanned"):
        eng = FederatedEngine("mlp", shards, test, cfg, seed=3, device=cuda,
                              **kw)
        build.reset_launches()
        res = getattr(eng, driver)(ROUNDS, eval_every=EVAL_EVERY)
        out.append((eng, res, dict(build.LAUNCHES)))
    (ea, ra, la), (eb, rb, lb) = out
    assert eb._graphs and la == lb
    assert la["sparse_aggregate"] == la["maghist_batch"] == ROUNDS
    assert ea._compute == ("masked" if hp["schedule"] == "deadline"
                           else "gathered")
    _assert_same(ea, ra, eb, rb)
    if kw.get("ef"):
        assert torch.equal(ea.ef_mem, eb.ef_mem)
    eb.close()


@pytest.mark.cuda
def test_card_faulted_run_scanned_equals_run(cuda, mnist_setup):
    """Faulted rounds replayed as graphs on the card equal the stepped
    rounds bitwise, counters included, with the unfaulted round's
    kernel launches."""
    from repro_torch.fl.faults import FaultModel
    shards, test = mnist_setup
    hp = RAgeKConfig(**HP, eps=0.8)
    out = []
    for driver in ("run", "run_scanned"):
        eng = FederatedEngine("mlp", shards, test, hp, seed=3, device=cuda,
                              faults=FaultModel(10, p_nan=0.2, p_crash=0.1,
                                                p_drop=0.1, seed=9,
                                                device=cuda))
        build.reset_launches()
        res = getattr(eng, driver)(ROUNDS, eval_every=EVAL_EVERY)
        out.append((eng, res, dict(build.LAUNCHES)))
    (ea, ra, la), (eb, rb, lb) = out
    assert eb._graphs and la == lb and lb["segmented_age_topk"] == ROUNDS
    _assert_same(ea, ra, eb, rb)
    assert ra.n_quarantined == rb.n_quarantined and sum(ra.n_quarantined)
    assert ra.n_crashed == rb.n_crashed and ra.n_dropped == rb.n_dropped
    eb.close()


@pytest.mark.cuda
@pytest.mark.parametrize("solicit", ["report", "dispatch"])
def test_card_service_replays_equal_eager_events(cuda, mnist_setup, solicit):
    """On the card each service event is a CUDA graph replay, bitwise the
    eager event; a report-mode event launches the report's two kernels, a
    dispatch-mode event none."""
    from repro_torch.fl.latency import LatencyModel
    from repro_torch.fl.service import AsyncService
    shards, test = mnist_setup
    hp = RAgeKConfig(**HP, buffer_k=4, version_window=4)

    def make():
        return AsyncService("mlp", shards, test, hp, seed=0, device=cuda,
                            solicit=solicit,
                            latency=LatencyModel(10, hetero=1.0, device=cuda))
    a, b = make(), make()
    build.reset_launches()
    ma = a._advance(12)
    assert build.LAUNCHES["threshold_topk_batch"] == (
        12 if solicit == "report" else 0)
    mb = b._advance(12, eager=True)
    assert a._graphs and not b._graphs
    for key in ma:
        np.testing.assert_array_equal(ma[key], mb[key])
    for name in a.state._fields:
        xs, ys = getattr(a.state, name), getattr(b.state, name)
        for x, y in zip(*(_tensors(t) for t in (xs, ys))):
            assert torch.equal(x, y), name


def _tensors(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    return [t for x in tree for t in _tensors(x)]
