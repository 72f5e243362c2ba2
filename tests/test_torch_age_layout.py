"""The port's hierarchical age layout (``age_layout='hierarchical'``).

1. ``fold_request_log`` and ``clustering_input_bytes`` against the
   reference's, sentinels included, on a grid of arguments.
2. ``DeviceAgeState.create_hierarchical`` and ``age_state_from_jax`` on
   both layouts, a compacted mid-run state of the reference's included.
3. The port's hierarchical rAge-k against the reference's hierarchical
   ``run_scanned`` from the same weights and batches over two
   label-changing reclusters: requested indices, labels, the compacted
   ``cluster_age``, the log ring, ``log_ptr`` and the frequency matrix
   exactly; losses and accuracies within ``TOL``. One CAFe round
   (``cost``, ``upload_cost``) likewise.
4. The port's hierarchical runs are bitwise its dense runs for the six
   methods under both drivers, the sequential selection plane, a
   cluster count that shrinks and then grows, a cluster silent for a
   whole window under uniform m, and rounds with no participant.
"""
import numpy as np
import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

try:
    import jax
    from repro.configs.base import RAgeKConfig as JCfg
    from repro.core.clustering import fold_request_log as j_fold
    from repro.core.compression import clustering_input_bytes as j_bytes
    from repro.fl import client as JC
    from repro.fl.engine import DeviceAgeState as JAge
    from repro.fl.engine import FederatedEngine as JEngine
    from repro.fl.engine import _recluster_host as j_recluster_host
except ImportError:
    jax = None

from repro_torch.configs.base import RAgeKConfig
from repro_torch.core.clustering import fold_request_log
from repro_torch.core.compression import clustering_input_bytes
from repro_torch.data.federated import paper_mnist_split
from repro_torch.data.synthetic import mnist_like
from repro_torch.fl.engine import DeviceAgeState, FederatedEngine
from repro_torch.weights import age_state_from_jax, params_from_jax

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX reference")

# test_torch_scan_driver.py's setting: M 3 over 7 rounds, reclusters at 3
# and 6; eps 0.8 takes C from 10 to 5 (label pairs) and then to 8
HP = dict(r=30, k=6, H=2, M=3, lr=2e-3, batch_size=16, eps=0.8)
ROUNDS, EVAL_EVERY = 7, 2
TOL = dict(rtol=1e-5, atol=1e-6)
METHODS = ("rage_k", "rtop_k", "cafe", "top_k", "random_k", "dense")


@pytest.fixture(scope="module")
def mnist_setup():
    (x, y), test = mnist_like(n_train=1200, n_test=400, seed=0)
    return paper_mnist_split(x, y, seed=0), test


# -- host helpers against the reference -----------------------------------

@needs_jax
@pytest.mark.parametrize("n,d,m,k,T", [(6, 50, 4, 3, 5), (1, 7, 1, 1, 1),
                                       (10, 39_760, 10, 6, 3),
                                       (8, 20, 2, 5, 2)])
def test_fold_request_log_matches_reference(n, d, m, k, T):
    rng = np.random.default_rng(n * 1000 + d)
    # sentinel member id n and sentinel index d both appear
    mem = rng.integers(0, n + 1, size=(T, m)).astype(np.int32)
    idx = rng.integers(0, d + 1, size=(T, m, k)).astype(np.int32)
    base = rng.integers(0, 5, size=(n, d)).astype(np.int32)
    got = fold_request_log(base.copy(), mem, idx, n_clients=n, d=d)
    want = j_fold(base.copy(), mem, idx, n_clients=n, d=d)
    np.testing.assert_array_equal(got, want)
    want_loop = base.copy()
    for t in range(T):
        for j in range(m):
            if mem[t, j] < n:
                for c in idx[t, j]:
                    if c < d:
                        want_loop[mem[t, j], c] += 1
    np.testing.assert_array_equal(got, want_loop)


def _outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return ("ValueError", str(e))


@needs_jax
@pytest.mark.parametrize("kw", [
    {}, {"layout": "hierarchical"}, {"layout": "hierarchical", "k": 10,
                                     "M": 20},
    {"layout": "hierarchical", "k": 4, "M": 3, "m_active": 32},
    {"layout": "hierarchical", "k": 100, "M": 10, "m_active": 0},
    {"layout": "hierarchical", "M": 0}, {"layout": "hierarchical", "k": -1},
    {"layout": "hierarchical", "m_active": 11}, {"layout": "tree"},
    {"layout": "dense", "k": 5, "M": 9, "m_active": 3}])
def test_clustering_input_bytes_matches_reference(kw):
    for d, n in ((39_760, 10), (2_515_338, 6), (39_760, 1024)):
        got = _outcome(clustering_input_bytes, d, n, **kw)
        assert got == _outcome(j_bytes, d, n, **kw)


def test_create_hierarchical_layout():
    st = DeviceAgeState.create_hierarchical(10, 4, log_len=3, m_bound=2,
                                            k=2, device="cpu")
    assert st.freq is None and st.cost is None
    assert st.cluster_age.shape == (4, 10)
    assert st.upload_cost.shape == (4,)
    assert st.log_idx.shape == (3, 2, 2) and st.log_mem.shape == (3, 2)
    assert st.log_ptr.shape == () and int(st.log_ptr) == 0
    assert all(t.dtype == torch.int32 for t in st if t is not None)
    # a fresh ring holds sentinels only: it folds to nothing
    assert int(st.log_idx.min()) == 10 and int(st.log_mem.min()) == 4
    dense = DeviceAgeState.create(10, 4, "cpu")
    assert st.device_bytes < dense.device_bytes == 2 * 4 * 10 * 4 + 4 * 4
    cafe = DeviceAgeState.create_hierarchical(10, 4, with_cost=True,
                                              device="cpu")
    assert cafe.cost.shape == (4, 10) and cafe.log_idx is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DeviceAgeState.create_hierarchical(10, 4)


# -- against the reference's hierarchical engine ---------------------------

def _fed(teng, batches):
    """Hand the port's engine the reference's batches, one round each."""
    feed = iter(batches)
    teng._store.draw = lambda data, state, H: (*next(feed), state)


@pytest.fixture(scope="module")
def ref_hier(mnist_setup):
    """The reference's hierarchical rAge-k through ``run_scanned``, its
    initial weights and per-round batches, and the port's run from them.
    Returns (jeng, jres, teng, tres, params0, batches)."""
    if jax is None:
        pytest.skip("needs the JAX reference")
    shards, test = mnist_setup
    hp = dict(**HP, age_layout="hierarchical")
    jeng = JEngine("mlp", shards, test, JCfg(**hp), seed=3,
                   compute="masked")
    batches, samp = [], jeng.samp
    for _ in range(ROUNDS + 1):
        bx, by, samp = jeng._store.draw(jeng._data, samp, hp["H"])
        batches.append((torch.from_numpy(np.array(bx)),
                        torch.from_numpy(np.array(by)).long()))
    params0 = jax.tree_util.tree_map(np.asarray, jeng.g_params)
    teng = FederatedEngine("mlp", shards, test, RAgeKConfig(**hp), seed=3,
                           device="cpu",
                           params=params_from_jax(params0, "cpu"))
    _fed(teng, batches)
    jres = jeng.run_scanned(ROUNDS, eval_every=EVAL_EVERY)
    tres = teng.run_scanned(ROUNDS, eval_every=EVAL_EVERY)
    yield jeng, jres, teng, tres, params0, batches
    jeng.close()
    teng.close()


def test_hierarchical_matches_reference(ref_hier):
    jeng, ra, teng, rb, _, _ = ref_hier
    assert rb.rounds == ra.rounds and rb.uplink_bytes == ra.uplink_bytes
    np.testing.assert_allclose(rb.loss, ra.loss, **TOL)
    np.testing.assert_allclose(rb.acc, ra.acc, **TOL)
    for a, b in zip(rb.requested, ra.requested, strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(rb.cluster_labels, ra.cluster_labels, strict=True):
        np.testing.assert_array_equal(a, b)
    labels = [c.tolist() for c in rb.cluster_labels]
    assert labels[1] == [0, 0, 1, 1, 2, 2, 3, 3, 4, 4]
    assert labels[2] != labels[1]
    # the compacted rows, the ring, its pointer and the host counts
    ta, ja = teng.age, jeng.age
    assert ta.cluster_age.shape[0] == int(max(labels[-1])) + 1 < 10
    for name in ("cluster_age", "cluster_of", "upload_cost", "log_idx",
                 "log_mem", "log_ptr"):
        np.testing.assert_array_equal(getattr(ta, name).numpy(),
                                      np.asarray(getattr(ja, name)), name)
    assert ta.freq is None and ta.cost is None and ja.freq is None
    np.testing.assert_array_equal(teng.freq_matrix, jeng.freq_matrix)
    assert teng._log_seen == jeng._log_seen == ROUNDS
    np.testing.assert_allclose(teng.g_params.numpy(),
                               np.asarray(JC.flatten_tree(jeng.g_params)),
                               **TOL)


@pytest.mark.parametrize("layout", ["dense", "hierarchical", "compacted"])
def test_age_state_from_jax(layout, request):
    if jax is None:
        pytest.skip("needs the JAX reference")
    if layout == "dense":
        ja = JAge.create(50, 6)
    elif layout == "hierarchical":
        ja = JAge.create_hierarchical(50, 6, log_len=3, m_bound=4, k=2,
                                      with_cost=True)
    else:
        ja = request.getfixturevalue("ref_hier")[0].age
    host = [None if a is None else np.asarray(a) for a in ja]
    ta = age_state_from_jax(host, "cpu")
    assert isinstance(ta, DeviceAgeState)
    for name, a, t in zip(DeviceAgeState._fields, host, ta):
        assert (a is None) == (t is None), name
        if a is not None:
            assert t.dtype == torch.int32 and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), a)
    assert ta.device_bytes == JAge(*host).device_bytes


def test_recluster_from_reference_compacted_state(ref_hier, mnist_setup):
    """The port's compaction from the reference's compacted mid-run state
    (its ages, ring and host counts handed over) equals the reference's
    next recluster: labels and the new (C, d) rows."""
    jeng, _, _, _, params0, batches = ref_hier
    shards, test = mnist_setup
    teng = FederatedEngine("mlp", shards, test,
                           RAgeKConfig(**HP, age_layout="hierarchical"),
                           seed=3, device="cpu",
                           params=params_from_jax(params0, "cpu"))
    jeng._drain_freq_log()
    teng.age = age_state_from_jax(jeng.age, "cpu")
    teng._freq_host = np.array(jeng._freq_host)
    teng._log_seen = jeng._log_seen
    teng._recluster()
    want_ca, want_labels = j_recluster_host(
        np.array(jeng._freq_host), np.asarray(jeng.age.cluster_age),
        np.asarray(jeng.age.cluster_of), jeng.hp.eps, jeng.hp.min_pts,
        compact=True)
    np.testing.assert_array_equal(teng.cluster_of, want_labels)
    np.testing.assert_array_equal(teng.age.cluster_age.numpy(), want_ca)
    assert teng._num_seg == int(want_labels.max()) + 1
    teng.close()


@needs_jax
def test_cafe_hierarchical_round_matches_reference(mnist_setup):
    """One CAFe round under the hierarchical layout: the cost rows live in
    ``cost`` and ``upload_cost`` counts k a client, as in the reference."""
    shards, test = mnist_setup
    hp = dict(HP, method="cafe", age_layout="hierarchical")
    jeng = JEngine("mlp", shards, test, JCfg(**hp), seed=3,
                   compute="masked")
    bx, by, _ = jeng._store.draw(jeng._data, jeng.samp, hp["H"])
    params0 = jax.tree_util.tree_map(np.asarray, jeng.g_params)
    teng = FederatedEngine("mlp", shards, test, RAgeKConfig(**hp), seed=3,
                           device="cpu",
                           params=params_from_jax(params0, "cpu"))
    _fed(teng, [(torch.from_numpy(np.array(bx)),
                 torch.from_numpy(np.array(by)).long())])
    jm, tm = jeng.step(), teng.step()
    np.testing.assert_allclose(tm["losses"], jm["losses"], **TOL)
    np.testing.assert_array_equal(tm["idx"], jm["idx"])
    for name in ("cluster_age", "cost", "upload_cost"):
        np.testing.assert_array_equal(getattr(teng.age, name).numpy(),
                                      np.asarray(getattr(jeng.age, name)))
    assert int(teng.age.cost.sum()) > 0
    assert teng.age.upload_cost.tolist() == [HP["k"]] * 10
    assert teng.age.freq is None and teng.age.log_ptr is None
    np.testing.assert_array_equal(teng.freq_matrix, jeng.freq_matrix)
    jeng.close()
    teng.close()


# -- hierarchical == dense within the port --------------------------------

def _run(setup, layout, method="rage_k", driver="run", selection="segmented",
         **hp_kw):
    shards, test = setup
    eng = FederatedEngine("mlp", shards, test,
                          RAgeKConfig(**{**HP, "method": method,
                                         "age_layout": layout, **hp_kw}),
                          seed=3, device="cpu", selection=selection)
    res = getattr(eng, driver)(ROUNDS, eval_every=EVAL_EVERY,
                               heatmap_at=(ROUNDS,))
    out = dict(res=res, freq=eng.freq_matrix.copy(),
               labels=eng.cluster_of.copy(), age=eng.age,
               params=eng.g_params.clone(), rows=eng.age.cluster_age.shape[0])
    eng.close()
    return out


def _assert_layouts_agree(a, b):
    ra, rb = a["res"], b["res"]
    for key in ("rounds", "loss", "acc", "uplink_bytes", "n_active",
                "aoi_mean", "aoi_peak", "age_mean", "age_peak"):
        assert getattr(ra, key) == getattr(rb, key), key
    for x, y in zip(ra.requested, rb.requested, strict=True):
        assert (x is None and y is None) or np.array_equal(x, y)
    for x, y in zip(ra.cluster_labels, rb.cluster_labels, strict=True):
        np.testing.assert_array_equal(x, y)
    for t in ra.heatmaps:
        np.testing.assert_array_equal(ra.heatmaps[t], rb.heatmaps[t])
    np.testing.assert_array_equal(a["freq"], b["freq"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
    assert torch.equal(a["params"], b["params"])
    # the live rows of the dense ages are the hierarchical rows
    live = int(a["labels"].max()) + 1
    assert torch.equal(a["age"].cluster_age[:live],
                       b["age"].cluster_age[:live])


@pytest.mark.parametrize("driver", ["run", "run_scanned"])
@pytest.mark.parametrize("method", METHODS)
def test_hierarchical_equals_dense(mnist_setup, method, driver):
    dense = _run(mnist_setup, "dense", method, driver)
    hier = _run(mnist_setup, "hierarchical", method, driver)
    _assert_layouts_agree(dense, hier)
    if method == "rage_k":
        # C went 10 -> 5 -> 8: the rows shrank and grew with it
        counts = [int(c.max()) + 1 for c in hier["res"].cluster_labels]
        assert counts[1] == 5 and counts[-1] > counts[1]
        assert hier["rows"] == counts[-1] < dense["rows"] == 10
        assert int(hier["age"].log_ptr) == ROUNDS
    else:
        assert hier["rows"] == 10 and hier["age"].log_ptr is None
    per = 39_760 if method == "dense" else HP["k"]
    assert hier["age"].upload_cost.tolist() == [ROUNDS * per] * 10


def test_hierarchical_equals_dense_scan_selection(mnist_setup):
    for driver in ("run", "run_scanned"):
        _assert_layouts_agree(
            _run(mnist_setup, "dense", driver=driver, selection="scan"),
            _run(mnist_setup, "hierarchical", driver=driver,
                 selection="scan"))


@pytest.mark.parametrize("driver", ["run", "run_scanned"])
def test_silent_cluster_for_a_window(mnist_setup, driver):
    """Uniform m 2 of 10 over M 3 rounds: at least four clients, each its
    own cluster, are not heard in the first window; their rows and counts
    agree all the same (gathered compute, so the log's members are the
    compacted ids)."""
    kw = dict(schedule="uniform", participation_m=2)
    dense = _run(mnist_setup, "dense", driver=driver, **kw)
    hier = _run(mnist_setup, "hierarchical", driver=driver, **kw)
    _assert_layouts_agree(dense, hier)
    d = dense["freq"].shape[1]
    heard = np.stack([(np.asarray(r) != d).any(axis=1)
                      for r in hier["res"].requested])
    assert (~heard[:HP["M"]].any(axis=0)).sum() >= 4
    assert hier["age"].log_mem.shape == (HP["M"], 2)


@pytest.mark.parametrize("driver", ["run", "run_scanned"])
def test_empty_rounds_write_sentinel_slots(mnist_setup, driver):
    """A deadline below every client's latency: rounds with no participant
    (masked compute) write all-sentinel slots that fold to nothing."""
    kw = dict(schedule="deadline", deadline_s=1e-6)
    dense = _run(mnist_setup, "dense", driver=driver, **kw)
    hier = _run(mnist_setup, "hierarchical", driver=driver, **kw)
    _assert_layouts_agree(dense, hier)
    assert 0 in hier["res"].n_active
    empty = [t for t, m in enumerate(hier["res"].n_active) if m == 0]
    slot = empty[-1] % HP["M"]
    if empty[-1] >= ROUNDS - HP["M"]:          # not yet overwritten
        assert (hier["age"].log_mem[slot] == 10).all()
        assert (hier["age"].log_idx[slot] == 39_760).all()
